"""Estimator robustness beyond point substitutions (VERDICT r2 item 4).

Four realistic mutation classes stress the fragment-containment
estimator in the regime dereplication actually serves (incomplete,
contaminated, rearranged MAGs with indels):

- indels: a k-mer-window estimator counts every indel EVENT as a
  mismatch, where an aligner's gap-excluded ANI does not. The bias is
  exactly -p_indel * (k + mean_len - 1) / k: ~88% of it (the -p_indel
  part) is definitional and information-theoretically irreducible for
  ANY window/sketch method (a sub kills k windows, a short indel kills
  k+len-1 — indistinguishable for len << k), shared by Mash/sourmash/
  fastANI-class estimators; only the (k+len-1)/k ~ 1.13x excess is
  k-dependent, worth < 0.1 ANI points at realistic rates. The tests
  pin the measured bias TO the theory so silent drift is caught.
- rearrangements: canonical k-mers are strand-invariant, so inversions
  and translocations cost only breakpoint k-mers — the estimator is
  invariant where skani must re-chain (src/skani.rs:718-788).
- incompleteness (60-90% complete MAGs): ANI over retained sequence is
  unchanged; the aligned fraction follows the reference's
  either-direction-max semantics (src/fastani.rs:56-60) — the
  incomplete genome is fully contained in the complete one, so the
  pair passes any AF threshold below ~100%.
- contamination: foreign contigs dilute AF, never ANI; a contaminant
  source sharing only ~10% of bases is rejected by the default AF=15%.

The assertions below pin the characterization.
"""

import numpy as np
import pytest

from galah_tpu.api import ClusterParameters, pairwise_ani
from galah_tpu.utils.synth import (
    add_contamination,
    fragment_into_contigs,
    mutate,
    mutate_indels,
    random_genome,
    rearrange,
    subsample_contigs,
    write_fasta_contigs,
)

K = 15  # defaults.NATIVE_KMER_LENGTH
L = 300_000


def _est(tmp_path, a_contigs, b_contigs, **kw):
    pa, pb = str(tmp_path / "a.fna"), str(tmp_path / "b.fna")
    write_fasta_contigs(pa, a_contigs, "a")
    write_fasta_contigs(pb, b_contigs, "b")
    return pairwise_ani(pa, pb, ClusterParameters(**kw) if kw else None)


@pytest.mark.parametrize("ani", [0.95, 0.97, 0.99])
def test_indel_bias_matches_theory(tmp_path, ani):
    """Indels at 10% of the substitution count (realistic prokaryote
    ratio), geometric lengths mean 3 capped at 50. The estimator must
    sit at gap-excluded ANI minus p_ind*(k+mean_len-1)/k, within noise:
    any extra drift means a kernel regression, any less means the
    estimator silently changed definition."""
    rng = np.random.default_rng(int(ani * 10_000))
    base = random_genome(rng, L)
    mut, true_ani = mutate_indels(
        rng, base, ani, indel_events_per_sub=0.1, mean_indel_len=3.0
    )
    est = _est(tmp_path, [base], [mut])
    assert est is not None
    p_ind = 0.1 * (1.0 - ani)
    # effective mean length is slightly under 3.0 (geometric capped)
    predicted_bias = -p_ind * (K + 3.0 - 1.0) / K * 100.0
    err = est - true_ani
    assert abs(err - predicted_bias) < 0.2, (ani, est, err, predicted_bias)


def test_substitution_only_unbiased_still(tmp_path):
    """The indel characterization must not regress the clean case."""
    rng = np.random.default_rng(123)
    base = random_genome(rng, L)
    mut = mutate(rng, base, 0.97)
    est = _est(tmp_path, [base], [mut])
    assert abs(est - 97.0) < 0.15, est


def test_rearrangement_invariance(tmp_path):
    """Inversions + translocations (4 events, 5% segments) on top of
    97% ANI: canonical k-mers make the estimate invariant to within
    breakpoint noise."""
    rng = np.random.default_rng(42)
    base = random_genome(rng, L)
    mut = mutate(rng, base, 0.97)
    plain = _est(tmp_path, [base], [mut])
    moved = _est(tmp_path, [base], [rearrange(rng, mut, n_events=4)])
    assert abs(moved - plain) < 0.1, (plain, moved)


@pytest.mark.parametrize("completeness", [0.6, 0.75, 0.9])
def test_incomplete_mag(tmp_path, completeness):
    """A 60-90%-complete MAG against its complete source: ANI over the
    retained contigs is unchanged, and the pair passes ANY aligned
    fraction below ~full containment because the incomplete genome
    aligns ~fully INTO the complete one (either-direction max,
    reference src/fastani.rs:56-60)."""
    rng = np.random.default_rng(int(completeness * 100))
    base = random_genome(rng, L)
    mut = mutate(rng, base, 0.97)
    inc = subsample_contigs(
        rng, fragment_into_contigs(rng, mut, 50), completeness
    )
    kept = sum(len(c) for c in inc) / L
    assert kept < 0.97  # the subsample actually removed sequence
    est = _est(tmp_path, [base], inc, min_aligned_fraction=90.0)
    assert est is not None and abs(est - 97.0) < 0.35, (kept, est)


def test_two_incomplete_mags_af_rejection(tmp_path):
    """Two ~55%-complete MAGs of the same 97%-ANI organism: neither
    direction is contained, so min-aligned-fraction finally separates
    pairs — the regime it exists for (src/fastani.rs:55-65).

    Two measured behaviors of the fragment-count AF are pinned here
    (both shared with fastANI's mapped-fragment semantics):
    - fragments that only PARTIALLY overlap the other side's retained
      contigs still count as aligned while their identity stays >= the
      0.8 floor, so AF reads ~0.82 where base-level overlap is ~0.55
      (this pair flips between AF 80 and 85);
    - the same boundary-partial fragments shade the mean ANI ~1 point
      low at this deliberately heavy fragmentation (60 contigs x
      independent breakpoints)."""
    rng = np.random.default_rng(77)
    base = random_genome(rng, L)
    mut = mutate(rng, base, 0.97)
    a = subsample_contigs(rng, fragment_into_contigs(rng, base, 60), 0.55)
    b = subsample_contigs(rng, fragment_into_contigs(rng, mut, 60), 0.55)
    est = _est(tmp_path, a, b, min_aligned_fraction=70.0)
    assert est is not None and abs(est - 97.0) < 1.5, est
    est2 = _est(tmp_path, a, b, min_aligned_fraction=90.0)
    assert est2 is None, est2


def test_contamination(tmp_path):
    """10% foreign contigs: host-pair ANI moves < 0.3 points, and the
    contaminant's own source (sharing only those 10% of bases) is
    rejected by the default min-aligned-fraction."""
    rng = np.random.default_rng(9)
    base = random_genome(rng, L)
    mut = mutate(rng, base, 0.97)
    contam_src = random_genome(rng, L)
    cont = add_contamination(
        rng, fragment_into_contigs(rng, mut, 20), contam_src, 0.10
    )
    est = _est(tmp_path, [base], cont)
    assert est is not None and abs(est - 97.0) < 0.3, est
    assert _est(tmp_path, [contam_src], cont) is None
