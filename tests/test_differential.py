"""Randomized differential campaign: one corpus, every execution
strategy, byte-identical clusters.

The reference runs one code path per backend choice; this engine has
several device strategies for the same math (indicator / packed-matmul
screens, sharded and row-sharded mesh sweeps, grouped /
pair-table verify kernels, low-memory streaming). Any indexing, caching,
sharding, or numerics bug that is specific to one strategy shows up here
as a cluster diff against the default path — the same invariance the
reference pins per-backend with its cluster goldens
(tests/test_cmdline.rs:305-384)."""

import os

import pytest

from conftest import data  # noqa: F401  (imports force the CPU backend)
from galah_tpu.api import ClusterParameters, cluster_genomes
from galah_tpu.utils.synth import make_families


def _clusters(paths, **params):
    res = cluster_genomes(paths, ClusterParameters(threads=2, **params))
    return sorted(sorted(c) for c in res.clusters)


# Each case: (name, env overrides, ClusterParameters overrides)
CONFIGS = [
    ("screen-indicator", {"GALAH_TPU_SCREEN": "indicator"}, {}),
    ("screen-packed-1dev", {"GALAH_TPU_SCREEN": "packed"}, {}),
    ("rowsharded-mesh", {"GALAH_TPU_ROWSHARD": "1"}, {}),
    ("verify-pairtable", {"GALAH_TPU_VERIFY": "pairtable"}, {}),
    ("verify-grouped", {"GALAH_TPU_VERIFY": "grouped"}, {}),
    ("verify-1dev", {"GALAH_TPU_VERIFY": "grouped",
                     "GALAH_TPU_VERIFY_DEVICES": "1"}, {}),
    ("low-memory", {}, {"low_memory": True}),
    ("finch-precluster", {}, {"precluster_method": "finch"}),
    ("device-sketch", {"GALAH_TPU_DEVICE_SKETCH": "1"}, {}),
    ("screen-int8", {"GALAH_TPU_SCREEN_DTYPE": "int8"}, {}),
    ("screen-bf16", {"GALAH_TPU_SCREEN_DTYPE": "bf16"}, {}),
    ("verify-bt", {"GALAH_TPU_VERIFY": "grouped",
                   "GALAH_TPU_VERIFY_GATHER": "bt"}, {}),
    ("verify-word", {"GALAH_TPU_VERIFY": "grouped",
                     "GALAH_TPU_VERIFY_GATHER": "word"}, {}),
    ("sketch-dedup-segmented", {"GALAH_TPU_DEVICE_SKETCH": "1",
                                "GALAH_TPU_SKETCH_DEDUP": "segmented"}, {}),
]


@pytest.mark.parametrize("seed", [3, 11])
def test_all_strategies_agree(tmp_path, monkeypatch, seed):
    paths, family_ids = make_families(
        str(tmp_path), n_families=4, members_per_family=3,
        genome_length=40_000, within_ani=0.97, seed=seed,
    )
    want = sorted(
        sorted(i for i, f in enumerate(family_ids) if f == fam)
        for fam in range(4)
    )
    for var in ("GALAH_TPU_SCREEN", "GALAH_TPU_VERIFY",
                "GALAH_TPU_ROWSHARD", "GALAH_TPU_DEVICE_SKETCH",
                "GALAH_TPU_SCREEN_DTYPE", "GALAH_TPU_VERIFY_GATHER",
                "GALAH_TPU_SKETCH_DEDUP"):
        monkeypatch.delenv(var, raising=False)
    # The default path (8-device sharded tile sweep under the virtual
    # mesh) must recover the planted families exactly...
    assert _clusters(paths) == want, "default strategy missed ground truth"
    # ...and every other strategy must produce the identical clustering.
    for name, env, params in CONFIGS:
        for var, val in env.items():
            monkeypatch.setenv(var, val)
        try:
            assert _clusters(paths, **params) == want, f"strategy {name} diverged"
        finally:
            for var in env:
                monkeypatch.delenv(var, raising=False)


@pytest.mark.skipif(
    not os.environ.get("GALAH_TPU_SCALE_TESTS"),
    reason="set GALAH_TPU_SCALE_TESTS=1 (runs several 512-genome sweeps)",
)
def test_screen_strategies_agree_at_scale(tmp_path, monkeypatch):
    """Same invariant at a size where the sharded sweep spans many
    tiles and the row-sharded sweep runs multiple stages — the regime
    where partition/offset bugs live (the round-2 zero-slot clobber was
    only visible here)."""
    paths, family_ids = make_families(
        str(tmp_path), n_families=128, members_per_family=4,
        genome_length=20_000, within_ani=0.96, seed=2,
    )
    want = sorted(
        sorted(i for i, f in enumerate(family_ids) if f == fam)
        for fam in range(128)
    )
    for var in ("GALAH_TPU_SCREEN", "GALAH_TPU_ROWSHARD"):
        monkeypatch.delenv(var, raising=False)
    assert _clusters(paths) == want
    for name, env in [
        ("rowsharded", {"GALAH_TPU_ROWSHARD": "1"}),
        ("packed-1dev", {"GALAH_TPU_SCREEN": "packed"}),
        ("indicator", {"GALAH_TPU_SCREEN": "indicator"}),
    ]:
        for var, val in env.items():
            monkeypatch.setenv(var, val)
        try:
            assert _clusters(paths) == want, f"strategy {name} diverged"
        finally:
            for var in env:
                monkeypatch.delenv(var, raising=False)
