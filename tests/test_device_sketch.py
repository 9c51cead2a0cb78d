"""On-device sketching must be bit-identical to the host sketcher.

The device kernel (galah_tpu/ops/device_sketch.py) re-implements
canonical k-mer extraction, the splitmix64 finalizer (on uint32 lane
pairs), FracMinHash selection, bitmap construction and per-fragment
dedup. Every field of the resulting NativeSketch must match
sketch_sequences_native exactly — the screen/verify stages and all
cluster goldens depend on the sketches, so "close" is not enough.
"""

import numpy as np
import pytest

from galah_tpu.ops.device_sketch import (
    DeviceSketchOverflow,
    device_sketch_batch,
    mix64_pair,
)
from galah_tpu.sketch.fracminhash import (
    NativeSketchParams,
    mix64,
    sketch_sequences_native,
    small_genome_params,
)

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random_seq(rng, length, n_prob=0.0, lower_prob=0.0):
    seq = _BASES[rng.integers(0, 4, size=length)].copy()
    if n_prob:
        seq[rng.random(length) < n_prob] = ord("N")
    if lower_prob:
        lower = rng.random(length) < lower_prob
        seq[lower] += 32
    return seq.tobytes()


def _params_medium():
    # Shrunk widths keep the test fast while exercising every stage.
    return NativeSketchParams(
        genome_scale=50,
        fragment_scale=4,
        fragment_length=700,
        prefilter_bits=1 << 12,
        member_bits=1 << 14,
        min_fragment_hashes=4,
        min_fragment_length=100,
    )


def _assert_sketch_equal(dev, host):
    assert dev.total_len == host.total_len
    np.testing.assert_array_equal(dev.prefilter_buckets, host.prefilter_buckets)
    np.testing.assert_array_equal(dev.member_buckets, host.member_buckets)
    np.testing.assert_array_equal(dev.frag_offsets, host.frag_offsets)
    np.testing.assert_array_equal(dev.frag_buckets, host.frag_buckets)


def test_mix64_pair_matches_uint64_reference():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 30, size=4096, dtype=np.uint64)
    want = mix64(x)
    hi, lo = mix64_pair(
        np.zeros(x.shape, np.uint32), x.astype(np.uint32)
    )
    got = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo
    ).astype(np.uint64)
    np.testing.assert_array_equal(got, want)


def test_single_contig_parity():
    rng = np.random.default_rng(1)
    params = _params_medium()
    seqs = [_random_seq(rng, 5000)]
    host = sketch_sequences_native("g", seqs, params)
    (dev,) = device_sketch_batch(["g"], [seqs], params)
    assert host.n_fragments > 3 and host.frag_buckets.size > 50
    _assert_sketch_equal(dev, host)


@pytest.mark.parametrize("dedup", ["segmented", "sort"])
def test_ns_lowercase_and_multicontig_parity(monkeypatch, dedup):
    monkeypatch.setenv("GALAH_TPU_SKETCH_DEDUP", dedup)
    rng = np.random.default_rng(2)
    params = _params_medium()
    seqs = [
        _random_seq(rng, 3001, n_prob=0.01, lower_prob=0.3),
        _random_seq(rng, 1234),
        _random_seq(rng, 799, n_prob=0.05),
    ]
    host = sketch_sequences_native("g", seqs, params)
    (dev,) = device_sketch_batch(["g"], [seqs], params)
    _assert_sketch_equal(dev, host)


@pytest.mark.parametrize("dedup", ["segmented", "sort"])
def test_edge_contigs_parity(monkeypatch, dedup):
    """Short contigs: below k, below min_fragment_length, one-fragment
    remainder rules, and an empty contig."""
    monkeypatch.setenv("GALAH_TPU_SKETCH_DEDUP", dedup)
    rng = np.random.default_rng(3)
    params = _params_medium()
    cases = [
        [_random_seq(rng, 10)],                    # < k: no k-mers
        [_random_seq(rng, 60)],                    # < min_fragment_length
        [_random_seq(rng, 100)],                   # == min_fragment_length
        [_random_seq(rng, 1049)],                  # remainder 349 < L/2 dropped
        [_random_seq(rng, 1051)],                  # remainder 351 >= L/2 kept
        [b"", _random_seq(rng, 500)],              # empty first contig
        [_random_seq(rng, 500), _random_seq(rng, 20)],
    ]
    names = [f"g{i}" for i in range(len(cases))]
    hosts = [
        sketch_sequences_native(n, s, params) for n, s in zip(names, cases)
    ]
    devs = device_sketch_batch(names, cases, params)
    for d, h in zip(devs, hosts):
        _assert_sketch_equal(d, h)


def test_small_genome_params_parity():
    rng = np.random.default_rng(4)
    params = small_genome_params(fragment_length=1000)
    # Shrink bitmap widths for test speed, keeping the dense scales.
    import dataclasses

    params = dataclasses.replace(
        params, prefilter_bits=1 << 12, member_bits=1 << 14
    )
    seqs_a = [_random_seq(rng, 3000)]
    seqs_b = [_random_seq(rng, 5200, n_prob=0.002)]
    hosts = [
        sketch_sequences_native("a", seqs_a, params),
        sketch_sequences_native("b", seqs_b, params),
    ]
    devs = device_sketch_batch(["a", "b"], [seqs_a, seqs_b], params)
    for d, h in zip(devs, hosts):
        _assert_sketch_equal(d, h)


def test_two_key_sort_path_parity(monkeypatch):
    """Genomes with enough fragments that max_frags * member_bits
    overflows the combined 31-bit dedup sort key must take the two-key
    lax.sort fallback and still match the host sketcher exactly. A
    poly-A run floods one fragment past the segmented grid's row
    capacity, forcing the global-sort re-dispatch (mix64(0) == 0, so
    homopolymer-A k-mers are always selected)."""
    monkeypatch.setenv("GALAH_TPU_SKETCH_DEDUP", "segmented")
    rng = np.random.default_rng(61)
    params = NativeSketchParams(
        genome_scale=50,
        fragment_scale=4,
        fragment_length=700,
        prefilter_bits=1 << 12,
        member_bits=1 << 22,
        min_fragment_hashes=4,
        min_fragment_length=100,
    )
    body = bytearray(_random_seq(rng, 450_000, n_prob=0.001))
    body[100_000:101_000] = b"A" * 1000  # one flooded fragment
    seqs = [bytes(body)]
    host = sketch_sequences_native("g", seqs, params)
    assert host.n_fragments > 512  # 1024 * 2^22 > 2^31: two-key path
    (dev,) = device_sketch_batch(["g"], [seqs], params)
    _assert_sketch_equal(dev, host)


def test_segmented_overflow_redispatch_combined_key(monkeypatch):
    """Same flooded-fragment trigger at small widths: the re-dispatch
    lands on the combined-key global sort and stays bit-identical."""
    monkeypatch.setenv("GALAH_TPU_SKETCH_DEDUP", "segmented")
    rng = np.random.default_rng(62)
    params = _params_medium()  # frag_cap = 2*700/4 = 384 rounded
    body = bytearray(_random_seq(rng, 6000))
    body[1400:2100] = b"A" * 700  # entire fragment is one repeat
    seqs = [bytes(body)]
    host = sketch_sequences_native("g", seqs, params)
    (dev,) = device_sketch_batch(["g"], [seqs], params)
    _assert_sketch_equal(dev, host)


def test_batch_mixed_lengths_parity():
    rng = np.random.default_rng(5)
    params = _params_medium()
    lists = [
        [_random_seq(rng, ln, n_prob=0.005)]
        for ln in (350, 5000, 1200, 16000, 777)
    ]
    names = [f"g{i}" for i in range(len(lists))]
    hosts = [
        sketch_sequences_native(n, s, params) for n, s in zip(names, lists)
    ]
    devs = device_sketch_batch(names, lists, params)
    for d, h in zip(devs, hosts):
        _assert_sketch_equal(d, h)


def test_repeat_overflow_raises():
    """A pathological repeat genome (every copy of a selected k-mer is
    selected) overflows the stream capacity and must raise, not
    truncate silently."""
    params = NativeSketchParams(
        genome_scale=50,
        fragment_scale=8,
        fragment_length=700,
        prefilter_bits=1 << 12,
        member_bits=1 << 14,
        min_fragment_hashes=4,
        min_fragment_length=100,
    )
    # Homopolymer: every k-mer is A^k, whose canonical code is 0 and
    # mix64(0) == 0 < threshold — every one of ~4k positions is
    # selected while the binomial mean is ~n/8, far under capacity.
    seqs = [b"A" * 4096]
    with pytest.raises(DeviceSketchOverflow):
        device_sketch_batch(["g"], [seqs], params)


def test_device_sketch_files_matches_host(tmp_path, monkeypatch):
    """The engine's GALAH_TPU_DEVICE_SKETCH=1 path (device_sketch_files)
    must produce sketches identical to sketch_file_native on real
    multi-contig FASTA files, including the length-bucketed batching."""
    from galah_tpu.ops.device_sketch import device_sketch_files
    from galah_tpu.sketch.fracminhash import sketch_file_native

    rng = np.random.default_rng(8)
    params = _params_medium()
    paths = []
    for i, lens in enumerate([(4000, 900), (2100,), (15000, 50, 3000)]):
        p = tmp_path / f"g{i}.fna"
        with open(p, "w") as f:
            for j, ln in enumerate(lens):
                f.write(f">c{j}\n")
                f.write(_random_seq(rng, ln).decode() + "\n")
        paths.append(str(p))
    hosts = [sketch_file_native(p, params) for p in paths]
    devs = device_sketch_files(paths, params)
    for d, h in zip(devs, hosts):
        assert d.name == h.name
        _assert_sketch_equal(d, h)


def test_device_sketch_contig_files_matches_host(tmp_path):
    """The contig-mode device path (one sketch per contig, file order,
    tab-split names) must match sketch_contigs_native exactly."""
    from galah_tpu.ops.device_sketch import device_sketch_contig_files
    from galah_tpu.sketch.fracminhash import sketch_contigs_native

    rng = np.random.default_rng(9)
    params = small_genome_params(fragment_length=1000)
    import dataclasses

    params = dataclasses.replace(
        params, prefilter_bits=1 << 12, member_bits=1 << 14
    )
    paths = []
    for i, lens in enumerate([(3000, 900, 5100), (2100,)]):
        p = tmp_path / f"c{i}.fna"
        with open(p, "w") as f:
            for j, ln in enumerate(lens):
                f.write(f">f{i}_c{j}\textra tab comment\n")
                f.write(_random_seq(rng, ln, n_prob=0.002).decode() + "\n")
        paths.append(str(p))
    hosts = [sketch_contigs_native(p, params) for p in paths]
    devs = device_sketch_contig_files(paths, params)
    for hlist, dlist in zip(hosts, devs):
        assert len(hlist) == len(dlist)
        for d, h in zip(dlist, hlist):
            assert d.name == h.name
            _assert_sketch_equal(d, h)


def test_cli_contig_cluster_with_device_sketch(tmp_path, monkeypatch):
    """Contig-mode CLI golden under GALAH_TPU_DEVICE_SKETCH=1: the
    crafted 96/94-ANI contig fixtures must cluster exactly as the host
    path (reference golden, tests/test_cmdline.rs:496-545)."""
    from conftest import data

    from galah_tpu.cli.main import main

    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    out = tmp_path / "c.tsv"
    main([
        "cluster", "--cluster-contigs", "--small-contigs",
        "--genome-fasta-files", data("contigs/contigs_specific.fna"),
        "--output-cluster-definition", str(out),
    ])
    with open(out) as f:
        lines = f.read().splitlines()
    rep = "73.20110600_S2D.10_contig_13024"
    joined = {l.split("\t")[1] for l in lines if l.split("\t")[0] == rep}
    assert "96ANI_80refAF_80queryAF" in joined
    assert "94ANI_80refAF_80queryAF" not in joined
    assert any(l == "94ANI_80refAF_80queryAF\t94ANI_80refAF_80queryAF"
               for l in lines)


def test_cli_cluster_with_device_sketch(tmp_path, monkeypatch):
    """GALAH_TPU_DEVICE_SKETCH=1 end-to-end: same cluster golden as the
    host path (tests/test_cli_cluster.py) on the abisko4 fixtures."""
    from conftest import data

    from galah_tpu.cli.main import main

    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    genomes = [
        data("abisko4/73.20120800_S1D.21.fna"),
        data("abisko4/73.20110800_S2M.16.fna"),
    ]
    out = tmp_path / "clusters.tsv"
    main([
        "cluster", "--genome-fasta-files", *genomes,
        "--output-cluster-definition", str(out),
        "--checkm-tab-table", data("abisko4/abisko4.csv"),
    ])
    with open(out) as f:
        got = f.read()
    assert got == (
        f"{genomes[1]}\t{genomes[1]}\n"
        f"{genomes[1]}\t{genomes[0]}\n"
    )


def test_device_sketch_gz_and_tab_fixtures():
    """Device sketching inherits the reference's input traps: gzip
    files (tests/test_cmdline.rs:612-629) and tab-containing headers
    (abisko_tabs fixtures) must sketch identically to the host path."""
    from conftest import data

    from galah_tpu.ops.device_sketch import device_sketch_files
    from galah_tpu.sketch.fracminhash import sketch_file_native

    params = _params_medium()
    paths = [
        data("abisko4/73.20110800_S2M.16.fna.gz"),
        data("abisko_tabs/73.20120800_S1D.21.fna"),
    ]
    hosts = [sketch_file_native(p, params) for p in paths]
    devs = device_sketch_files(paths, params)
    for d, h in zip(devs, hosts):
        assert h.total_len > 100_000
        _assert_sketch_equal(d, h)


def test_device_arrays_match_host_derivation():
    """return_device arrays must be the packed forms of the sketch."""
    rng = np.random.default_rng(7)
    params = _params_medium()
    seqs = [_random_seq(rng, 4000), _random_seq(rng, 900)]
    (dev,), arrays = device_sketch_batch(
        ["g"], [seqs], params, return_device=True
    )
    host = sketch_sequences_native("g", seqs, params)
    np.testing.assert_array_equal(
        np.asarray(arrays["member_words"][0]), host.member_bitmap_words()
    )
    assert int(arrays["member_pop"][0]) == host.member_popcount
    assert int(arrays["n_pref"][0]) == host.n_prefilter
    from galah_tpu.ops.prefilter import pack_indicator

    np.testing.assert_array_equal(
        np.asarray(arrays["pref_words"][0]),
        pack_indicator(host.prefilter_buckets, params.prefilter_bits),
    )
    nu = int(arrays["n_unique"][0])
    np.testing.assert_array_equal(
        np.asarray(arrays["flat"][0][:nu]), host.frag_buckets
    )


@pytest.mark.parametrize("kernel", ["scatter", "routed"])
def test_kernel_formulations_bit_identical(monkeypatch, kernel):
    """Both kernel formulations (XLA scatter/sort vs scatter-free
    monotone routing + bitonic networks) must reproduce the host
    sketcher exactly on an adversarial battery: Ns, contig separators,
    sub-minimum contigs, homopolymer repeats (duplicate k-mers inside
    one fragment), and a wide-bitmap config that forces the routed
    kernel's two-key sort (max_frags * member_bits > 2^31)."""
    import dataclasses

    monkeypatch.setenv("GALAH_TPU_SKETCH_KERNEL", kernel)
    rng = np.random.default_rng(99)

    def run(name, seqs, params):
        got = device_sketch_batch([name], [seqs], params)[0]
        want = sketch_sequences_native(name, seqs, params)
        for f in (
            "prefilter_buckets", "frag_buckets", "frag_offsets",
            "member_buckets",
        ):
            assert np.array_equal(
                np.asarray(getattr(got, f), np.int64),
                np.asarray(getattr(want, f), np.int64),
            ), (name, f, kernel)

    params = NativeSketchParams()
    battery = {
        "ns": [
            b"ACGT" * 3000 + b"N" * 500 + bytes(
                rng.choice(list(b"ACGT"), size=9000).tolist()
            ),
        ],
        "multi": [
            bytes(rng.choice(list(b"ACGTN"), size=ln).tolist())
            for ln in (7003, 50, 12000, 1)
        ],
        # short enough that the duplicated poly-A k-mer stays inside
        # the SEL capacity (a 20kb run overflows BY DESIGN -> host
        # fallback, covered by test_repeat_overflow_raises)
        "homopolymer": [b"A" * 2000, bytes(
            rng.choice(list(b"ACGT"), size=6500).tolist()
        )],
    }
    for name, seqs in battery.items():
        run(name, seqs, params)

    # Two-key dedup sort: wide member bitmap overflows the combined
    # 31-bit key at a small fragment count.
    wide = dataclasses.replace(params, member_bits=1 << 28)
    run("twokey", [
        bytes(rng.choice(list(b"ACGT"), size=100_000).tolist())
    ], wide)


def test_use_device_sketch_gate(monkeypatch):
    """Env forces win; accelerators default ON (the device-resident
    pipeline makes device sketching the minimum-bytes path on any
    link); the CPU backend never defaults to device sketching."""
    from galah_tpu.engines import native as native_mod

    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "1")
    assert native_mod._use_device_sketch() is True
    monkeypatch.setenv("GALAH_TPU_DEVICE_SKETCH", "0")
    assert native_mod._use_device_sketch() is False
    monkeypatch.delenv("GALAH_TPU_DEVICE_SKETCH")
    assert native_mod._use_device_sketch() is False  # cpu backend


def test_sort_scan_formulation_bit_identical(monkeypatch):
    """The fori_loop sort formulation (GALAH_TPU_SKETCH_SORT=scan,
    kept as an option, off by default) must
    produce sketches bit-identical to the
    unrolled network (the compile-time fix must not change results)."""
    from galah_tpu.ops.device_sketch import device_sketch_batch

    rng = np.random.default_rng(77)
    params = _params_medium()
    names = ["a", "b"]
    seqs = [
        [_random_seq(rng, 9000), _random_seq(rng, 2500)],
        [_random_seq(rng, 30000)],
    ]
    monkeypatch.setenv("GALAH_TPU_SKETCH_SORT", "unrolled")
    base = device_sketch_batch(names, seqs, params)
    monkeypatch.setenv("GALAH_TPU_SKETCH_SORT", "scan")
    scan = device_sketch_batch(names, seqs, params)
    for b, s in zip(base, scan):
        _assert_sketch_equal(b, s)


def _genome_files(tmp_path, rng, n, length, step=0):
    paths = []
    for i in range(n):
        p = tmp_path / f"g{i}.fna"
        with open(p, "w") as f:
            f.write(">c0\n" + _random_seq(rng, length + step * i).decode() + "\n")
        paths.append(str(p))
    return paths


def _contig_files(tmp_path, rng):
    paths = []
    for i in range(3):
        p = tmp_path / f"f{i}.fna"
        with open(p, "w") as f:
            for j in range(6):
                f.write(f">c{i}_{j}\n")
                f.write(_random_seq(rng, 2000 + 37 * j).decode() + "\n")
        paths.append(str(p))
    return paths


def test_device_sketch_files_chunked_matches_host(tmp_path):
    """Many small chunks (reader prefetch ahead of the device loop)
    must equal host sketching for every genome, in input order."""
    import galah_tpu.ops.device_sketch as ds
    from galah_tpu.sketch.fracminhash import sketch_file_native

    params = _params_medium()
    paths = _genome_files(tmp_path, np.random.default_rng(31), 12, 6000, 13)
    got = ds.device_sketch_files(paths, params, max_batch_bytes=1 << 14)
    for g, p in zip(got, paths):
        h = sketch_file_native(p, params)
        assert g.name == h.name
        _assert_sketch_equal(g, h)


def test_every_chunk_runs_on_device(tmp_path, monkeypatch):
    """Every chunk goes through the device kernel (device-born products
    keep the screen and verify caches resident)."""
    import galah_tpu.ops.device_sketch as ds

    params = _params_medium()
    paths = _genome_files(tmp_path, np.random.default_rng(33), 8, 4000)
    calls = []
    orig = ds.device_sketch_batch

    def counting(*a, **k):
        calls.append(len(a[0]))
        return orig(*a, **k)

    monkeypatch.setattr(ds, "device_sketch_batch", counting)
    got = ds.device_sketch_files(paths, params, max_batch_bytes=1 << 13)
    assert sum(calls) == len(paths) and len(calls) > 1, calls
    assert all(g is not None for g in got)


def test_contig_files_chunked_matches_host(tmp_path):
    import galah_tpu.ops.device_sketch as ds
    from galah_tpu.sketch.fracminhash import sketch_contigs_native

    params = _params_medium()
    paths = _contig_files(tmp_path, np.random.default_rng(41))
    got = ds.device_sketch_contig_files(paths, params, max_batch_bytes=1 << 13)
    for p, sks in zip(paths, got):
        hosts = sketch_contigs_native(p, params)
        assert [s.name for s in sks] == [h.name for h in hosts]
        for d, h in zip(sks, hosts):
            _assert_sketch_equal(d, h)


@pytest.mark.parametrize("mode", ["genomes", "contigs"])
def test_device_sketch_error_propagates(tmp_path, monkeypatch, mode):
    """A failing device batch raises from the caller's thread; nothing
    finishes the corpus on the host behind its back."""
    import galah_tpu.ops.device_sketch as ds

    params = _params_medium()
    rng = np.random.default_rng(43)
    calls = []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device batch failed")
        return ds_orig(*a, **k)

    ds_orig = ds.device_sketch_batch
    monkeypatch.setattr(ds, "device_sketch_batch", failing)
    with pytest.raises(RuntimeError, match="device batch failed"):
        if mode == "genomes":
            ds.device_sketch_files(
                _genome_files(tmp_path, rng, 6, 4000), params,
                max_batch_bytes=1 << 13,
            )
        else:
            ds.device_sketch_contig_files(
                _contig_files(tmp_path, rng), params, max_batch_bytes=1 << 12,
            )
    assert len(calls) == 2


@pytest.mark.parametrize("params_fn", ["medium", "small"])
def test_lists_transport_parity(monkeypatch, params_fn):
    """The narrow lists transport (device words->bucket-list
    compaction + 2/3-byte entries, one uint8 buffer per chunk) must
    produce sketches bit-identical to the words transport."""
    monkeypatch.setenv("GALAH_TPU_SKETCH_KERNEL", "scatter")
    rng = np.random.default_rng(11)
    params = _params_medium() if params_fn == "medium" else small_genome_params()
    lists = [
        [_random_seq(rng, ln, n_prob=0.01)]
        for ln in (350, 5000, 1200, 16000, 777, 64)
    ]
    names = [f"g{i}" for i in range(len(lists))]

    monkeypatch.setenv("GALAH_TPU_SKETCH_TRANSPORT", "words")
    base = device_sketch_batch(names, lists, params)
    monkeypatch.setenv("GALAH_TPU_SKETCH_TRANSPORT", "lists")
    via_lists = device_sketch_batch(names, lists, params)
    for a, b in zip(via_lists, base):
        _assert_sketch_equal(a, b)


def test_lazy_host_copies_parity(monkeypatch):
    """Lazy host copies defer the product fetch until content access;
    materialized arrays must be bit-identical to eager mode, lengths
    and popcounts must be available without materializing."""
    from galah_tpu.ops import device_sketch as D

    monkeypatch.setenv("GALAH_TPU_SKETCH_KERNEL", "scatter")
    rng = np.random.default_rng(13)
    params = _params_medium()
    lists = [[_random_seq(rng, ln, n_prob=0.01)] for ln in (350, 5000, 777)]
    names = [f"g{i}" for i in range(len(lists))]

    monkeypatch.setenv("GALAH_TPU_SKETCH_HOST_COPIES", "eager")
    eager = device_sketch_batch(names, lists, params)
    monkeypatch.setenv("GALAH_TPU_SKETCH_HOST_COPIES", "lazy")
    lazy = device_sketch_batch(names, lists, params)

    for lz, eg in zip(lazy, eager):
        assert isinstance(lz.frag_buckets, D.LazyBuckets)
        # lengths are free (no materialization yet)
        assert lz.frag_buckets._arr is None
        assert len(lz.frag_buckets) == len(eg.frag_buckets)
        assert lz.member_popcount == eg.member_popcount
        assert lz.n_prefilter == eg.n_prefilter
    for lz, eg in zip(lazy, eager):
        _assert_sketch_equal(lz, eg)  # materializes via __array__

    # pickling materializes to plain arrays
    import pickle

    rt = pickle.loads(pickle.dumps(lazy[0].member_buckets))
    np.testing.assert_array_equal(rt, np.asarray(eager[0].member_buckets))


def test_lazy_pin_budget_materializes_oldest(monkeypatch):
    """Past the pin budget the oldest pending chunk materializes and
    releases; results stay correct."""
    from galah_tpu.ops import device_sketch as D

    monkeypatch.setenv("GALAH_TPU_SKETCH_KERNEL", "scatter")
    monkeypatch.setenv("GALAH_TPU_SKETCH_HOST_COPIES", "lazy")
    monkeypatch.setattr(D, "_lazy_pin_budget", lambda: 1)  # every chunk over
    rng = np.random.default_rng(17)
    params = _params_medium()
    lists = [[_random_seq(rng, 900)] for _ in range(4)]
    names = [f"g{i}" for i in range(4)]
    a = device_sketch_batch(names[:2], lists[:2], params)
    b = device_sketch_batch(names[2:], lists[2:], params)
    # the first batch's chunk was force-materialized by the second
    assert a[0].frag_buckets._arr is not None or a[0].frag_buckets._chunk._per is not None
    monkeypatch.setenv("GALAH_TPU_SKETCH_HOST_COPIES", "eager")
    ae = device_sketch_batch(names[:2], lists[:2], params)
    for lz, eg in zip(a, ae):
        _assert_sketch_equal(lz, eg)


def test_lazy_chunks_release_device_buffers_with_their_sketches(monkeypatch):
    """A pending lazy chunk is held only by its sketches: once they are
    gone, its device products are freed, so a finished run leaves
    nothing pinned on the device."""
    import gc

    import jax

    from galah_tpu.ops import device_sketch as D

    monkeypatch.setenv("GALAH_TPU_SKETCH_KERNEL", "scatter")
    monkeypatch.setenv("GALAH_TPU_SKETCH_HOST_COPIES", "lazy")
    rng = np.random.default_rng(19)
    params = _params_medium()
    lists = [[_random_seq(rng, 900)] for _ in range(3)]
    gc.collect()
    before = {id(a) for a in jax.live_arrays()}
    sketches = device_sketch_batch(
        [f"g{i}" for i in range(3)], lists, params
    )
    assert len(D._LAZY_PENDING) == 1
    assert sketches[0].frag_buckets._arr is None  # still pinned
    del sketches
    gc.collect()
    assert len(D._LAZY_PENDING) == 0
    assert {id(a) for a in jax.live_arrays()} <= before
