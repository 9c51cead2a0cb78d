"""Parity tests: the C++ fastaio extension must be bit-identical to the
numpy reference paths."""

import numpy as np
import pytest
from conftest import data

from galah_tpu import native_ext

@pytest.fixture(autouse=True)
def _require_native():
    # Decided per test, not at import: the library builds at first use.
    if not native_ext.available():
        pytest.skip("native fastaio library could not be built")


def test_murmur3_parity():
    from galah_tpu.sketch.murmur3 import murmur3_x64_128

    lib = native_ext.get_lib()
    rng = np.random.default_rng(0)
    for length in (5, 8, 16, 21, 32, 45):
        key = rng.integers(0, 256, size=length, dtype=np.uint8)
        expected = int(murmur3_x64_128(key[None, :])[0])
        got = lib.gt_murmur3_x64_128_low(key.tobytes(), length, 0)
        assert got == expected


def test_fasta_parse_parity():
    from galah_tpu.io.fasta import read_fasta

    path = data("abisko4/73.20110800_S2M.16.fna.gz")
    py = list(read_fasta(path))
    f = native_ext.NativeFasta(path)
    assert f.num_records() == len(py)
    for i in (0, len(py) - 1):
        assert f.name(i) == py[i].name
        assert f.seq(i) == py[i].seq


def test_genome_stats_parity():
    f = native_ext.NativeFasta(data("abisko4/73.20110600_S2D.10.fna"))
    assert f.genome_stats() == (161, 6506, 8289)


def test_mash_hash_parity():
    from galah_tpu.io.fasta import read_fasta_sequences
    from galah_tpu.sketch.minhash import sketch_sequences

    path = data("set1/500kb.fna")
    numpy_sketch = sketch_sequences(read_fasta_sequences(path))
    f = native_ext.NativeFasta(path)
    native_hashes = f.mash_hashes(21, 1000)
    assert np.array_equal(native_hashes, numpy_sketch.hashes)


def test_native_sketch_parity():
    from galah_tpu.io.fasta import read_fasta
    from galah_tpu.sketch.fracminhash import (
        NativeSketchParams,
        sketch_sequences_native,
        small_genome_params,
    )

    for path, params in [
        (data("set1/500kb.fna"), NativeSketchParams()),
        (data("abisko4/73.20110600_S2D.10.fna"), NativeSketchParams()),
        (data("contigs/contigs.fna"), small_genome_params()),
    ]:
        seqs = [r.seq for r in read_fasta(path)]
        ref = sketch_sequences_native(path, seqs, params)
        f = native_ext.NativeFasta(path)
        raw = f.native_sketch(0, params)[0]
        assert raw["total_len"] == ref.total_len
        assert np.array_equal(raw["prefilter_buckets"], ref.prefilter_buckets)
        assert np.array_equal(raw["member_buckets"], ref.member_buckets)
        assert np.array_equal(raw["frag_buckets"], ref.frag_buckets)
        assert np.array_equal(raw["frag_offsets"], ref.frag_offsets)


def test_native_sketch_block_boundary_parity(tmp_path):
    """The C++ scan loop stages k-mers through 8192-position blocks;
    sequence lengths and N placements straddling block edges must stay
    bit-identical to the (blockless) numpy reference."""
    from galah_tpu.sketch.fracminhash import (
        NativeSketchParams,
        sketch_sequences_native,
    )

    rng = np.random.default_rng(77)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    params = NativeSketchParams(
        genome_scale=20, fragment_scale=2, fragment_length=700,
        prefilter_bits=1 << 12, member_bits=1 << 14,
        min_fragment_length=100,
    )
    for length, n_at in [
        (8191, None), (8192, None), (8193, None),
        (8192 + 14, 8192 - 7),      # N spanning the first block edge
        (3 * 8192 + 5, 2 * 8192),   # N exactly on a later edge
        (16384, 8192 + 3),
    ]:
        seq = bases[rng.integers(0, 4, size=length)].copy()
        if n_at is not None:
            seq[n_at] = ord("N")
        seqs = [seq.tobytes()]
        p = tmp_path / f"b{length}_{n_at}.fna"
        with open(p, "wb") as f:
            f.write(b">c\n" + seqs[0] + b"\n")
        ref = sketch_sequences_native(str(p), seqs, params)
        raw = native_ext.NativeFasta(str(p)).native_sketch(0, params)[0]
        assert raw["total_len"] == ref.total_len
        assert np.array_equal(raw["member_buckets"], ref.member_buckets)
        assert np.array_equal(raw["prefilter_buckets"], ref.prefilter_buckets)
        assert np.array_equal(raw["frag_buckets"], ref.frag_buckets)
        assert np.array_equal(raw["frag_offsets"], ref.frag_offsets)


def test_native_sketch_contig_mode_parity():
    from galah_tpu.io.fasta import read_fasta
    from galah_tpu.sketch.fracminhash import (
        sketch_sequences_native,
        small_genome_params,
    )

    path = data("contigs/contigs_specific.fna")
    params = small_genome_params()
    f = native_ext.NativeFasta(path)
    raws = f.native_sketch(1, params)
    recs = list(read_fasta(path))
    assert len(raws) == len(recs)
    for rec, raw in zip(recs, raws):
        ref = sketch_sequences_native(rec.contig_name, [rec.seq], params)
        assert np.array_equal(raw["member_buckets"], ref.member_buckets)
        assert np.array_equal(raw["frag_buckets"], ref.frag_buckets)
        assert np.array_equal(raw["frag_offsets"], ref.frag_offsets)


def test_native_sketch_contig_mode_threaded_determinism():
    """Contig sketching across host threads must be bit-identical to
    the serial order (each contig's sketch lands at a fixed index)."""
    from galah_tpu.sketch.fracminhash import small_genome_params

    path = data("contigs/contigs.fna")
    params = small_genome_params()
    serial = native_ext.NativeFasta(path).native_sketch(1, params, threads=1)
    threaded = native_ext.NativeFasta(path).native_sketch(1, params, threads=4)
    assert len(serial) == len(threaded) and len(serial) > 1
    for a, b in zip(serial, threaded):
        assert a["total_len"] == b["total_len"]
        for key in (
            "prefilter_buckets", "member_buckets", "frag_buckets",
            "frag_offsets",
        ):
            assert np.array_equal(a[key], b[key]), key


def test_gz_buffer_parser_matches_streaming(tmp_path):
    """The libdeflate fast path parses records from one decompressed
    buffer; the same content read plain goes through the streaming
    zlib parser. Both must agree on awkward shapes: CRLF, empty lines,
    tab headers, a record with no sequence, no trailing newline."""
    import gzip

    content = (
        b">c1\tdescription with tabs\r\n"
        b"ACGT\r\nACG\r\n"
        b"\r\n"
        b">empty_record\n"
        b">c2\n"
        b"acgtn\n"
        b"ACGTACGT"  # no trailing newline
    )
    plain = tmp_path / "x.fna"
    plain.write_bytes(content)
    gz = tmp_path / "x.fna.gz"
    gz.write_bytes(gzip.compress(content))
    fp = native_ext.NativeFasta(str(plain))
    fg = native_ext.NativeFasta(str(gz))
    assert fp.num_records() == fg.num_records() == 3
    for i in range(3):
        assert fp.name(i) == fg.name(i)
        assert fp.seq(i) == fg.seq(i)
    assert fp.seq(0) == b"ACGTACG"
    assert fp.seq(1) == b""
    assert fp.seq(2) == b"acgtnACGTACGT"


def test_corrupt_gzip_errors(tmp_path):
    """A truncated gzip stream must raise, not silently truncate (both
    native and numpy paths)."""
    import gzip

    good = gzip.compress(b">c1\n" + b"ACGT" * 5000 + b"\n")
    bad = tmp_path / "corrupt.fna.gz"
    bad.write_bytes(good[: len(good) // 2])
    with pytest.raises(Exception):
        f = native_ext.NativeFasta(str(bad))
        f.genome_stats()


def test_native_sketch_dedup_bin_sort_parity(tmp_path):
    """The C++ per-fragment dedup uses an MSB bin scatter + insertion
    sort (std::sort below 64 entries / above 1024-entry bins). Pin
    bit-identity against the numpy reference across the regimes that
    pick different paths: long random fragments (bin path), tiny
    fragments (std::sort path), duplicate-dense homopolymer repeats
    (equal values flooding one bin), and a skewed repeat that pushes
    one bin past the fallback threshold."""
    from galah_tpu.sketch.fracminhash import (
        NativeSketchParams,
        sketch_sequences_native,
    )

    rng = np.random.default_rng(123)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    def check(seq_bytes, params, name):
        p = tmp_path / f"{name}.fna"
        with open(p, "wb") as f:
            f.write(b">c\n" + seq_bytes + b"\n")
        ref = sketch_sequences_native(str(p), [seq_bytes], params)
        raw = native_ext.NativeFasta(str(p)).native_sketch(0, params)[0]
        assert np.array_equal(raw["frag_buckets"], ref.frag_buckets), name
        assert np.array_equal(raw["frag_offsets"], ref.frag_offsets), name
        assert np.array_equal(raw["member_buckets"], ref.member_buckets), name

    # bin path: dense selection -> ~1500-entry runs
    dense = NativeSketchParams(
        genome_scale=50, fragment_scale=2, fragment_length=3000,
        prefilter_bits=1 << 12, member_bits=1 << 14,
        min_fragment_length=100,
    )
    check(bases[rng.integers(0, 4, size=60_000)].tobytes(), dense, "dense")

    # std::sort path: sparse selection -> <64-entry runs
    sparse = NativeSketchParams(
        genome_scale=200, fragment_scale=64, fragment_length=3000,
        prefilter_bits=1 << 12, member_bits=1 << 14,
        min_fragment_length=100,
    )
    check(bases[rng.integers(0, 4, size=60_000)].tobytes(), sparse, "sparse")

    # duplicate-dense: 21bp unit repeated -> the same few k-mers
    # (hence identical bucket values) fill every fragment
    unit = bases[rng.integers(0, 4, size=21)]
    rep = np.tile(unit, 3000)[:60_000].tobytes()
    check(rep, dense, "repeat")

    # one-bin flood past the 1024 fallback: single fragment, dense
    # selection, tiny member space so every value lands in few bins
    flood = NativeSketchParams(
        genome_scale=50, fragment_scale=1, fragment_length=30_000,
        prefilter_bits=1 << 12, member_bits=1 << 4,
        min_fragment_length=100,
    )
    check(bases[rng.integers(0, 4, size=30_000)].tobytes(), flood, "flood")
