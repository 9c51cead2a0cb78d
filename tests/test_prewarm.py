"""tools/prewarm must compile the PRODUCTION programs.

A cache entry only helps if its key matches what production lowers: a
wrapper lambda with baked-in constants compiles a structurally
different module that production never hits (the round-5 review
caught exactly that). These tests pin (a) that prewarm lowers the
same jitted callables with the same geometry (block/cap/alloc/dtype/
group and operand shapes) a real IncrementalPackedScreen dispatch
uses, and (b) that the tool runs end to end.
"""

import numpy as np
import pytest


def test_prewarm_screen_matches_production_dispatch(monkeypatch):
    import jax.numpy as jnp

    import galah_tpu.ops.prefilter as pf
    import galah_tpu.tools.prewarm as pw
    import jax

    n, bits = 300, 4096
    monkeypatch.setenv("GALAH_TPU_SCREEN_TILE_GROUP", "3")
    # CPU's default block (1024) would make this a one-tile corpus
    # with no grouped dispatch; both production and prewarm read the
    # same override, so geometry still must match end to end.
    monkeypatch.setenv("GALAH_TPU_SCREEN_BLOCK", "128")

    # Capture the avals of a real production grouped dispatch.
    prod: dict = {}
    orig = pf._resident_screen_extract_group

    def spy(x, s, desc, **kw):
        prod.setdefault("calls", []).append(
            ((x.shape, x.dtype), (s.shape, s.dtype),
             (desc.shape, desc.dtype), dict(kw))
        )
        return orig(x, s, desc, **kw)

    monkeypatch.setattr(pf, "_resident_screen_extract_group", spy)
    rng = np.random.default_rng(0)
    ind = (rng.random((n, bits)) < 0.1).astype(np.uint8)
    packed = [
        np.packbits(r.astype(bool), bitorder="little").view(np.uint32)
        for r in ind
    ]
    block = pf._screen_block_for(n)
    pf.screen_triangle_packed(
        packed, ind.sum(axis=1), k=15, min_containment=0.3, bits=bits
    )
    monkeypatch.setattr(pf, "_resident_screen_extract_group", orig)
    assert prod["calls"], "production sweep made no grouped dispatch"
    (xa, sa, da, kw) = prod["calls"][0]

    # Capture what prewarm lowers for the same corpus geometry.
    lowered: dict = {}
    real_lower = pf._resident_screen_extract_group.lower

    def lower_spy(x, s, desc, **lkw):
        lowered.setdefault("calls", []).append(
            ((x.shape, x.dtype), (s.shape, s.dtype),
             (desc.shape, desc.dtype), dict(lkw))
        )
        return real_lower(x, s, desc, **lkw)

    monkeypatch.setattr(
        pf._resident_screen_extract_group, "lower", lower_spy,
        raising=False,
    )
    pw.prewarm_screen(jax, jnp, n, bits)
    assert lowered["calls"], "prewarm lowered no grouped program"
    matches = [
        c for c in lowered["calls"]
        if c[0] == xa and c[1] == sa and c[2] == da
        and c[3]["block"] == kw["block"] and c[3]["cap"] == kw["cap"]
        and c[3]["dtname"] == kw["dtname"]
        and c[3]["is_diag"] == kw["is_diag"]
    ]
    assert matches, (
        f"prewarm geometry {lowered['calls']} does not cover the "
        f"production dispatch {(xa, sa, da, kw)}"
    )


def test_prewarm_main_runs(monkeypatch, capsys):
    import sys

    import galah_tpu.tools.prewarm as pw

    monkeypatch.setattr(
        sys, "argv", ["prewarm", "--n", "64", "--bits", "4096"]
    )
    assert pw.main() == 0
