"""bench.py's per-kernel drift guard.

The guard exists so a deviation on any headline kernel prints a loud
DRIFT stderr line instead of sailing into a recorded result. Mirrors the reference's regression-test discipline
(reference tests/test_cmdline.rs) applied to perf numbers.
"""

import importlib.util
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_module():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_check_drift_flags_both_directions():
    bench = _bench_module()
    lines = []
    table = {
        "_measured": "2026-08-20",
        "fast_kernel": {"expect": 100.0},
        "slow_kernel": {"expect": 100.0},
        "ok_kernel": {"expect": 100.0},
        "wide_tolerance": {"expect": 100.0, "factor": 3.0},
        "not_measured": {"expect": 5.0},
    }
    measured = {
        "fast_kernel": 200.0,   # 2x up -> drift
        "slow_kernel": 29.0,    # 3.4x down -> drift (the round-3 case)
        "ok_kernel": 120.0,     # within 1.5x
        "wide_tolerance": 250.0,  # 2.5x but factor 3 -> ok
        "unlisted": 1.0,        # no table entry -> ignored
    }
    drifted = bench.check_drift(measured, table, log=lines.append)
    assert sorted(drifted) == ["fast_kernel", "slow_kernel"]
    assert sum("DRIFT:" in ln for ln in lines) == 2
    joined = "\n".join(lines)
    assert "slow_kernel" in joined and "0.29x" in joined


def test_expected_rates_table_parses_and_covers_kernels():
    with open(os.path.join(REPO, "benchmarks", "expected_rates.json")) as f:
        devices = json.load(f)["devices"]
    assert devices
    for table in devices.values():
        names = {k for k in table if not k.startswith("_")}
        # The headline + every stderr kernel bench must be guarded.
        for required in (
            "screen_production",
            "screen_matmul_int8",
            "verify_grouped",
            "verify_pairtable",
            "device_sketch",
        ):
            assert required in names, required
        for spec in (table[n] for n in names):
            assert float(spec["expect"]) > 0


def test_kernel_slowdown_trips_e2e_device_estimate():
    """VERDICT r4 #3: a deliberate 2x kernel slowdown must trip the
    band-immune e2e guard. The device estimate prices the run's work
    counters at the run's kernel rates, so halving a kernel rate
    doubles its phase estimate and check_drift flags it at 1.5x."""
    bench = _bench_module()
    counters = {
        "screen_pairs_computed": 1.3e9,
        "verify_directed_pairtable": 6.0e5,
        "sketch_bases": 1.28e8,
    }
    healthy = {
        "screen_production": 1.27e9,
        "verify_pairtable": 1.05e5,
        "device_sketch": 2.2e8,
    }
    est = sum(bench.e2e_device_estimate(counters, healthy).values())
    slow = dict(healthy, verify_pairtable=healthy["verify_pairtable"] / 2)
    est_slow = sum(bench.e2e_device_estimate(counters, slow).values())
    assert est_slow > est * 1.25  # verify dominates this shape
    table = {"e2e_device_estimate_s": {"expect": est}}
    lines = []
    drifted = bench.check_drift(
        {"e2e_device_estimate_s": est_slow}, table, log=lines.append
    )
    assert drifted == ["e2e_device_estimate_s"]
    # Band noise does NOT trip it: same counters, same rates, any wall.
    assert bench.check_drift(
        {"e2e_device_estimate_s": est}, table, log=lines.append
    ) == []


def test_pipeline_glue_regression_trips_counter_guard():
    """Deterministic pipeline-shape counters guard glue regressions
    (lost adoption, a broken tile scheduler doubling dispatches) that
    the 5x wall guard cannot see through band noise."""
    bench = _bench_module()
    table = {
        "e2e_screen_dispatch_rpcs": {"expect": 12.0},
        "e2e_screen_pairs_computed": {"expect": 1.3e9},
    }
    lines = []
    drifted = bench.check_drift(
        {
            "e2e_screen_dispatch_rpcs": 24.0,  # 2x dispatches
            "e2e_screen_pairs_computed": 1.3e9,
        },
        table, log=lines.append,
    )
    assert drifted == ["e2e_screen_dispatch_rpcs"]


def test_drift_clean_when_within_tolerance():
    bench = _bench_module()
    lines = []
    table = {"k": {"expect": 100.0}}
    assert bench.check_drift({"k": 100.0}, table, log=lines.append) == []
    assert not lines
