"""End-to-end dereplication benchmark harness.

Generates a synthetic genome corpus with known family structure, runs
the full cluster pipeline, validates family recovery, and prints one
JSON line of wall-clock + per-phase throughput. The reference publishes
no numbers (BASELINE.md), so these harness runs are the framework's own
baseline table.

Usage:
  python benchmarks/scale_bench.py --genomes 256 --families 32 \
      --length 500000 [--ani 95]

It runs on whatever backend JAX picks (JAX_PLATFORMS=cpu for a
host-only run).
"""


from __future__ import annotations

import os
import sys

# Make the repo importable when run as `python benchmarks/<name>.py`.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import argparse
import json
import os
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genomes", type=int, default=256)
    ap.add_argument("--families", type=int, default=32)
    ap.add_argument("--length", type=int, default=500_000)
    ap.add_argument("--within-ani", type=float, default=0.98)
    ap.add_argument("--ani", type=float, default=95.0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--keep-dir", default=None,
                    help="reuse/keep the generated corpus here")
    args = ap.parse_args()

    from galah_tpu.cli.main import main as cli_main
    from galah_tpu.utils.synth import make_families

    members = args.genomes // args.families
    corpus = args.keep_dir or tempfile.mkdtemp(prefix="galah-tpu-bench-")
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(corpus, "fam0_m0.fna")):
        make_families(
            corpus,
            n_families=args.families,
            members_per_family=members,
            genome_length=args.length,
            within_ani=args.within_ani,
            seed=11,
        )
    gen_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as td:
        clusters_tsv = os.path.join(td, "clusters.tsv")
        metrics_json = os.path.join(td, "metrics.json")
        t0 = time.perf_counter()
        rc = cli_main([
            "cluster", "-d", corpus, "-x", "fna",
            "--ani", str(args.ani),
            "-t", str(args.threads),
            "--output-cluster-definition", clusters_tsv,
            "--metrics-json", metrics_json,
        ])
        wall = time.perf_counter() - t0
        if rc != 0:
            print(json.dumps({"error": f"cluster exited {rc}"}))
            return 1

        reps = {}
        with open(clusters_tsv) as f:
            for line in f:
                rep, member = line.rstrip("\n").split("\t")
                reps[member] = rep
        fams = {}
        for m, r in reps.items():
            fam = os.path.basename(m).split("_")[0]
            fams.setdefault(fam, set()).add(r)
        correct = (
            len(set(reps.values())) == args.families
            and all(len(r) == 1 for r in fams.values())
        )
        with open(metrics_json) as f:
            metrics = json.load(f)

    n = args.genomes
    print(
        json.dumps(
            {
                "genomes": n,
                "genome_length": args.length,
                "total_pairs": n * (n - 1) // 2,
                "families_recovered_exactly": correct,
                "generate_s": round(gen_s, 2),
                "wall_clock_s": round(wall, 2),
                "phases_s": {k: round(v, 2) for k, v in metrics["phases_s"].items()},
                "counters": {
                    k: round(v, 2) for k, v in metrics["counters"].items()
                },
            }
        )
    )
    return 0 if correct else 2


if __name__ == "__main__":
    sys.exit(main())
