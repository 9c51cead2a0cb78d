"""100k-contig end-to-end benchmark (north-star contig config).

BASELINE config #3 shape: one multi-contig FASTA of ~5kb contigs in
planted families, clustered with --cluster-contigs --small-contigs.
Validates exact family recovery and prints one JSON line with wall +
per-phase split + the deterministic work counters (bench.py's e2e
guard rationale). The corpus is cached on disk and reused across
runs so A/B comparisons (e.g. GALAH_TPU_PIPELINE=0 vs 1) are
corpus-identical when run back-to-back. It runs on whatever backend
JAX picks (JAX_PLATFORMS=cpu for a host-only run).

Usage:
  python benchmarks/contig_e2e.py --contigs 100000 --families 20000 \
      [--corpus /tmp/galah_contigs_100k.fna]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--contigs", type=int, default=100_000)
    ap.add_argument("--families", type=int, default=20_000)
    ap.add_argument("--length", type=int, default=5_000)
    ap.add_argument("--within-ani", type=float, default=0.98)
    ap.add_argument("--ani", type=float, default=95.0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--corpus", default=None,
                    help="corpus FASTA path (generated if absent, reused if present)")
    ap.add_argument("--sweep-checkpoint", default=None,
                    help="pass through to the CLI (mid-sweep tile log)")
    ap.add_argument("--sketch-directory", default=None,
                    help="pass through to the CLI (persistent sketch cache)")
    args = ap.parse_args()


    from galah_tpu.cli.main import main as cli_main
    from galah_tpu.utils.synth import make_contig_corpus

    members = args.contigs // args.families
    corpus = args.corpus or os.path.join(
        tempfile.gettempdir(),
        f"galah_contigs_{args.contigs}x{args.length}_f{args.families}.fna",
    )
    meta = corpus + ".families.json"
    if os.path.exists(corpus) and os.path.exists(meta):
        with open(meta) as f:
            saved = json.load(f)
        names, fam_ids = saved["names"], saved["family_ids"]
        print(f"corpus reused: {corpus}", file=sys.stderr)
    else:
        t0 = time.perf_counter()
        names, fam_ids = make_contig_corpus(
            corpus, n_families=args.families, members_per_family=members,
            contig_length=args.length, within_ani=args.within_ani, seed=0,
        )
        with open(meta, "w") as f:
            json.dump({"names": names, "family_ids": fam_ids}, f)
        print(
            f"corpus generated in {time.perf_counter() - t0:.0f}s: {corpus}",
            file=sys.stderr,
        )

    td = tempfile.mkdtemp(prefix="galah-contig-e2e-")
    clusters_tsv = os.path.join(td, "clusters.tsv")
    metrics_json = os.path.join(td, "metrics.json")
    t0 = time.perf_counter()
    cli_args = [
        "cluster", "--cluster-contigs", "--small-contigs",
        "-f", corpus, "--ani", str(args.ani),
        "--threads", str(args.threads),
        "--output-cluster-definition", clusters_tsv,
        "--metrics-json", metrics_json, "-q",
    ]
    if args.sweep_checkpoint:
        cli_args += ["--sweep-checkpoint", args.sweep_checkpoint]
    if args.sketch_directory:
        cli_args += ["--sketch-directory", args.sketch_directory]
    rc = cli_main(cli_args)
    wall = time.perf_counter() - t0
    if rc != 0:
        print(f"cluster exited {rc}", file=sys.stderr)
        return rc

    # Family recovery: every family resolves to exactly one rep and
    # reps are distinct across families.
    fam_of = dict(zip(names, fam_ids))
    reps_by_fam: dict = {}
    n_rows = 0
    with open(clusters_tsv) as f:
        for line in f:
            rep, member = line.rstrip("\n").split("\t")
            reps_by_fam.setdefault(fam_of[member], set()).add(rep)
            n_rows += 1
    exact = (
        n_rows == len(names)
        and len(reps_by_fam) == args.families
        and all(len(r) == 1 for r in reps_by_fam.values())
        and len(set().union(*reps_by_fam.values())) == args.families
    )

    with open(metrics_json) as f:
        mj = json.load(f)
    phases = {k: round(v, 1) for k, v in mj.get("phases_s", {}).items()}
    counters = {
        k: mj["counters"][k]
        for k in (
            "screen_dispatch_rpcs", "screen_pairs_computed",
            "verify_directed_pairtable", "verify_directed_grouped",
            "screen_rows_at_first_dispatch",
        )
        if k in mj.get("counters", {})
    }
    out_copy = os.environ.get("GALAH_CONTIG_E2E_KEEP_TSV")
    if out_copy:
        import shutil

        shutil.copy(clusters_tsv, out_copy)
    print(json.dumps({
        "metric": "contig_e2e_wall_s",
        "value": round(wall, 1),
        "unit": "s",
        "contigs": args.contigs,
        "families": args.families,
        "exact_recovery": exact,
        "phases_s": phases,
        "counters": counters,
        "pipeline": os.environ.get("GALAH_TPU_PIPELINE", "default"),
    }))
    return 0 if exact else 1


if __name__ == "__main__":
    raise SystemExit(main())
