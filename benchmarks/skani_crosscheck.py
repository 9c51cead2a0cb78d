"""Per-pair cross-check of the native estimator against a real skani
binary (reference src/skani.rs:109-225 triangle contract).

Runs `skani triangle --sparse --min-af <af>` on the given genomes,
computes the same pairs with the native two-stage engine, and prints a
markdown delta table (ANI and max-direction AF per pair). Gated on the
binary being installed (see BASELINE.md's estimate footnote).

Usage: python benchmarks/skani_crosscheck.py GENOME.fna [GENOME.fna ...]
       (defaults to the reference abisko4 MAGs when run with no args)
"""

import os
import sys

# Make the repo importable when run as `python benchmarks/<name>.py`.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import csv
import glob
import shutil
import subprocess
import sys
import tempfile


def run_skani(genomes, min_af=0.15):
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write("\n".join(genomes) + "\n")
        listfile = f.name
    proc = subprocess.run(
        [
            "skani", "triangle", "--sparse", "-t", "4",
            "--min-af", str(min_af * 100.0), "-l", listfile,
        ],
        capture_output=True, text=True, check=True,
    )
    out = {}
    reader = csv.reader(proc.stdout.splitlines(), delimiter="\t")
    next(reader, None)
    for row in reader:
        if not row:
            continue
        key = tuple(sorted((row[0], row[1])))
        out[key] = (
            float(row[2]), max(float(row[3]), float(row[4])) / 100.0
        )
    return out


def run_native(genomes, min_af=0.15, threshold=85.0):
    from galah_tpu.engines.native import NativeContext

    ctx = NativeContext(threads=4)
    sketches = ctx.sketch_many(genomes)
    keys = [ctx.key_for(s) for s in sketches]
    sk_by = dict(zip(keys, sketches))
    key_pairs = [
        (keys[i], keys[j])
        for i in range(len(genomes))
        for j in range(i + 1, len(genomes))
    ]
    res = ctx.frag_engine.bidirectional(key_pairs, sk_by)
    out = {}
    idx = {k: g for k, g in zip(keys, genomes)}
    for (ka, kb), (ani, af_f, af_r) in res.items():
        key = tuple(sorted((idx[ka], idx[kb])))
        out[key] = (ani, max(af_f, af_r))
    return out


def main(argv):
    if shutil.which("skani") is None:
        print("skani not found on PATH; nothing to cross-check", file=sys.stderr)
        return 2
    genomes = argv or sorted(
        glob.glob("/root/reference/tests/data/abisko4/*.fna")
    )
    skani = run_skani(genomes)
    native = run_native(genomes)
    print("| pair | skani ANI | native ANI | dANI | skani AF | native AF | dAF |")
    print("|---|---|---|---|---|---|---|")
    worst_ani = worst_af = 0.0
    for key in sorted(skani):
        s_ani, s_af = skani[key]
        n_ani, n_af = native.get(key, (0.0, 0.0))
        d_ani, d_af = n_ani - s_ani, n_af - s_af
        worst_ani = max(worst_ani, abs(d_ani))
        worst_af = max(worst_af, abs(d_af))
        a, b = key
        print(
            f"| {a.split('/')[-1]} vs {b.split('/')[-1]} | {s_ani:.3f} | "
            f"{n_ani:.3f} | {d_ani:+.3f} | {s_af:.3f} | {n_af:.3f} | {d_af:+.3f} |"
        )
    print(f"\nworst |dANI| = {worst_ani:.3f}, worst |dAF| = {worst_af:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
