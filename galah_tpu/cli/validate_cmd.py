"""The `cluster-validate` subcommand (src/cluster_validation.rs).

Audits a cluster-definition file with an independent ANI method:
rep<->member ANI must be >= the threshold, rep<->rep ANI must be below
it. Failures are logged as errors, not fatal — it's an audit tool.

The reference hardcodes fastANI as the validator; here the validator
backend is selectable, defaulting to the native engine so no
external tool is needed.
"""

from __future__ import annotations

import argparse
import logging
from typing import List

from galah_tpu.cli.common import add_verbosity_flags, parse_percentage, set_log_level

logger = logging.getLogger(__name__)


def add_validate_arguments(sub: argparse.ArgumentParser) -> None:
    add_verbosity_flags(sub)
    sub.add_argument("--cluster-file", required=True,
                     help="Output of 'cluster' subcommand")
    sub.add_argument("--ani", type=float, default=99.0,
                     help="ANI to validate against [default: 99]")
    sub.add_argument("--min-aligned-fraction", type=float, default=50.0,
                     help="Min aligned fraction of two genomes for clustering [default: 50]")
    sub.add_argument("--fraglen", type=int, default=3000,
                     help="Fragment length for ANI calculation [default: 3000]")
    sub.add_argument("--cluster-method", default="native",
                     choices=["native", "fastani"],
                     help="ANI method used for validation [default: native]")
    sub.add_argument("-t", "--threads", type=int, default=1)


def read_clustering_file(path: str) -> List[List[str]]:
    """A new cluster starts when col0 == col1
    (src/cluster_validation.rs:80-113)."""
    clusters: List[List[str]] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) != 2:
                raise SystemExit(
                    f"Malformed cluster file line (expected 2 columns): {line}"
                )
            rep, member = parts
            if rep == member:
                clusters.append([rep])
            else:
                if not clusters or clusters[-1][0] != rep:
                    raise SystemExit(
                        f"Cluster file member line with unknown representative: {line}"
                    )
                clusters[-1].append(member)
    return clusters


def run_validate(args: argparse.Namespace) -> int:
    set_log_level(args)
    ani_frac = parse_percentage(args.ani, "ani")
    min_af = parse_percentage(args.min_aligned_fraction, "min-aligned-fraction")
    ani_pct = ani_frac * 100.0

    clusters = read_clustering_file(args.cluster_file)
    logger.info("Read in %d clusters", len(clusters))

    if args.cluster_method == "fastani":
        from galah_tpu.engines.subprocess_backends import FastaniClusterer

        engine = FastaniClusterer(ani_pct, min_af, args.fraglen)
        engine.initialise()
    else:
        from galah_tpu.engines.native import NativeClusterer, NativeContext

        ctx = NativeContext(threads=args.threads, fragment_length=args.fraglen)
        engine = NativeClusterer(
            ani_pct, min_af, ctx, af_fail_result=None
        )

    errors = 0
    # Within-cluster: rep<->member must be >= threshold
    for cluster in clusters:
        rep = cluster[0]
        pairs = [(rep, member) for member in cluster[1:]]
        anis = engine.calculate_ani_batch(pairs)
        for (rep_, member), ani in zip(pairs, anis):
            if ani is not None and ani >= ani_pct:
                logger.debug("ANI between %s and %s is ok: %s", rep_, member, ani)
            elif ani is None:
                logger.error(
                    "ANI between %s and %s is not ok: comparison was too divergent",
                    rep_, member,
                )
                errors += 1
            else:
                logger.error("ANI between %s and %s is not ok: %s", rep_, member, ani)
                errors += 1

    # Between representatives: must be < threshold
    reps = [c[0] for c in clusters]
    rep_pairs = [
        (reps[i], reps[j]) for i in range(len(reps)) for j in range(i + 1, len(reps))
    ]
    anis = engine.calculate_ani_batch(rep_pairs)
    for (r1, r2), ani in zip(rep_pairs, anis):
        if ani is None or ani < ani_pct:
            logger.debug("ANI between reps %s and %s is ok", r1, r2)
        else:
            logger.error("ANI between reps %s and %s is not ok: %s", r1, r2, ani)
            errors += 1

    if errors:
        logger.error("Validation found %d problems", errors)
    else:
        logger.info("Validation found no problems")
    return errors
