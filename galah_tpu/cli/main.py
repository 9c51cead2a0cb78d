"""Top-level CLI dispatch: cluster / cluster-validate / analyse /
process (src/main.rs:14-134)."""

from __future__ import annotations

import argparse
import sys

from galah_tpu import __version__


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="galah-tpu",
        description="galah_tpu: accelerator-native metagenome assembled genome (MAG) "
        "dereplicator / clusterer",
    )
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="subcommand", metavar="SUBCOMMAND")

    from galah_tpu.cli.analyse_cmd import add_analyse_arguments
    from galah_tpu.cli.cluster_cmd import add_cluster_arguments
    from galah_tpu.cli.process_cmd import add_process_arguments
    from galah_tpu.cli.validate_cmd import add_validate_arguments

    cluster_p = sub.add_parser("cluster", help="Cluster (dereplicate) genomes")
    add_cluster_arguments(cluster_p)

    validate_p = sub.add_parser("cluster-validate", help="Verify clustering results")
    add_validate_arguments(validate_p)

    analyse_p = sub.add_parser(
        "analyse", help="Analyse rRNAs/tRNAs of FASTA files for MIMAG status"
    )
    add_analyse_arguments(analyse_p)

    process_p = sub.add_parser(
        "process", help="Analyse and cluster genomes in one run"
    )
    add_process_arguments(process_p)

    return parser


def main(argv=None) -> int:
    import os

    # Persistent XLA compilation cache (utils/platform.py): repeat runs
    # with the same shape buckets skip recompilation entirely.
    from galah_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.subcommand is None:
        parser.print_help()
        return 2

    try:
        if args.subcommand == "cluster":
            from galah_tpu.cli.cluster_cmd import run_cluster

            run_cluster(args)
        elif args.subcommand == "cluster-validate":
            from galah_tpu.cli.validate_cmd import run_validate

            run_validate(args)
        elif args.subcommand == "analyse":
            from galah_tpu.cli.analyse_cmd import run_analyse

            run_analyse(args)
        elif args.subcommand == "process":
            from galah_tpu.cli.process_cmd import run_process

            run_process(args)
        else:
            parser.print_help()
            return 2
    except (OSError, KeyError, ValueError, RuntimeError) as e:
        # Clean one-line errors for user-facing failures (missing files,
        # missing quality entries, backend errors); full traceback with
        # GALAH_TPU_DEBUG=1.
        if os.environ.get("GALAH_TPU_DEBUG"):
            raise
        msg = str(e.args[0] if e.args else e)
        # Some exceptions carry their own "Error: " prefix (matching the
        # reference's message style) — don't print it twice.
        if msg.startswith("Error: "):
            msg = msg[len("Error: "):]
        print(f"Error: {msg}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
