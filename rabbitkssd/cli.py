"""Command-line interface: the nine RabbitKSSD subcommands.

Flag surface mirrors the reference main.cpp:30-259 (shuffle,
sketch, alldist, dist, union, sub, convert, merge, info) with identical
option names, defaults, and artifact side effects (``.sketch`` suffix
handling, lazy ``.index``/``.dict`` regeneration, sketch-file input
short-circuits).  ``-t/--threads`` is accepted everywhere for
compatibility; device parallelism is managed by the runtime.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

from .utils.timers import phase


def _eprint(*a):
    print(*a, file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="rabbitkssd",
        description="Kssd-based genome sketching and distance estimation "
                    "on a GPU",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("shuffle", help="generate the shuffle file for sketching usage")
    p.add_argument("-k", "--halfk", type=int, required=True)
    p.add_argument("-s", "--subk", type=int, default=6)
    p.add_argument("-l", "--reduction", type=int, required=True)
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("sketch", help="compute sketches for the input genome list")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-L", dest="shuf_file", default="shuf_file/L3K10.shuf")
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-n", "--leastNumKmer", type=int, default=1)
    p.add_argument("-Q", "--leastQuality", type=int, default=0)
    p.add_argument("-q", "--query", action="store_true")

    p = sub.add_parser("alldist", help="compute all-vs-all distances for one input dataset")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-D", "--maxDist", type=float, default=1.0)
    p.add_argument("-L", dest="shuf_file", default="shuf_file/L3K10.shuf")
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-M", "--metric", type=int, default=0)
    p.add_argument("-n", "--leastNumKmer", type=int, default=1)
    p.add_argument("-Q", "--leastQuality", type=int, default=0)

    p = sub.add_parser("dist", help="compute distances between reference and query datasets")
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-q", "--query", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-N", "--neighborN_max", type=int, default=None)
    p.add_argument("-D", "--maxDist", type=float, default=1.0)
    p.add_argument("-L", dest="shuf_file", default="shuf_file/L3K10.shuf")
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-M", "--metric", type=int, default=0)
    p.add_argument("-n", "--leastNumKmer", type=int, default=1)
    p.add_argument("-Q", "--leastQuality", type=int, default=0)

    p = sub.add_parser("union", help="compute the set union from multiple sketches")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-t", "--threads", type=int, default=0)

    p = sub.add_parser("sub", help="subtract the reference sketch from the query sketches")
    p.add_argument("--rs", required=True)
    p.add_argument("--qs", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-t", "--threads", type=int, default=0)

    p = sub.add_parser("convert", help="convert sketches between Kssd and RabbitKSSD formats")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-q", "--query", action="store_true")
    p.add_argument("--reverse", action="store_true")

    p = sub.add_parser("merge", help="merge multiple sketch files into one")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-t", "--threads", type=int, default=0)

    p = sub.add_parser("info", help="get the information of the sketch file")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-F", "--Fined", action="store_true")

    return ap


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _load_or_sketch(list_or_sketch: str, shuf_file: str, is_query: bool,
                    least_qual: int, least_num_kmer: int,
                    build_index_if_missing: bool, threads: int = 0):
    """Sketch-or-load with the reference's artifact side effects
    (subCommand.cpp:161-193, 221-296)."""
    from .formats import is_sketch_file, read_sketches, write_index
    from .engine.sketcher import sketch_file_list
    from .formats import save_sketches
    from .shuffle import read_shuffle_file

    if is_sketch_file(list_or_sketch):
        with phase(f"read sketches from {list_or_sketch}"):
            sk = read_sketches(list_or_sketch)
        sketch_out = list_or_sketch
        if build_index_if_missing:
            idx, dic = sketch_out + ".index", sketch_out + ".dict"
            if not (os.path.exists(idx) and os.path.exists(dic)):
                with phase("transSketches"):
                    write_index(sk, dic, idx)
        return sk, sketch_out
    shuf = read_shuffle_file(shuf_file)
    with phase("computing sketches and save sketches into file"):
        sk = sketch_file_list(list_or_sketch, shuf, least_qual=least_qual,
                              least_num_kmer=least_num_kmer,
                              threads=max(0, threads))
        sketch_out = list_or_sketch + ".sketch"
        save_sketches(sk, sketch_out)
    if build_index_if_missing:
        with phase("transSketches"):
            write_index(sk, sketch_out + ".dict", sketch_out + ".index")
    return sk, sketch_out


# --------------------------------------------------------------------------
# subcommand mains
# --------------------------------------------------------------------------

def cmd_shuffle(args) -> int:
    from .shuffle import generate_shuffle, write_shuffle_file

    _eprint(f"-----generate the shuffle file: {args.output}")
    shuf = generate_shuffle(args.halfk, args.subk, args.reduction)
    write_shuffle_file(shuf, args.output)
    return 0


def cmd_sketch(args) -> int:
    from .formats import is_sketch_file, read_sketches, write_index
    from .engine.sketcher import sketch_file_list
    from .formats import save_sketches
    from .shuffle import read_shuffle_file

    _eprint("-----run the subcommand: sketch")
    if is_sketch_file(args.input):
        # sketch-file input short-circuit (main.cpp:189-215)
        _eprint(
            f"input is a sketch file, rename the sketch file from: "
            f"{args.input} to: {args.output}"
        )
        if not args.query:
            sk = read_sketches(args.input)
            shutil.copy(args.input, args.output)
            write_index(sk, args.output + ".dict", args.output + ".index")
        else:
            shutil.move(args.input, args.output)
        return 0
    _eprint(f"---read the shuffle file: {args.shuf_file}")
    shuf = read_shuffle_file(args.shuf_file)
    with phase("computing sketches and save sketches into file"):
        sk = sketch_file_list(args.input, shuf, least_qual=args.leastQuality,
                              least_num_kmer=args.leastNumKmer,
                              threads=max(0, args.threads))
        out = args.output if args.output.endswith(".sketch") else args.output + ".sketch"
        save_sketches(sk, out)
    _eprint(f"save the sketches into: {out}")
    if not args.query:
        with phase("transSketches"):
            write_index(sk, out + ".dict", out + ".index")
    return 0


def cmd_alldist(args) -> int:
    from .engine.dist_engine import run_alldist

    _eprint("-----run the subcommand: alldist")
    if args.maxDist < 0.0:
        _eprint("ERROR: alldist, maxDist must be > 0")
        return 1
    sk, sketch_out = _load_or_sketch(args.input, args.shuf_file, False,
                                     args.leastQuality, args.leastNumKmer,
                                     build_index_if_missing=True,
                                     threads=args.threads)
    if os.environ.get("KSSD_LEGACY_DIST") == "1" and not args.metric:
        # the reference's legacy sorted-intersection path (tri_dist,
        # dist.cpp:345-427) — unreachable from its CLI too
        # (subCommand.cpp:197 commented); jaccard/mash only
        from .engine.dist_engine import run_alldist_legacy

        with phase("tri_dist distance computing"):
            run_alldist_legacy(sk, args.output, max_dist=args.maxDist)
        return 0
    with phase("index_tridist distance computing"):
        run_alldist(sk, args.output, max_dist=args.maxDist,
                    containment=bool(args.metric), index_path=sketch_out)
    return 0


def cmd_dist(args) -> int:
    from .engine.dist_engine import run_dist

    _eprint("-----run the subcommand: dist")
    if args.maxDist < 0.0:
        _eprint("ERROR: dist, maxDist must be > 0")
        return 1
    ref, ref_out = _load_or_sketch(args.reference, args.shuf_file, False,
                                   args.leastQuality, args.leastNumKmer,
                                   build_index_if_missing=True,
                                   threads=args.threads)
    query, _ = _load_or_sketch(args.query, args.shuf_file, True,
                               args.leastQuality, args.leastNumKmer,
                               build_index_if_missing=False,
                               threads=args.threads)
    if ref.info.id != query.info.id:
        _eprint(
            "ERROR: dist, the sketch infos between reference and query "
            "files are not match\n"
            "try to use the same shuffle file to generate sketches of the "
            "reference and query datasets"
        )
        return 1
    if (os.environ.get("KSSD_LEGACY_DIST") == "1" and not args.metric
            and not args.neighborN_max):
        from .engine.dist_engine import run_dist_legacy

        with phase("dist distance computing"):
            run_dist_legacy(ref, query, args.output, max_dist=args.maxDist)
        return 0
    with phase("index_dist distance computing"):
        run_dist(ref, query, args.output, max_dist=args.maxDist,
                 containment=bool(args.metric),
                 max_neighbor=args.neighborN_max or 0,
                 ref_index_path=ref_out)
    return 0


def cmd_union(args) -> int:
    from .engine.setops import union_sketch_file

    _eprint("-----run the subcommand: union")
    union_sketch_file(args.input, args.output)
    return 0


def cmd_sub(args) -> int:
    from .engine.setops import sub_sketch_files

    _eprint("-----run the subcommand: sub")
    sub_sketch_files(args.rs, args.qs, args.output)
    return 0


def cmd_convert(args) -> int:
    from .engine.setops import convert_kssd_to_sketch, convert_sketch_to_kssd
    from .formats import is_sketch_file

    _eprint("-----run the subcommand: convert")
    if args.reverse:
        if not is_sketch_file(args.input):
            _eprint(
                f"ERROR: convert, need input RabbitKSSD sketch file: {args.input}"
            )
            return 1
        convert_sketch_to_kssd(args.input, args.output)
    else:
        convert_kssd_to_sketch(args.input, args.output,
                               build_index=not args.query)
    return 0


def cmd_merge(args) -> int:
    from .engine.setops import merge_sketch_files
    from .formats import is_sketch_file
    from .seqio import read_list

    _eprint("-----run the subcommand: merge")
    files = read_list(args.input)
    for f in files:
        if not is_sketch_file(f):
            _eprint(
                f"ERROR: merge, the file: {f} is not a sketch file in the "
                f"list file: {args.input}"
            )
            return 1
    merge_sketch_files(files, args.output)
    return 0


def cmd_info(args) -> int:
    from .engine.setops import write_info

    _eprint("-----run the subcommand: info")
    write_info(args.input, args.Fined, args.output)
    return 0


_DISPATCH = {
    "shuffle": cmd_shuffle,
    "sketch": cmd_sketch,
    "alldist": cmd_alldist,
    "dist": cmd_dist,
    "union": cmd_union,
    "sub": cmd_sub,
    "convert": cmd_convert,
    "merge": cmd_merge,
    "info": cmd_info,
}


def main(argv: list[str] | None = None) -> int:
    # multi-host runtime: no-op unless JAX_COORDINATOR_ADDRESS is set
    # (pod-scale config 5; every host runs the same CLI invocation)
    from .parallel.multihost import init_multihost

    init_multihost()
    args = build_parser().parse_args(argv)
    return _DISPATCH[args.cmd](args)


def _cli() -> None:
    """Console entry point."""
    sys.exit(main())


if __name__ == "__main__":
    _cli()
