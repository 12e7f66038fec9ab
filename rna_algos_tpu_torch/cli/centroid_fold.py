"""CLI: gamma-centroid structure prediction
(``rna_algos_tpu.cli.centroid_fold``).

Same flags and output bytes as the JAX CLI, plus ``--device``: ``-o`` is a
directory that receives one ``centroid_threshold={gamma}.fa`` per gamma
(default the 2^-7..2^10 grid).  BPPs are computed once per sequence; the
MEA fill runs for all gammas of a sequence at once.
"""

import argparse
import os
import sys

from ..utils.io import read_fasta

from ..models.centroid import (DEFAULT_GAMMAS, centroid_structures,
                               write_gamma_files)
from ..parallel.runner import FoldEngine
from .common import add_port_flags, numerics_of


def build_parser():
    p = argparse.ArgumentParser(
        prog="centroid_fold", description="gamma-centroid folding (CUDA)"
    )
    p.add_argument("-i", required=True, help="input FASTA file path")
    p.add_argument("-o", required=True, help="output directory path")
    p.add_argument("-t", type=int, default=None, help="worker hint (compat)")
    p.add_argument("-c", action="store_true", help="use the CONTRAfold model")
    p.add_argument("-g", type=float, default=None, help="single gamma")
    p.add_argument(
        "--bpp-cache",
        default=None,
        help="directory for BPP checkpoint/resume (skips the partition "
        "function for already-folded sequences)",
    )
    add_port_flags(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    records = read_fasta(args.i)
    engine = FoldEngine(uses_contra_model=args.c, device=args.device,
                        numerics=numerics_of(args))
    if args.bpp_cache:
        from ..utils.checkpoint import BppStore, cached_fold_batch

        folded = cached_fold_batch(
            engine, [r.seq for r in records], BppStore(args.bpp_cache)
        )
    else:
        folded = engine.fold_batch([r.seq for r in records])
    results = [
        (bpp, presence, len(records[k].seq))
        for k, (bpp, presence) in enumerate(folded)
    ]
    os.makedirs(args.o, exist_ok=True)
    gammas = [args.g] if args.g is not None else list(DEFAULT_GAMMAS)
    write_gamma_files(args.o, centroid_structures(results, gammas,
                                                  engine.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
