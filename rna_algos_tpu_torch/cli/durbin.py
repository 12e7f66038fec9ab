"""CLI: pairwise posterior match probabilities (``rna_algos_tpu.cli.durbin``).

Same flags and output bytes as the JAX CLI, plus ``--device``.  Every
unordered record pair (i < j) is scored (bin/durbin_algo.rs:58-63); the
sequences get PSEUDO_BASE sentinels at both ends (:49-50); the triples
subtract the sentinel offset and keep only p > 0 (:76-89), row-major like
the reference's dense matrix walk.  In a square bucket up to 256,
``--numerics exact`` and ``fast`` run kernel K14 (scaled probabilities),
``parity`` runs K15 (log space with the reference's cubic log-add); every
other pair (a rectangular bucket, or one past 256) runs the row scan K22
in the mode's log space.
"""

import argparse
import sys

import numpy as np

from ..constants import PSEUDO_BASE
from ..parallel.runner import AlignEngine
from ..utils.io import read_fasta
from ..utils.output import probs2str_arrays
from .common import add_numerics_flag, numerics_of

HEADER = (
    "# Format = >{RNA sequence id 1},{RNA sequence id 2} {line break} "
    "{nucleotide 1}, {nucleotide 2}, {nucletide matching probability} ..."
)


def build_parser():
    p = argparse.ArgumentParser(
        prog="durbin", description="pair-HMM match probabilities (CUDA)"
    )
    p.add_argument("-i", required=True, help="input FASTA file path")
    p.add_argument("-o", required=True, help="output file path")
    p.add_argument("-t", type=int, default=None, help="worker hint (compat)")
    add_numerics_flag(
        p, "in square buckets up to 256, exact and fast run the "
        "probability-space kernel K14 and parity the log-space kernel K15 "
        "with the reference's cubics; other buckets run the row scan K22")
    p.add_argument(
        "--device", default="cuda",
        help="torch device to align on (default cuda; no fallback to the CPU)",
    )
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    records = read_fasta(args.i)
    wrapped = [
        np.concatenate([[PSEUDO_BASE], r.seq, [PSEUDO_BASE]]).astype(np.int32)
        for r in records
    ]
    pairs = [
        (i, j) for i in range(len(records)) for j in range(i + 1, len(records))
    ]
    engine = AlignEngine(device=args.device, numerics=numerics_of(args))
    probs = engine.match_probs_pairs(wrapped, pairs)
    parts = [HEADER]
    for (a, b) in pairs:
        mat = probs[(a, b)]
        iv, jv = np.nonzero(mat > 0.0)  # row-major, like the reference walk
        parts.append(
            f"\n\n>{a},{b}\n"
            + probs2str_arrays(iv - 1, jv - 1, mat[iv, jv],
                               device=args.device)
        )
    with open(args.o, "w") as f:
        f.write("".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
