"""CLI: basepair probabilities (``rna_algos_tpu.cli.mccaskill``).

Same flags and output bytes as the JAX CLI, plus ``--device``.  Output: the
header comment, then ``>{record index}`` blocks of ``i,j,p `` triples in
(i, j) order.
"""

import argparse
import sys

import numpy as np

from ..utils.io import read_fasta
from ..utils.output import probs2str_arrays

from ..parallel.runner import FoldEngine
from .common import add_port_flags, numerics_of

HEADER = (
    "# Format = >{RNA sequence id} {line break} {basepairing left nucleotide}, "
    "{basepairing right nucleotide}, {basepairing probability} ..."
)


def build_parser():
    p = argparse.ArgumentParser(
        prog="mccaskill", description="McCaskill basepair probabilities (CUDA)"
    )
    p.add_argument("-i", required=True, help="input FASTA file path")
    p.add_argument("-o", required=True, help="output file path")
    p.add_argument("-t", type=int, default=None, help="worker hint (compat)")
    p.add_argument("-c", action="store_true", help="use the CONTRAfold model")
    add_port_flags(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    records = read_fasta(args.i)
    engine = FoldEngine(uses_contra_model=args.c, device=args.device,
                        numerics=numerics_of(args))
    results = engine.fold_batch([r.seq for r in records])
    parts = [HEADER]
    for rna_id, (bpp, presence) in enumerate(results):
        iv, jv = np.nonzero(presence)  # row-major, deterministic
        parts.append(f"\n\n>{rna_id}\n" + probs2str_arrays(
            iv, jv, bpp[iv, jv], device=args.device))
    with open(args.o, "w") as f:
        f.write("".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
