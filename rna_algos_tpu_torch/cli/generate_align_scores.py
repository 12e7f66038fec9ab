"""CLI: CONTRAlign parameter codegen (``rna_algos_tpu.cli.generate_align_scores``).

Mirrors `reference/src/bin/generate_align_scores.rs`: parses a CONTRAlign
v2.01 parameter text file and writes a compiled score module, a Python
source file with the constants the Rust codegen writes into
`src/compiled_align_scores.rs:1-19` (the same feature dropping and
symmetrization; see params/contralign.py).  Framework-free: the same bytes
as the JAX package's CLI.
"""

import argparse
import sys

from ..params.contralign import parse_contralign_params


def build_parser():
    p = argparse.ArgumentParser(
        prog="generate_align_scores", description="CONTRAlign score codegen"
    )
    p.add_argument("-i", required=True, help="input CONTRAlign parameter file")
    p.add_argument("-o", required=True, help="output Python module path")
    return p


def render_module(sc):
    lines = [
        '"""Compiled CONTRAlign v2.01 align scores (generated; do not edit)."""',
        "",
        "import numpy as np",
        "",
    ]
    for name in (
        "init_match_score",
        "init_insert_score",
        "match2match_score",
        "match2insert_score",
        "insert_extend_score",
        "insert_switch_score",
    ):
        lines.append(f"{name.upper()} = np.float32({float(sc[name])!r})")
    ins = ", ".join(repr(float(v)) for v in sc["insert_scores"])
    lines.append(f"INSERT_SCORES = np.array([{ins}], dtype=np.float32)")
    rows = ",\n    ".join(
        "[" + ", ".join(repr(float(v)) for v in row) + "]"
        for row in sc["match_scores"]
    )
    lines.append(f"MATCH_SCORES = np.array([\n    {rows}\n], dtype=np.float32)")
    lines.append("")
    return "\n".join(lines)


def main(argv=None):
    args = build_parser().parse_args(argv)
    with open(args.i) as f:
        sc = parse_contralign_params(f.read())
    with open(args.o, "w") as f:
        f.write(render_module(sc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
