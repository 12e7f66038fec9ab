"""Flags shared by the port's CLIs."""

import os

from ..numerics import check_mode


def add_numerics_flag(p, help_text):
    p.add_argument(
        "--numerics", choices=("exact", "parity", "fast"), default=None,
        help=help_text + "; default RNA_ALGOS_NUMERICS, else exact",
    )


def default_numerics():
    """``RNA_ALGOS_NUMERICS``'s mode ("exact" when unset); an invalid value
    raises, as the JAX package's import does."""
    return check_mode(os.environ.get("RNA_ALGOS_NUMERICS", "exact"))


def numerics_of(args):
    """The numerics mode a CLI runs: ``--numerics`` when given, else
    ``default_numerics()``, as the JAX CLIs take it; an invalid
    ``RNA_ALGOS_NUMERICS`` raises either way."""
    env = default_numerics()
    return args.numerics or env


def add_port_flags(p):
    add_numerics_flag(
        p, "exact and fast run the probability-space kernels; parity the "
        "log-space kernels with the reference's cubic log-add (buckets <= 256)")
    p.add_argument(
        "--device", default="cuda",
        help="torch device to fold on (default cuda; no fallback to the CPU)",
    )
