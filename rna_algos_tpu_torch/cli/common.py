"""Flags shared by the port's CLIs."""

LOG_SPACE_ITEM = (
    "--numerics parity needs the log-space cubic kernels, not ported yet "
    "(ROADMAP A10: kernels K16-K19)"
)


def add_port_flags(p):
    p.add_argument(
        "--numerics", choices=("exact", "parity", "fast"), default=None,
        help="exact (default) and fast both run the probability-space "
        "kernels; parity is not ported yet",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device to fold on (default cuda; no fallback to the CPU)",
    )


def check_numerics(numerics):
    if numerics == "parity":
        raise NotImplementedError(LOG_SPACE_ITEM)
