"""Flags shared by the port's CLIs."""


def add_port_flags(p):
    p.add_argument(
        "--numerics", choices=("exact", "parity", "fast"), default=None,
        help="exact (default) and fast run the probability-space kernels; "
        "parity the log-space kernels with the reference's cubic log-add "
        "(buckets <= 256)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device to fold on (default cuda; no fallback to the CPU)",
    )
