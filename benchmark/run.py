"""The benchmark of rna_algos_tpu_torch: one run of one cell on a CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit,
which also end standard error.  Exits non-zero, printing no result, without
a CUDA card, or if the process holds JAX or the JAX package once the window
has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if str(BENCH_DIR) not in sys.path:
        sys.path.insert(0, str(BENCH_DIR))
    import torch
    from benchlib import harness, spec as spec_lib

    spec = spec_lib.load(args.workload, ROOT)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"run.py: cell {args.workload} needs {chips} CUDA card(s); "
             f"this machine has {torch.cuda.device_count()}")
        return 2
    sys.path.insert(1, str(ROOT))
    result = harness.run(spec, args.seed, args.seconds, bool(args.trace),
                         "cuda:0", T0, log=_log)
    bad = harness.forbidden_modules()
    if bad:
        _log(f"run.py: the process holds {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
