"""The readings the comparison's limits are set from, on a CUDA card.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
        [--control-seeds <n> ...] [--calls M]

For each seed, the cell's sampled calls (the ``CHECK_CALLS`` calls of
lowest priority among the first M of the seed's traffic, as a run draws
them) are folded by the program, and by the control: the plain reference
put in the program's place and computed in bfloat16, the nearest precision
below the configuration's float32 (its structures traced back from its own
bfloat16 fill).  Both are compared with the float64 reference as a run
compares, and one JSON line a seed gives both sets of numbers and whether
the cell's limits pass them.  The benchmark's own runs never run it.
"""

import argparse
import json
import pathlib
import sys

import torch

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CONTROL_DTYPE = torch.bfloat16


def sampled_calls(spec, seed, calls):
    """The calls a run of ``calls`` calls would compare, by the run's rule."""
    from benchlib import check, traffic as traffic_lib

    traffic = spec["traffic"]
    pool = traffic_lib.pool(traffic, seed, calls)
    sampler = check.Sampler(check.CHECK_CALLS,
                            traffic_lib.rng(seed, traffic_lib.SAMPLE))
    for k, seqs in enumerate(pool):
        sampler.offer(k, {"seqs": seqs})
    return [rec["seqs"] for rec in sampler.records()]


def control_outputs(seqs, spec, device):
    """The control's (bpp, presence) of every sequence and, with gammas,
    its structures {gamma: [dot-bracket]}."""
    from benchlib import check
    from reference import centroid as RC, mccaskill as R

    model = spec["config"]["model"]
    low = R.tables(spec["params"], model, device, CONTROL_DTYPE)
    bpps = check.reference_bpps(seqs, low, model, device)
    results = [(b.astype("float32"), b > 0) for b in bpps]
    gammas = spec["traffic"].get("gammas")
    structures = None
    if gammas is not None:
        structures = {g: [None] * len(seqs) for g in gammas}
        for block in check.blocks(bpps):
            N = max(len(bpps[k]) for k in block)
            padded = torch.zeros((len(block), N, N), dtype=CONTROL_DTYPE)
            for r, k in enumerate(block):
                n = len(bpps[k])
                padded[r, :n, :n] = torch.as_tensor(bpps[k])
            got = RC.structures(padded.to(device),
                                [len(bpps[k]) for k in block], gammas)
            for r, k in enumerate(block):
                for g, gamma in enumerate(gammas):
                    structures[gamma][k] = got[r][g]
    return results, structures


def readings(spec, seed, device, calls, program=None, control=True):
    """{"program": numbers, "control": numbers} of one seed (``program``
    a ``benchlib.program.Program``, or None to skip its readings)."""
    from benchlib import check
    from reference import mccaskill as R

    model = spec["config"]["model"]
    gammas = spec["traffic"].get("gammas")
    ref = R.tables(spec["params"], model, device, torch.float64)
    out = {}
    for seqs in sampled_calls(spec, seed, calls):
        sides = []
        if program is not None:
            sides.append(("program", program.call(seqs, gammas)))
        if control:
            sides.append(("control", control_outputs(seqs, spec, device)))
        for side, (results, structures) in sides:
            rec = {"seqs": seqs, "results": results, "structures": structures}
            nums = check.compare([rec], ref, model, gammas, device)
            prev = out.setdefault(side, {})
            for k, v in nums.items():
                prev[k] = max(prev.get(k, v), v)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=None,
                    help="seeds that also get the control (default: all)")
    ap.add_argument("--calls", type=int, default=32)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(1, str(ROOT))
    from benchlib import check, spec as spec_lib
    from benchlib.program import Program

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    spec = spec_lib.load(args.workload, ROOT)
    device = "cuda:0"
    program = Program(spec["config"], spec["params"], device)
    ctl = set(args.seeds if args.control_seeds is None
              else args.control_seeds)
    for seed in args.seeds:
        got = readings(spec, seed, device, args.calls, program,
                       control=seed in ctl)
        line = {"workload": args.workload, "seed": seed}
        for side, nums in got.items():
            line[side] = nums
            line[side + "_correct"] = check.verdict(nums, spec["limits"])[0]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
