"""Where the time goes in the port's main paths: one profiled
``FoldEngine.fold_batch`` or ``AlignEngine.match_probs_pairs`` per cell,
on a CUDA GPU.

    python scripts/profile_torch_cells.py [--trace-dir DIR] [--generic-only]
        [--rows-only] [--scan-build CSRC]

Cells as in chip_smoke.py: the six tRNAs tiled to B = 192 (bucket 128), 96
seeded random 150-200 nt sequences (bucket 256), and the long tier's 32
random 300-500 nt (bucket 512) and 16 random 600-1,000 nt sequences
(bucket 1024), for CONTRA and Turner; CONTRA also on 8 random 1,100-2,000
nt sequences (bucket 2048);
and the Durbin pair-HMM on chip_smoke.py's three runs: the 630 pairs of
the tRNAs tiled to 36 sequences (bucket 128) exact and parity, and the
2,016 pairs of 64 random 150-200 nt sequences (bucket 256) exact; and the
parity tier (``FoldEngine(numerics="parity")``, kernels K16-K19) on the
tRNA and random 150-200 nt cells, both models; and the generic-N scan's
cells (kernels K20/K21, chip_smoke.py's batches): Turner exact on seq_1536
and four random 1,409-1,536 nt sequences (bucket 1536), CONTRA exact on two
random 2,817-2,944 nt sequences (bucket 2944), and parity on eight random
300-384 nt sequences (bucket 384) for both models; and the Durbin row
scan's cells (kernel K22, chip_smoke.ROWS_RUNS): the 496 pairs of 32
random 300-450 nt sequences (RNase P scale, buckets (384 | 512)^2) exact
and parity, the 28 pairs of 8 random 1,400-1,536 nt sequences (SSU rRNA
scale) exact, and the 66 pairs of the tRNAs with six of the RNase P
sequences (K14 and K22 in one call).  ``--generic-only`` and
``--rows-only`` profile the generic-N or the row-scan cells alone; ``--scan-build CSRC`` runs K20/K21 through the build
of another checkout's ``csrc`` and its own ``ops/fold_scan.py`` beside it
(as ``scripts/ab_kernels.py --scan`` does), to profile a parent build.
For each it prints the unprofiled batch time (the mean of REPS batches in
one CUDA-event window after two warm-ups, as chip_smoke.cuda_ms; every
cell is timed before the first profiler session, whose instrumentation
slows later launch-bound batches), the profiled trace span, the device busy time (union of the
device intervals), the device-to-host copy time, each kernel's summed
time, the rest of the device time (torch's own kernels) and the idle
share 1 - busy / span.  ``--trace-dir`` also writes a Chrome trace each.
Needs a GPU; exits non-zero without one.
"""

import argparse
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# unprofiled batches timed per cell, as chip_smoke.py's throughput phase
REPS = 5
# device kernel names: the narrow (N <= 256) and the cluster (N > 256)
# entry kernels of each wavefront source
KERNELS = ("skew_kernel", "contra_inside_kernel", "contra_outside_kernel",
           "turner_inside_kernel", "turner_outside_kernel",
           "contra_inside_cluster_kernel", "contra_outside_cluster_kernel",
           "turner_inside_cluster_kernel", "turner_outside_cluster_kernel",
           "pairhmm_prob_kernel", "pairhmm_log_kernel",
           "contra_inside_log_kernel", "contra_outside_log_kernel",
           "turner_inside_log_kernel", "turner_outside_log_kernel",
           "scan_inside_kernel", "scan_outside_kernel",
           "pairhmm_log_fast_kernel", "pairhmm_rows_kernel")


def _union(intervals):
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def batch_ms(call, reps=REPS):
    """Unprofiled mean ms per batch after two warm-ups."""
    import chip_smoke

    call()
    return chip_smoke.cuda_ms(call, reps)


def profile_once(call, trace_path=None):
    from torch.profiler import ProfilerActivity, profile

    call()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    if trace_path:
        prof.export_chrome_trace(str(trace_path))
    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events)) / 1e3
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev]) / 1e3
    by = {k: 0.0 for k in KERNELS}
    counts = {k: 0 for k in KERNELS}
    d2h = other = 0.0
    for e in dev:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        hit = next((k for k in KERNELS if k in e.name), None)
        if hit:
            by[hit] += ms
            counts[hit] += 1
        elif "DtoH" in e.name or "Device -> Pageable" in e.name:
            d2h += ms
        else:
            other += ms
    return dict(span_ms=span, busy_ms=busy, d2h_ms=d2h,
                torch_ms=other, kernels=by, launches=counts,
                idle_share=1.0 - busy / span)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--generic-only", action="store_true",
                    help="only the generic-N scan's cells")
    ap.add_argument("--rows-only", action="store_true",
                    help="only the Durbin row scan's cells")
    ap.add_argument("--scan-build", default=None,
                    help="csrc of another checkout for K20/K21")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_cells: no CUDA GPU available", file=sys.stderr)
        return 2
    import chip_smoke
    from rna_algos_tpu_torch.cli.centroid_fold import read_fasta
    from rna_algos_tpu_torch.parallel.runner import AlignEngine, FoldEngine

    print(torch.cuda.get_device_name(0), torch.__version__)
    if args.scan_build:
        sys.path.insert(0, str(ROOT / "scripts"))
        import ab_kernels
        from rna_algos_tpu_torch.models import mccaskill as M

        ab_kernels.use(ab_kernels.load(args.scan_build, False))
        M.FS = ab_kernels.fold_scan_module(args.scan_build)
        print(f"K20/K21 through {args.scan_build}")
    trnas = [r.seq for r in read_fasta(ROOT / "assets" / "sampled_trnas.fa")]
    cells = {"trna_N128_B192": trnas * 32,
             "rfam_N256_B96": chip_smoke.random_batch(96, 150, 200, seed=2024)}
    longs = {f"long_N{N}_B{b}": chip_smoke.random_batch(b, lo, hi, seed=N)
             for N, (b, lo, hi) in chip_smoke.LONG_BATCHES.items()}
    trace_dir = pathlib.Path(args.trace_dir) if args.trace_dir else None
    if trace_dir:
        trace_dir.mkdir(parents=True, exist_ok=True)
    engines = {"contra": FoldEngine(uses_contra_model=True, device="cuda"),
               "turner": FoldEngine(uses_contra_model=False, device="cuda")}
    calls = {(m, c): (lambda e=engines[m], s=cells[c]: e.fold_batch(s))
             for m in engines for c in cells}
    # the long cells: CONTRA at every long bucket, Turner at 512 and 1024
    for c, seqs in longs.items():
        for m in ("contra",) if "N2048" in c else ("contra", "turner"):
            calls[(m, c)] = (lambda e=engines[m], s=seqs: e.fold_batch(s))
    for m in ("contra", "turner"):
        engine = FoldEngine(uses_contra_model=m == "contra", device="cuda",
                            numerics="parity")
        for c in ("trna_N128_B192", "rfam_N256_B96"):
            calls[(f"{m}_parity", c)] = (lambda e=engine, s=cells[c]:
                                         e.fold_batch(s))
    dsets = chip_smoke.durbin_sets(trnas)
    for path, mode, key in chip_smoke.DURBIN_RUNS:
        aligner = AlignEngine(device="cuda", numerics=mode)
        calls[(path, key)] = (lambda a=aligner, d=dsets[key]:
                              a.match_probs_pairs(*d))
    g = np.load(ROOT / "tests" / "golden" / "longn_f64_1536.npz")
    generic = {
        ("turner", "generic_N1536_B5"): (False, "exact", [
            [int(b) for b in g["seq_1536"]]] + chip_smoke.random_batch(
                *chip_smoke.SCAN_TURNER[:3], seed=chip_smoke.SCAN_TURNER[3])),
        ("contra", "generic_N2944_B2"): (True, "exact",
                                         chip_smoke.random_batch(
            *chip_smoke.SCAN_CONTRA[:3], seed=chip_smoke.SCAN_CONTRA[3]))}
    for m in ("contra", "turner"):
        generic[(f"{m}_parity", "generic_N384_B8")] = (
            m == "contra", "parity", chip_smoke.random_batch(
                *chip_smoke.SCAN_PARITY[:3], seed=chip_smoke.SCAN_PARITY[3]))
    if args.generic_only or args.rows_only:
        calls = {}
    for key, (contra, mode, seqs) in ({} if args.rows_only
                                      else generic).items():
        engine = FoldEngine(uses_contra_model=contra, device="cuda",
                            numerics=mode)
        calls[key] = (lambda e=engine, s=seqs: e.fold_batch(s))
    if not args.generic_only:
        rsets = chip_smoke.rows_sets(trnas)
        for path, mode, key in chip_smoke.ROWS_RUNS:
            aligner = AlignEngine(device="cuda", numerics=mode)
            calls[(path, key)] = (lambda a=aligner, d=rsets[key]:
                                  a.match_probs_pairs(*d))
    times = {k: batch_ms(call, 2 if "generic" in k[1] else REPS)
             for k, call in calls.items()}
    for (model, cell), call in calls.items():
        path = trace_dir / f"{model}_{cell}.json" if trace_dir else None
        r = profile_once(call, path)
        ks = ", ".join(f"{k} {v:.3f} ms x{r['launches'][k]}"
                       for k, v in r["kernels"].items() if r["launches"][k])
        print(f"{model} {cell}: batch {times[(model, cell)]:.2f} ms "
              f"unprofiled; trace span {r['span_ms']:.2f} ms, device busy "
              f"{r['busy_ms']:.3f} ms, D2H {r['d2h_ms']:.3f} ms, torch "
              f"ops {r['torch_ms']:.3f} ms, {ks}, idle share "
              f"{r['idle_share']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
