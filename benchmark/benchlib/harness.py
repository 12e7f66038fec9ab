"""One run of one cell: set-up, the measured window, the readings, the
comparison and the result line.

The loop is closed with one client: each call is a request of the cell's
traffic, sent when the previous one has returned its outputs to the host.
The window opens at the first timed call and closes when a call returns
``seconds`` or more after it opened; its time is that whole span.
"""

import gc
import importlib.util
import subprocess
import sys
import time
import types

import numpy as np
import torch

from . import check, spec as spec_lib, traffic as traffic_lib, work
from .program import Program, inside_runs
from .trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "rna_algos_tpu")
# Warm calls of the cell's own shapes before the window; the first also
# pays the one-off first fold_batch.
WARMUP_CALLS = 2
# A traced run traces at most this many seconds of window: the profiler's
# events of a longer one take minutes to read, and the per-layer metrics
# are per call.
TRACE_SECONDS = 15.0


def forbidden_modules():
    """The forbidden top-level modules the process holds, compared by whole
    top-level name (``rna_algos_tpu_torch`` is not ``rna_algos_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in FORBIDDEN if t in tops)


def reader(name):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = spec_lib.BENCH_DIR / "metrics" / f"{name}.py"
    sp = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def _param_bytes(params):
    return sum(4 * np.asarray(v).size for v in params.values())


def run(spec, seed, seconds, trace, device, t0, program_cls=Program,
        log=print):
    """Run the cell of ``spec`` (``spec.load``) once; returns the result
    dict.  ``t0`` is the host clock at the start of the process."""
    traffic = spec["traffic"]
    gammas = traffic.get("gammas")
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    warm = traffic_lib.pool(traffic, seed, WARMUP_CALLS,
                            stream=traffic_lib.WARMUP)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    program = program_cls(spec["config"], spec["params"], device)
    warm_s = []
    for w in warm:
        w0 = time.perf_counter()
        program.call(w, gammas)
        sync()
        warm_s.append(time.perf_counter() - w0)
    # The window's calls are made before it opens, as many as the fastest
    # warm call's pace would need, with headroom; a program that outruns
    # them gets the next calls of the same stream, made inside the window.
    stream = traffic_lib.rng(seed, traffic_lib.TRAFFIC)
    pool = [traffic_lib.call(traffic, stream)
            for _ in range(traffic_lib.pool_size(seconds, min(warm_s)))]
    made_ahead = len(pool)
    prof = timer = None
    if trace:
        from rna_algos_tpu_torch.utils.trace import PhaseTimer
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.start()
        program.call(warm[0], gammas)       # the profiler's own warm-up
        sync()
        timer = PhaseTimer() if gammas is not None else None
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sampler = check.Sampler(check.CHECK_CALLS,
                            traffic_lib.rng(seed, traffic_lib.SAMPLE))
    runs0 = inside_runs()

    latencies, n_seqs = [], 0
    start = time.perf_counter()
    setup_s = start - t0
    k = 0
    while True:
        if k == len(pool):
            # The program outran the calls made ahead: the calls past the
            # pool are made here, inside the window, from the same stream
            # (so the k-th call of a seed is the same).
            pool.append(traffic_lib.call(traffic, stream))
        seqs = pool[k]
        c0 = time.perf_counter()
        if trace:
            with torch.profiler.record_function("bench.call"):
                results, structures = program.call(seqs, gammas, timer,
                                                   spans=True)
        else:
            results, structures = program.call(seqs, gammas)
        c1 = time.perf_counter()
        latencies.append(c1 - c0)
        n_seqs += check.delivered(results, structures, gammas)
        sampler.offer(k, {"seqs": seqs, "results": results,
                          "structures": structures})
        k += 1
        if c1 - start >= seconds:
            break
    sync()
    window_s = time.perf_counter() - start
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    runs = inside_runs() - runs0

    tr = work_done = step_flops = None
    if trace:
        t_read = time.perf_counter()
        prof.stop()
        tr = Trace.from_profiler(prof)
        del prof
        log(f"trace: {len(tr.device)} device and {len(tr.host)} host events "
            f"read in {time.perf_counter() - t_read:.1f} s")
        pb = _param_bytes(spec["params"])
        work_done = tuple(map(sum, zip(*(work.call_work(c, pb, device)
                                          for c in pool[:k]))))
        step_flops = work_done[0]
        if gammas:
            step_flops += work.FLOPS_PER_TERM * sum(
                work.centroid_terms(len(s), len(gammas))
                for c in pool[:k] for s in c)
    ctx = types.SimpleNamespace(
        calls=k, seqs=n_seqs, window_s=window_s, latencies_s=latencies,
        setup_s=setup_s, peak_bytes=window_peak, trace=tr, runs=runs,
        phases=timer.summary() if timer is not None else None,
        work=work_done, step_flops=step_flops, gammas=gammas)
    names = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in names:
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(max(setup_peak, window_peak)),
    }
    if trace:
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s()
    if cuda:
        dev_info["power"] = power_limit()

    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    from reference import mccaskill as R

    ref_tables = R.tables(spec["params"], spec["config"]["model"], device,
                          torch.float64)
    numbers = check.compare(sampler.records(), ref_tables,
                            spec["config"]["model"], gammas, device)
    correct, checks = check.verdict(numbers, spec["limits"])
    q = np.percentile(np.asarray(latencies) * 1e3, [25, 50, 75])
    log(f"reference: {len(sampler.records())} calls compared in "
        f"{time.perf_counter() - r0:.2f} s; window {k} calls, "
        f"{window_s:.3f} s, set-up {setup_s:.3f} s, {runs} inside runs; "
        f"call ms quartiles {q[0]:.2f} {q[1]:.2f} {q[2]:.2f}")
    if k > made_ahead:
        log(f"the window made {k - made_ahead} calls past the {made_ahead} "
            f"made ahead (fastest warm call {min(warm_s):.4f} s)")
    result = {"correct": correct, "attempted": k, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result
