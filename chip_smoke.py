"""GPU smoke run of the PyTorch / CUDA port (rna_algos_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU and nvcc.  Phases, each fatal on failure:

1. card name and power limit, the kernels' nvcc build from csrc/;
2. each kernel against its plain PyTorch version on the card (K3 bitwise in
   both directions, K1 and K2 within stated tolerances at N = 128, B = 64
   and N = 256, B = 32), and each one's time beside the plain version's at
   the main path's shapes;
3. the main path, FoldEngine(device="cuda").fold_batch, on the six tRNAs
   tiled to B = 192 (bucket 128) and on 96 seeded random sequences of
   150-200 nt (bucket 256), with every kernel's launch count;  its BPPs
   held against the plain path on the card and the tRNA goldens;
4. the centroid CLI on assets/sampled_trnas.fa, byte for byte against
   tests/golden/c_baseline/centroid_contra/;
5. seqs/s of both main-path configurations, kernel path and plain path.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a GPU it exits non-zero and prints
no result.
"""

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SHAPES_CHECK = ((128, 64), (256, 32))
SHAPES_MAIN = ((128, 192), (256, 96))
# K1/K2 kernel vs plain on the card: both FP32, sums in different orders
# (sequential FMA in the kernel, tree sums and a matmul in the plain
# version), all terms positive, so the error stays relative.
RTOL_INSIDE = 1e-4
# below this the scaled states are float32 rounding noise near the
# denormal range, where one summation order can round to 0
ATOL_TINY = 1e-30
ATOL_BPPO = 1e-5
TOL_MAIN_VS_PLAIN = 1e-4
TOL_GOLDEN = 5e-4


def random_batch(B, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, 4, size=int(rng.integers(lo, hi + 1))))
            for _ in range(B)]


def padded(seqs, N, device):
    from rna_algos_tpu_torch.parallel.runner import pad_seqs

    arr = torch.as_tensor(pad_seqs(seqs, N), dtype=torch.int64, device=device)
    ns = torch.as_tensor([len(s) for s in seqs], dtype=torch.int32,
                         device=device)
    return arr, ns


def kernel_inputs(N, B, seed, device):
    """The inputs the main path hands K1, K2 and K3 at ln_sigma = 0.9."""
    from rna_algos_tpu_torch.ops import pallas_fold as PF
    from rna_algos_tpu_torch.ops import pallas_fold_prob as PP
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8
    from rna_algos_tpu_torch.parallel.runner import FoldEngine

    lo = max(30, N // 2 + 10)
    seqs, ns = padded(random_batch(B, lo, N, seed), N, device)
    ct = FoldEngine(uses_contra_model=True, device=device).tbl
    ls = torch.full((B,), 0.9, device=device)
    mi, mo_pre, acc, b0lo = P8.contra_prob_mats_merged(seqs, ns, ct, ls, N)
    KW = PP._banded_window_kernel(PP._contra_len_prob(ct, ls))
    scal = PP._scal_rows(ct, ls)
    close, ext, one = P8.contra_inside(mi, KW, scal, ns)
    QONE, extL, extR, glob = PF.contra_outside_aux(ns, ext, one, N)
    mo = dict(mo_pre)
    mo["ACCB"] = (acc * extL[:, None, :] * (1.0 / glob)[:, None, None]
                  * scal[:, 1][:, None, None])
    mo["CLOSE"] = close
    pq, _, _ = PF.contra_pq_tables(seqs, ns, ct, N)
    return dict(
        seqs=seqs, ns=ns, mi=mi, KW=KW, scal=scal, mo=mo,
        one=one, QONE=QONE, extR=extR, b0lo=b0lo,
        pq=[pq[k].contiguous() for k in sorted(pq)],
        outside_args=(mo, one, QONE, extR, b0lo, KW, scal, ns, 5),
    )


def check_skew(inp):
    """K3 vs plain, bitwise, both directions; returns max abs error (0)."""
    from rna_algos_tpu_torch.ops import pallas_skew as K3

    for inv in (False, True):
        got = K3.skew_pq_batch(inp["pq"], inv=inv)
        want = K3.skew_pq_batch_plain(inp["pq"], inv=inv)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"K3 skew inv={inv} differs from plain")
    return 0.0


def check_inside(inp):
    """K1 vs plain on close, ext, one: |k - p| <= RTOL_INSIDE * |p|.
    Returns (max abs error, max relative error); the scaled partition
    functions run up to ~1e8, so the relative error is the telling one."""
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8

    got = P8.contra_inside(inp["mi"], inp["KW"], inp["scal"], inp["ns"])
    want = P8.contra_inside_plain(inp["mi"], inp["KW"], inp["scal"], inp["ns"])
    torch.cuda.synchronize()
    worst_abs = worst_rel = 0.0
    for name, g, w in zip(("close", "ext", "one"), got, want):
        err = (g - w).abs()
        rel = float((err / w.abs().clamp(min=1e-30)).max())
        worst_abs = max(worst_abs, float(err.max()))
        worst_rel = max(worst_rel, rel)
        bad = ~(err <= RTOL_INSIDE * w.abs() + ATOL_TINY)
        print(f"  K1 {name}: max rel err {rel:.3e} max abs "
              f"{float(err.max()):.3e}, {int(bad.sum())} outside tolerance")
        if bool(bad.any()):
            idx = bad.nonzero()[0].tolist()
            raise AssertionError(
                f"K1 {name} differs from plain at {idx}: kernel "
                f"{float(g[tuple(idx)])!r} plain {float(w[tuple(idx)])!r}"
            )
    return worst_abs, worst_rel


def check_outside(inp):
    """K2 vs plain on bppo: max |k - p| <= ATOL_BPPO."""
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8

    got = P8.contra_outside(*inp["outside_args"])
    want = P8.contra_outside_plain(*inp["outside_args"])
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"  K2 bppo: max abs err {err:.3e}, max bppo {float(want.max()):.4f}")
    if not bool(torch.isfinite(got).all()) or err > ATOL_BPPO:
        raise AssertionError(f"K2 bppo differs from plain: {err}")
    return err


def cuda_ms(fn, reps):
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


@contextlib.contextmanager
def plain_kernels():
    """Route the main path through the plain versions on the card."""
    from rna_algos_tpu_torch.models import mccaskill as M
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8
    from rna_algos_tpu_torch.ops import pallas_skew as K3

    saved = (P8.contra_inside, P8.contra_outside, P8.skew_pq_batch,
             M.skew_pq_batch)
    P8.contra_inside = P8.contra_inside_plain
    P8.contra_outside = P8.contra_outside_plain
    P8.skew_pq_batch = M.skew_pq_batch = K3.skew_pq_batch_plain
    try:
        yield
    finally:
        (P8.contra_inside, P8.contra_outside, P8.skew_pq_batch,
         M.skew_pq_batch) = saved


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rna_algos_tpu_torch.ops import _build
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8
    from rna_algos_tpu_torch.ops import pallas_skew as K3
    from rna_algos_tpu_torch.parallel.runner import FoldEngine
    from rna_algos_tpu_torch.cli import centroid_fold as cf_cli
    from rna_algos_tpu_torch.cli.centroid_fold import read_fasta

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {name}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # phase 1: build
    lib = _build.library()
    print(f"build: {lib.build_seconds:.1f} s -> {lib.path.name}")
    for line in lib.compiler_output.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    # phase 2: kernels vs plain
    err = {"skew": 0.0, "contra_inside": 0.0, "contra_outside": 0.0}
    rel_inside = 0.0
    for N, B in SHAPES_CHECK:
        print(f"check N={N} B={B}")
        inp = kernel_inputs(N, B, seed=N + B, device=dev)
        err["skew"] = max(err["skew"], check_skew(inp))
        abs_in, rel_in = check_inside(inp)
        err["contra_inside"] = max(err["contra_inside"], abs_in)
        rel_inside = max(rel_inside, rel_in)
        err["contra_outside"] = max(err["contra_outside"], check_outside(inp))
    times = {}
    for N, B in SHAPES_MAIN:
        inp = kernel_inputs(N, B, seed=7 * N, device=dev)
        a = (inp["mi"], inp["KW"], inp["scal"], inp["ns"])
        tables = [inp["mi"][k] for k in sorted(inp["mi"])]
        t = {
            "skew": (cuda_ms(lambda: K3.skew_pq_batch(tables), 20),
                     cuda_ms(lambda: K3.skew_pq_batch_plain(tables), 20)),
            "contra_inside": (cuda_ms(lambda: P8.contra_inside(*a), 5),
                              cuda_ms(lambda: P8.contra_inside_plain(*a), 2)),
            "contra_outside": (
                cuda_ms(lambda: P8.contra_outside(*inp["outside_args"]), 5),
                cuda_ms(lambda: P8.contra_outside_plain(*inp["outside_args"]), 2),
            ),
        }
        for k, (ms, pms) in t.items():
            print(f"time N={N} B={B} {k}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
        times[(N, B)] = t

    # phase 3: the main path, counted
    trnas = [r.seq for r in read_fasta(ROOT / "assets" / "sampled_trnas.fa")]
    batches = {
        "trna_N128_B192": trnas * 32,
        "rfam_N256_B96": random_batch(96, 150, 200, seed=2024),
    }
    engine = FoldEngine(uses_contra_model=True, device="cuda")
    counters = (K3.launches, P8.inside_launches, P8.outside_launches)
    for c in counters:
        c.reset()
    results = {k: engine.fold_batch(v) for k, v in batches.items()}
    torch.cuda.synchronize()
    counts = {c.name: c.count for c in counters}
    print(f"main path launches: {counts}")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    with plain_kernels():
        plain = {k: engine.fold_batch(v) for k, v in batches.items()}
    for key in batches:
        worst = max(float(np.abs(a[0] - b[0]).max())
                    for a, b in zip(results[key], plain[key]))
        shapes_ok = all(a[0].shape == (len(s), len(s)) and np.isfinite(a[0]).all()
                        for a, s in zip(results[key], batches[key]))
        print(f"{key}: kernel vs plain path max |dBPP| {worst:.3e}")
        if worst > TOL_MAIN_VS_PLAIN or not shapes_ok:
            raise AssertionError(f"{key}: main path disagrees with plain path")
    gold = np.load(ROOT / "tests" / "golden" / "trna_bpps.npz")
    worst = max(float(np.abs(results["trna_N128_B192"][k][0]
                             - gold[f"rec{k}_contra"]).max())
                for k in range(len(trnas)))
    print(f"tRNA vs trna_bpps.npz: max |dBPP| {worst:.3e}")
    if worst > TOL_GOLDEN:
        raise AssertionError("tRNA BPPs outside the 5e-4 golden budget")

    # phase 4: the centroid CLI, byte for byte
    ref_dir = ROOT / "tests" / "golden" / "c_baseline" / "centroid_contra"
    with tempfile.TemporaryDirectory() as tmp:
        cf_cli.main(["-i", str(ROOT / "assets" / "sampled_trnas.fa"),
                     "-o", tmp, "-c"])
        names = sorted(os.listdir(ref_dir))
        if names != sorted(os.listdir(tmp)):
            raise AssertionError("centroid CLI wrote other files")
        for nm in names:
            if (ref_dir / nm).read_bytes() != (pathlib.Path(tmp) / nm).read_bytes():
                raise AssertionError(f"centroid CLI output differs: {nm}")
    print(f"centroid CLI: {len(names)} files byte-identical")

    # phase 5: main-path throughput, kernel path and plain path
    for key, seqs in batches.items():
        for label, ctx in (("kernel", contextlib.nullcontext),
                           ("plain", plain_kernels)):
            with ctx():
                ms = cuda_ms(lambda: engine.fold_batch(seqs),
                             3 if label == "kernel" else 1)
            print(f"throughput {key} {label}: {len(seqs) / (ms / 1e3):.2f} "
                  f"seqs/s ({ms:.2f} ms/batch) on {smi}")

    replaces = {
        "skew": ("rna_algos_tpu_torch/csrc/skew.cu",
                 "rna_algos_tpu/ops/pallas_skew.py:36"),
        "contra_inside": ("rna_algos_tpu_torch/csrc/contra_inside.cu",
                          "rna_algos_tpu/ops/pallas_fold_prob8.py:562"),
        "contra_outside": ("rna_algos_tpu_torch/csrc/contra_outside.cu",
                           "rna_algos_tpu/ops/pallas_fold_prob8.py:1054"),
    }
    head = SHAPES_MAIN[0]
    kernels = []
    for k, (src, rep) in replaces.items():
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[k], "max_abs_err": err[k],
            "ms": times[head][k][0], "plain_ms": times[head][k][1],
            "ms_by_shape": {f"N{N}_B{B}": times[(N, B)][k][0]
                            for N, B in SHAPES_MAIN},
            "plain_ms_by_shape": {f"N{N}_B{B}": times[(N, B)][k][1]
                                  for N, B in SHAPES_MAIN},
        })
    kernels[1]["max_rel_err"] = rel_inside
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    t_start = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    sys.exit(rc)
