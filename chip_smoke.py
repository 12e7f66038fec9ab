"""GPU smoke run of the PyTorch / CUDA port (rna_algos_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU and nvcc.  Phases, each fatal on failure:

1. card name and power limit, the kernels' nvcc build from csrc/ (one
   nvcc per source, in parallel);
2. each kernel against its plain PyTorch version on the card (K3 bitwise in
   both directions, also on the Turner precompute's 18 tables at once; K1,
   K2 (CONTRA) and K4, K5 (Turner) within stated tolerances at N = 128,
   B = 64 and N = 256, B = 32), and each one's time beside the plain
   version's at the main path's shapes;
3. the main paths, FoldEngine(device="cuda").fold_batch for CONTRA and for
   Turner, each on the six tRNAs tiled to B = 192 (bucket 128) and on 96
   seeded random sequences of 150-200 nt (bucket 256), each run with every
   launch count set to 0 just before it and read just after; the BPPs
   held against the plain path on the card and the tRNA goldens;
4. the centroid CLI on assets/sampled_trnas.fa: with -c byte for byte
   against tests/golden/c_baseline/centroid_contra/, without -c against
   centroid_turner/ under the gamma = 1 tie rule (``turner_centroid_verdict``);
5. seqs/s of every main-path configuration, kernel path and plain path.

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
# The one Turner centroid cell where the probability path may leave the
# cubic golden: record 0 of centroid_threshold=1.fa pairs (2, 80) in the
# golden at BPP 1.0000076; the probability path's BPP there is ~0.999993,
# and gamma = 1 pairs only above 1 (a tie within ~1e-5).
TURNER_TIE = ("centroid_threshold=1.fa", 0, (2, 80))


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
        inside_args=(mi, KW, scal, ns),
        outside_args=(mo, one, QONE, extR, b0lo, KW, scal, ns, 5),
    )


def turner_inputs(N, B, seed, device):
    """The inputs the Turner main path hands K4, K5 and K3 at ln_sigma =
    0.5 (the Turner seed)."""
    from rna_algos_tpu_torch.ops import pallas_fold as PF
    from rna_algos_tpu_torch.ops import pallas_fold_prob as PP
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8
    from rna_algos_tpu_torch.weights import turner_tables

    lo = max(30, N // 2 + 10)
    seqs, ns = padded(random_batch(B, lo, N, seed), N, device)
    tt = turner_tables(device)
    ls = torch.full((B,), PP.LN_SIGMA0_TURNER, device=device)
    pmats = PP.turner_prob_mats(seqs, ns, tt, ls, N)
    LENBp, LENIp = PP._turner_len_prob(tt, ls)
    KB, K2, KI = PP._turner_banded_kernels(LENBp, LENIp)
    KT = torch.stack([KI, KB, K2], dim=1).contiguous()
    scal = PP._turner_scal_rows(tt, ls, LENIp)
    mi = {k: v.contiguous() for k, v in P8._turner_merge_inside(pmats).items()}
    close, ext, one = P8.turner_inside(mi, KT, scal, ns)
    QONE, extL, extR, glob = PF.contra_outside_aux(ns, ext, one, N)
    mo = {k: v.contiguous() for k, v in P8._turner_merge_outside(
        close, pmats, extL, glob, scal[:, 3]).items()}
    return dict(
        seqs=seqs, ns=ns, mi=mi, KT=KT, scal=scal,
        pq=[mi[k] for k in P8.TURNER_INSIDE_TABLES],   # 18 tables, one K3 call
        inside_args=(mi, KT, scal, ns),
        outside_args=(mo, one, QONE, extR, KT, scal, ns, 5),
    )


def check_skew(inp):
    """K3 vs plain, bitwise, both directions, all of ``inp["pq"]`` in one
    launch; returns max abs error (0)."""
    from rna_algos_tpu_torch.ops import pallas_skew as K3

    for inv in (False, True):
        got = K3.skew_pq_batch(inp["pq"], inv=inv)
        want = K3.skew_pq_batch_plain(inp["pq"], inv=inv)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(
                    f"K3 skew of {len(got)} tables inv={inv} differs from plain"
                )
    return 0.0


def check_inside(inp, label="K1", kernel="contra_inside"):
    """An inside kernel (K1 or K4) vs its plain version on close, ext, one:
    |k - p| <= RTOL_INSIDE * |p|.  Returns (max abs error, max relative
    error); the scaled partition functions run up to ~1e8, so the relative
    error is the telling one."""
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8

    got = getattr(P8, kernel)(*inp["inside_args"])
    want = getattr(P8, kernel + "_plain")(*inp["inside_args"])
    torch.cuda.synchronize()
    worst_abs = worst_rel = 0.0
    for name, g, w in zip(("close", "ext", "one"), got, want):
        err = (g - w).abs()
        rel = float((err / w.abs().clamp(min=1e-30)).max())
        worst_abs = max(worst_abs, float(err.max()))
        worst_rel = max(worst_rel, rel)
        bad = ~(err <= RTOL_INSIDE * w.abs() + ATOL_TINY)
        print(f"  {label} {name}: max rel err {rel:.3e} max abs "
              f"{float(err.max()):.3e}, {int(bad.sum())} outside tolerance")
        if bool(bad.any()):
            idx = bad.nonzero()[0].tolist()
            raise AssertionError(
                f"{label} {name} differs from plain at {idx}: kernel "
                f"{float(g[tuple(idx)])!r} plain {float(w[tuple(idx)])!r}"
            )
    return worst_abs, worst_rel


def check_outside(inp, label="K2", kernel="contra_outside"):
    """An outside kernel (K2 or K5) vs its plain version on bppo:
    max |k - p| <= ATOL_BPPO."""
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8

    got = getattr(P8, kernel)(*inp["outside_args"])
    want = getattr(P8, kernel + "_plain")(*inp["outside_args"])
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"  {label} bppo: max abs err {err:.3e}, max bppo "
          f"{float(want.max()):.4f}")
    if not bool(torch.isfinite(got).all()) or err > ATOL_BPPO:
        raise AssertionError(f"{label} bppo differs from plain: {err}")
    return err


def dot_bracket_pairs(db):
    """The (i, j) pairs of a dot-bracket string."""
    stack, pairs = [], []
    for k, ch in enumerate(db):
        if ch == "(":
            stack.append(k)
        elif ch == ")":
            pairs.append((stack.pop(), k))
    return pairs


def turner_centroid_verdict(ref_dir, out_dir):
    """The Turner centroid files against centroid_turner/: "identical" if
    all are byte-identical, "tie" if they are except that record 0 of
    centroid_threshold=1.fa leaves out the golden's pair (2, 80) and
    nothing else (TURNER_TIE); raises otherwise."""
    ref_dir, out_dir = pathlib.Path(ref_dir), pathlib.Path(out_dir)
    names = sorted(os.listdir(ref_dir))
    if names != sorted(os.listdir(out_dir)):
        raise AssertionError("centroid CLI wrote other files")
    tie_file, tie_rec, (p, q) = TURNER_TIE
    verdict = "identical"
    for nm in names:
        want = (ref_dir / nm).read_text()
        got = (out_dir / nm).read_text()
        if got == want:
            continue
        lines = want.split("\n")
        rec = lines[2 * tie_rec + 1]
        lines[2 * tie_rec + 1] = rec[:p] + "." + rec[p + 1:q] + "." + rec[q + 1:]
        if nm != tie_file or (p, q) not in dot_bracket_pairs(rec) or (
                got != "\n".join(lines)):
            raise AssertionError(f"Turner centroid output differs: {nm}")
        verdict = "tie"
    return verdict


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
    """Route the main paths through the plain versions on the card."""
    from rna_algos_tpu_torch.models import mccaskill as M
    from rna_algos_tpu_torch.ops import pallas_fold as PF
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8
    from rna_algos_tpu_torch.ops import pallas_skew as K3

    swaps = [(P8, k, getattr(P8, k + "_plain")) for k in KERNELS_P8]
    swaps += [(mod, "skew_pq_batch", K3.skew_pq_batch_plain)
              for mod in (P8, PF, M)]
    saved = [(mod, k, getattr(mod, k)) for mod, k, _ in swaps]
    for mod, k, fn in swaps:
        setattr(mod, k, fn)
    try:
        yield
    finally:
        for mod, k, fn in saved:
            setattr(mod, k, fn)


KERNELS_P8 = ("contra_inside", "contra_outside", "turner_inside",
              "turner_outside")
# kernel -> (its source, the TPU kernel it replaces)
REPLACES = {
    "skew": ("rna_algos_tpu_torch/csrc/skew.cu",
             "rna_algos_tpu/ops/pallas_skew.py:36"),
    "contra_inside": ("rna_algos_tpu_torch/csrc/contra_inside.cu",
                      "rna_algos_tpu/ops/pallas_fold_prob8.py:562"),
    "contra_outside": ("rna_algos_tpu_torch/csrc/contra_outside.cu",
                       "rna_algos_tpu/ops/pallas_fold_prob8.py:1054"),
    "turner_inside": ("rna_algos_tpu_torch/csrc/turner_inside.cu",
                      "rna_algos_tpu/ops/pallas_fold_prob8.py:2016"),
    "turner_outside": ("rna_algos_tpu_torch/csrc/turner_outside.cu",
                       "rna_algos_tpu/ops/pallas_fold_prob8.py:2537"),
}


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
    err = {k: 0.0 for k in REPLACES}
    rel = {"contra_inside": 0.0, "turner_inside": 0.0}
    for N, B in SHAPES_CHECK:
        print(f"check N={N} B={B}")
        inp = kernel_inputs(N, B, seed=N + B, device=dev)
        tinp = turner_inputs(N, B, seed=N + B + 1, device=dev)
        err["skew"] = max(err["skew"], check_skew(inp), check_skew(tinp))
        for key, label, x in (("contra_inside", "K1", inp),
                              ("turner_inside", "K4", tinp)):
            a, r = check_inside(x, label, key)
            err[key] = max(err[key], a)
            rel[key] = max(rel[key], r)
        err["contra_outside"] = max(err["contra_outside"], check_outside(inp))
        err["turner_outside"] = max(
            err["turner_outside"], check_outside(tinp, "K5", "turner_outside"))
    times = {}
    for N, B in SHAPES_MAIN:
        inp = kernel_inputs(N, B, seed=7 * N, device=dev)
        tinp = turner_inputs(N, B, seed=7 * N + 1, device=dev)
        tables = [inp["mi"][k] for k in sorted(inp["mi"])]   # 9, as PR 1
        t = {"skew": (cuda_ms(lambda: K3.skew_pq_batch(tables), 20),
                      cuda_ms(lambda: K3.skew_pq_batch_plain(tables), 20)),
             "skew18": (cuda_ms(lambda: K3.skew_pq_batch(tinp["pq"]), 20),
                        cuda_ms(lambda: K3.skew_pq_batch_plain(tinp["pq"]),
                                20))}
        for key, args in (("contra_inside", inp["inside_args"]),
                          ("contra_outside", inp["outside_args"]),
                          ("turner_inside", tinp["inside_args"]),
                          ("turner_outside", tinp["outside_args"])):
            kern, plain = getattr(P8, key), getattr(P8, key + "_plain")
            t[key] = (cuda_ms(lambda: kern(*args), 5),
                      cuda_ms(lambda: plain(*args), 2))
        for k, (ms, pms) in t.items():
            print(f"time N={N} B={B} {k}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
        times[(N, B)] = t

    # phase 3: the main paths, each counted on its own
    trnas = [r.seq for r in read_fasta(ROOT / "assets" / "sampled_trnas.fa")]
    batches = {
        "trna_N128_B192": trnas * 32,
        "rfam_N256_B96": random_batch(96, 150, 200, seed=2024),
    }
    engines = {
        "contra": FoldEngine(uses_contra_model=True, device="cuda"),
        "turner": FoldEngine(uses_contra_model=False, device="cuda"),
    }
    counters = (K3.launches, P8.inside_launches, P8.outside_launches,
                P8.turner_inside_launches, P8.turner_outside_launches)
    path_kernels = {"contra": ("skew", "contra_inside", "contra_outside"),
                    "turner": ("skew", "turner_inside", "turner_outside")}
    results, counts = {}, {}
    for model, engine in engines.items():
        for c in counters:
            c.reset()
        results[model] = {k: engine.fold_batch(v) for k, v in batches.items()}
        torch.cuda.synchronize()
        counts[model] = {c.name: c.count for c in counters}
        print(f"main path {model} launches: {counts[model]}")
        if min(counts[model][k] for k in path_kernels[model]) < 1:
            raise AssertionError(
                f"a kernel of the {model} path never launched: {counts[model]}")
    gold = np.load(ROOT / "tests" / "golden" / "trna_bpps.npz")
    for model, engine in engines.items():
        with plain_kernels():
            plain = {k: engine.fold_batch(v) for k, v in batches.items()}
        for key in batches:
            got = results[model][key]
            worst = max(float(np.abs(a[0] - b[0]).max())
                        for a, b in zip(got, plain[key]))
            shapes_ok = all(
                a[0].shape == (len(s), len(s)) and np.isfinite(a[0]).all()
                for a, s in zip(got, batches[key]))
            print(f"{model} {key}: kernel vs plain path max |dBPP| {worst:.3e}")
            if worst > TOL_MAIN_VS_PLAIN or not shapes_ok:
                raise AssertionError(
                    f"{model} {key}: main path disagrees with plain path")
        worst = max(float(np.abs(results[model]["trna_N128_B192"][k][0]
                                 - gold[f"rec{k}_{model}"]).max())
                    for k in range(len(trnas)))
        print(f"{model} tRNA vs trna_bpps.npz: max |dBPP| {worst:.3e}")
        if worst > TOL_GOLDEN:
            raise AssertionError(
                f"{model} tRNA BPPs outside the 5e-4 golden budget")
    tie_file, tie_rec, (tp, tq) = TURNER_TIE
    tie_bpp = float(results["turner"]["trna_N128_B192"][tie_rec][0][tp, tq])
    print(f"turner record {tie_rec} BPP at {(tp, tq)}: {tie_bpp!r} "
          f"(golden {float(gold[f'rec{tie_rec}_turner'][tp, tq])!r})")

    # phase 4: the centroid CLI, both models
    golden = ROOT / "tests" / "golden" / "c_baseline"
    fasta = str(ROOT / "assets" / "sampled_trnas.fa")
    with tempfile.TemporaryDirectory() as tmp:
        cf_cli.main(["-i", fasta, "-o", tmp, "-c"])
        ref_dir = golden / "centroid_contra"
        names = sorted(os.listdir(ref_dir))
        if names != sorted(os.listdir(tmp)):
            raise AssertionError("centroid CLI wrote other files")
        for nm in names:
            if (ref_dir / nm).read_bytes() != (pathlib.Path(tmp) / nm).read_bytes():
                raise AssertionError(f"centroid CLI output differs: {nm}")
    print(f"centroid CLI -c: {len(names)} files byte-identical")
    with tempfile.TemporaryDirectory() as tmp:
        cf_cli.main(["-i", fasta, "-o", tmp])
        verdict = turner_centroid_verdict(golden / "centroid_turner", tmp)
    print(f"centroid CLI Turner: {len(names)} files, verdict {verdict} "
          f"({tie_file} record {tie_rec})")

    # phase 5: main-path throughput, kernel path and plain path
    for model, engine in engines.items():
        for key, seqs in batches.items():
            for label, ctx in (("kernel", contextlib.nullcontext),
                               ("plain", plain_kernels)):
                with ctx():
                    ms = cuda_ms(lambda: engine.fold_batch(seqs),
                                 3 if label == "kernel" else 1)
                print(f"throughput {model} {key} {label}: "
                      f"{len(seqs) / (ms / 1e3):.2f} seqs/s ({ms:.2f} ms/batch) "
                      f"on {smi}")

    head = SHAPES_MAIN[0]
    kernels = []
    for k, (src, rep) in REPLACES.items():
        paths = [m for m, ks in path_kernels.items() if k in ks]
        entry = {
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(counts[m][k] for m in paths),
            "max_abs_err": err[k],
            "ms": times[head][k][0], "plain_ms": times[head][k][1],
            "ms_by_shape": {f"N{N}_B{B}": times[(N, B)][k][0]
                            for N, B in SHAPES_MAIN},
            "plain_ms_by_shape": {f"N{N}_B{B}": times[(N, B)][k][1]
                                  for N, B in SHAPES_MAIN},
            "launches_by_path": {m: counts[m][k] for m in paths},
        }
        if k in rel:
            entry["max_rel_err"] = rel[k]
        if k == "skew":
            entry["ms_by_shape_18_tables"] = {
                f"N{N}_B{B}": times[(N, B)]["skew18"][0] for N, B in SHAPES_MAIN}
        kernels.append(entry)
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
