"""The harness: it refuses to run without a card, or without the program
beside it; it imports neither JAX nor the JAX package; a run on the CPU
(with the card check skipped) judges the program correct, and judges a
broken program and the bfloat16 control not correct; the trace reduction
and the metric readers."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import bench_cases
from benchlib import harness, spec as spec_lib, trace as TR
from benchlib.program import Program

torch.set_num_threads(2)
_BENCH = spec_lib._json(bench_cases.ROOT / "BENCHMARK.json")
METRICS = [m["name"] for m in _BENCH["end_to_end"] + _BENCH["per_layer"]]
RUN = [sys.executable, str(bench_cases.BENCH_DIR / "run.py"),
       "--workload", "turner2004.bpp_rnasep", "--seed", "3",
       "--seconds", "1", "--trace", "0"]


def _cpu_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_run_refuses_without_a_card():
    p = subprocess.run(RUN, cwd=bench_cases.ROOT, capture_output=True,
                       text=True, env=_cpu_env(), timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(bench_cases.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench_cases.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(RUN, cwd=tmp_path, capture_output=True, text=True,
                       env=_cpu_env(), timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _run(cell, program_cls=Program, trace=False, seconds=0.3):
    spec = bench_cases.tiny_spec(cell)
    return harness.run(spec, 2 ** 31 + 77, seconds, trace, "cpu",
                       time.perf_counter(), program_cls=program_cls,
                       log=lambda m: None)


class HalfLeftOut(Program):
    """Folds the first half of each call; the rest comes back empty."""

    def call(self, seqs, gammas=None, timer=None, spans=False):
        half = len(seqs) // 2
        results, structures = super().call(seqs[:half], gammas, timer, spans)
        results += [(np.zeros((len(s), len(s)), np.float32),
                     np.zeros((len(s), len(s)), bool)) for s in seqs[half:]]
        if structures is not None:
            for g in structures:
                structures[g] += ["." * len(s) for s in seqs[half:]]
        return results, structures


class OneAnswerAltered(Program):
    """Alters one answer where it is produced: a probability, and the
    structure of the largest gamma of one record."""

    def call(self, seqs, gammas=None, timer=None, spans=False):
        results, structures = super().call(seqs, gammas, timer, spans)
        bpp, presence = results[0]
        i, j = np.unravel_index(np.argmax(bpp), bpp.shape)
        bpp = bpp.copy()
        bpp[i, j] *= 0.9
        results[0] = (bpp, presence)
        if structures is not None:
            g = max(structures)
            structures[g][0] = "." * len(structures[g][0])
        return results, structures


@pytest.mark.parametrize("cell", bench_cases.CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    names = {m["name"] for m in spec_lib.load(cell)["end_to_end"]}
    assert set(r["metrics"]) == names


class HalfDropped(Program):
    """Folds the first half of each call and returns only its outputs."""

    def call(self, seqs, gammas=None, timer=None, spans=False):
        return super().call(seqs[:len(seqs) // 2], gammas, timer, spans)


@pytest.mark.parametrize("fault", [HalfLeftOut, HalfDropped,
                                   OneAnswerAltered])
@pytest.mark.parametrize("cell", ["contrafold_surrogate.centroid_trna",
                                  "turner2004.bpp_rnasep"])
def test_broken_program_is_not_correct(cell, fault):
    r = _run(cell, fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["contrafold_surrogate.centroid_trna",
                                  "turner2004.bpp_rnasep"])
def test_control_is_not_correct(cell):
    import control
    from benchlib import check

    spec = bench_cases.tiny_spec(cell)
    got = control.readings(spec, 2 ** 31 + 3, "cpu", 4)["control"]
    ok, checks = check.verdict(got, spec["limits"])
    assert not ok, checks


class Instant(Program):
    """Returns at once, an empty answer a sequence; keeps the calls it got."""

    def __init__(self, config, params, device):
        self.got = []
        Instant.last = self

    def call(self, seqs, gammas=None, timer=None, spans=False):
        self.got.append(seqs)
        results = [(np.zeros((len(s), len(s)), np.float32),
                    np.zeros((len(s), len(s)), bool)) for s in seqs]
        structures = None if gammas is None else {
            g: ["." * len(s) for s in seqs] for g in gammas}
        return results, structures


def test_window_outrunning_the_pool_goes_on_with_the_same_calls(
        monkeypatch):
    from benchlib import traffic as T

    spec = bench_cases.tiny_spec("turner2004.bpp_rnasep")
    monkeypatch.setattr(T, "POOL_HEADROOM", 0.0)     # 8 calls made ahead
    r = harness.run(spec, 2 ** 31 + 5, 0.2, False, "cpu", time.perf_counter(),
                    program_cls=Instant, log=lambda m: None)
    got = Instant.last.got[harness.WARMUP_CALLS:]
    assert r["attempted"] == len(got) > 8
    want = T.pool(spec["traffic"], 2 ** 31 + 5, len(got))
    assert all(len(a) == len(b) and all((x == y).all() for x, y in zip(a, b))
               for a, b in zip(got, want))


def test_pool_is_sized_from_the_warm_calls_and_the_traced_window(
        monkeypatch):
    from benchlib import traffic as T

    asked = []
    monkeypatch.setattr(T, "pool_size",
                        lambda seconds, call_s: asked.append(
                            (seconds, call_s)) or 8)
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.1)
    spec = bench_cases.tiny_spec("turner2004.bpp_rnasep")
    harness.run(spec, 2 ** 31 + 9, 30.0, True, "cpu", time.perf_counter(),
                program_cls=Instant, log=lambda m: None)
    (seconds, call_s), = asked
    assert seconds == 0.1 and 0 < call_s < 1
    monkeypatch.undo()
    assert T.pool_size(51, 0.1) == 1020 and T.pool_size(1, 10) == 8


def test_outputs_short_of_the_batch_read_infinite_and_count_as_missing():
    from benchlib import check

    refs = [np.zeros((5, 5)), np.zeros((7, 7))]
    out = [(np.zeros((5, 5), np.float32), np.zeros((5, 5), bool)),
           (np.zeros((7, 7), np.float32), np.zeros((7, 7), bool))]
    assert check.bpp_numbers(out, refs) == {"bpp_gap": 0.0}
    assert check.bpp_numbers(out[:1], refs)["bpp_gap"] == np.inf
    assert check.bpp_numbers([out[0], out[0]], refs)["bpp_gap"] == np.inf
    assert check.centroid_numbers({1.0: ["....."]}, refs, [1.0],
                                  "cpu")["centroid_gap"] == np.inf
    assert check.delivered(out, None, None) == 2
    assert check.delivered(out[:1], None, None) == 1
    assert check.delivered(out, {1.0: ["."], 2.0: [".", "."]},
                           [1.0, 2.0]) == 1
    assert check.delivered(out, None, [1.0]) == 0


def test_traced_run_reads_its_layers():
    r = _run("contrafold_surrogate.centroid_trna", trace=True)
    assert r["correct"]
    names = {m["name"] for m in spec_lib.load(
        "contrafold_surrogate.centroid_trna")["per_layer"]}
    assert set(r["metrics"]) <= names
    # on the CPU no device metric is read, only the host's phases
    assert {"centroid.fill_copy_ms", "centroid.traceback_ms"} <= set(
        r["metrics"])
    assert not {"kernels.fold_roofline", "device.idle_share",
                "runner.d2h_ms"} & set(r["metrics"])
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_harness_imports_no_jax():
    """A whole traced run on the CPU, the control and every metric reader
    load neither JAX nor the JAX package."""
    code = "\n".join([
        "import sys, time, json",
        f"sys.path[:0] = [{str(bench_cases.BENCH_DIR / 'tests')!r}]",
        "import bench_cases, control",
        "from benchlib import harness",
        "spec = bench_cases.tiny_spec('contrafold_surrogate.centroid_trna')",
        "harness.run(spec, 1, 0.1, True, 'cpu', time.perf_counter(),"
        " log=lambda m: None)",
        f"[harness.reader(m) for m in {METRICS!r}]",
        "print(json.dumps(harness.forbidden_modules()))",
    ])
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=bench_cases.ROOT, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "rna_algos_tpu")


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rna_algos_tpu_torch_x",
                        types.ModuleType("rna_algos_tpu_torch_x"))
    assert "rna_algos_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in harness.forbidden_modules()


def test_trace_reduction():
    dev = [("k1", 0.0, 10.0), ("Memcpy DtoH (Device -> Pageable)", 5.0,
                                20.0), ("k2", 40.0, 50.0),
           ("Memset (Device)", 60.0, 61.0)]
    host = [("bench.call", 0.0, 100.0), ("bench.fold_batch", 0.0, 30.0),
            ("aten::add", 25.0, 35.0), ("bench.centroid", 30.0, 100.0)]
    t = TR.Trace(dev, host, (0.0, 100.0))
    assert t.busy_s() == pytest.approx(31e-6)
    assert t.window_s() == pytest.approx(100e-6)
    assert [e[0] for e in t.in_spans("fold_batch")] == [
        "k1", "Memcpy DtoH (Device -> Pageable)"]
    assert t.top_ops()[0] == ["Memcpy DtoH (Device -> Pageable)",
                              pytest.approx(15e-6)]
    # gaps [20, 40], [50, 60], [61, 100] by what the host did at their
    # middles
    assert dict(t.idle_gaps()) == {
        "centroid/aten::add": pytest.approx(20e-6),
        "centroid": pytest.approx(49e-6)}
    assert TR.is_copy("Memset (Device)") and TR.is_d2h(dev[1][0])


def test_readers_read_nothing_from_nothing():
    ctx = types.SimpleNamespace(
        calls=0, seqs=0, window_s=1.0, latencies_s=[], setup_s=1.0,
        peak_bytes=0, trace=None, runs=0, phases=None, work=None,
        step_flops=None, gammas=None)
    for m in METRICS:
        if m in ("seqs_per_s", "peak_mem_gib", "setup_s"):
            continue
        assert harness.reader(m)(ctx) is None, m


@pytest.mark.cuda
def test_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmd = list(RUN)
    cmd[cmd.index("--seconds") + 1] = "5"
    p = subprocess.run(cmd, cwd=bench_cases.ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
