"""The port's utilities against the JAX package's (``utils.trace``,
``utils.debug``, ``utils.platform``): ``dp_cells``, ``PhaseTimer``,
``force``/``force_last`` counts, ``RunLog`` lines, the ``RNA_ALGOS_DEBUG``
NaN checks (and the engines honouring them), ``on_cuda`` and
``device_trace``, on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from rna_algos_tpu.utils import debug as JD
from rna_algos_tpu.utils import trace as JT

from rna_algos_tpu_torch.models import mccaskill as TM
from rna_algos_tpu_torch.parallel import runner as TR
from rna_algos_tpu_torch.utils import debug as TD
from rna_algos_tpu_torch.utils import platform as TP
from rna_algos_tpu_torch.utils import trace as TT


def test_dp_cells_identical():
    for n in range(1, 301):
        assert TT.dp_cells(n) == JT.dp_cells(n), n
    assert TT.dp_cells(128, window=7) == JT.dp_cells(128, window=7)


def test_phase_timer_metrics():
    """``tests/test_aux.py::test_phase_timer_metrics`` on the port's timer,
    and the summary's keys and sums equal the JAX timer's for the same
    phases."""
    got, want = TT.PhaseTimer(), JT.PhaseTimer()
    for t in (got, want):
        with t.phase("inside", cells=TT.dp_cells(100), items=4):
            pass
        with t.phase("inside", items=2):
            pass
        with t.phase("host"):
            pass
    s = got.summary()["inside"]
    assert s["calls"] == 2 and s["items"] == 6
    assert s["cells"] == TT.dp_cells(100)
    assert "cells_per_s" in s
    assert s["cells_per_s"] == s["cells"] / s["seconds"]
    assert s["items_per_s"] == s["items"] / s["seconds"]
    w = want.summary()
    for name, rec in got.summary().items():
        assert sorted(rec) == sorted(w[name]), name
        for k in ("calls", "items", "cells"):
            assert rec[k] == w[name][k]
    # a CPU device is timed on the host clock
    t = TT.PhaseTimer()
    with t.phase("fold", items=1, device="cpu"):
        pass
    assert t.summary()["fold"]["calls"] == 1


TREES = [
    ({"a": np.arange(6.0), "b": (np.ones((2, 3)), [3, None])}, 2),
    ([], 0),
    ([None, 7], 0),
    ({"x": np.zeros((0,)), "y": [np.ones(1), {"z": np.ones((2, 2))}]}, 2),
]


@pytest.mark.parametrize("k", range(len(TREES)))
def test_force_counts_equal_jax(k):
    """``force``/``force_last`` on a tree of tensors count as the JAX
    functions do on the same tree of JAX arrays."""
    import jax.numpy as jnp

    tree, n = TREES[k]

    def leaves(tree, conv):
        if isinstance(tree, dict):
            return {key: leaves(v, conv) for key, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(leaves(v, conv) for v in tree)
        if isinstance(tree, np.ndarray):
            return conv(tree)
        return tree

    jtree = leaves(tree, jnp.asarray)
    ttree = leaves(tree, torch.as_tensor)
    assert TT.force(ttree) == JT.force(jtree) == n
    assert TT.force_last(ttree) == JT.force_last(jtree) == min(n, 1)


def test_runlog_lines(tmp_path, monkeypatch, capsys):
    path = tmp_path / "run.jsonl"
    for mod in (TT, JT):
        log = mod.RunLog(str(path))
        log.event("fold", bucket=128, seqs=6)
        log.close()
    got, want = (json.loads(x) for x in path.read_text().splitlines())
    assert sorted(got) == sorted(want) == ["bucket", "event", "seqs", "ts"]
    assert {k: v for k, v in got.items() if k != "ts"} == {
        k: v for k, v in want.items() if k != "ts"}
    # RNA_ALGOS_RUNLOG names the file; RNA_ALGOS_VERBOSE prints to stderr
    env = tmp_path / "env.jsonl"
    monkeypatch.setenv("RNA_ALGOS_RUNLOG", str(env))
    log = TT.RunLog()
    log.event("x", k=1)
    log.close()
    assert json.loads(env.read_text())["event"] == "x"
    monkeypatch.delenv("RNA_ALGOS_RUNLOG")
    monkeypatch.setenv("RNA_ALGOS_VERBOSE", "1")
    TT.RunLog().event("y")
    assert json.loads(capsys.readouterr().err)["event"] == "y"


def test_debug_nan_checks_env(monkeypatch):
    """RNA_ALGOS_DEBUG=nans sets the port's flag; disable clears it."""
    monkeypatch.setenv("RNA_ALGOS_DEBUG", "nans, other")
    try:
        active = TD.maybe_enable_from_env()
        assert active == JD.maybe_enable_from_env() == {"nans", "other"}
        assert TD.nan_checks_enabled()
    finally:
        TD.disable_nan_checks()
        JD.disable_nan_checks()
    assert not TD.nan_checks_enabled()
    monkeypatch.setenv("RNA_ALGOS_DEBUG", "")
    assert TD.maybe_enable_from_env() == set()
    assert not TD.nan_checks_enabled()


BAD = [
    {"a": np.array([[0.0, np.nan]], dtype=np.float32)},
    {"a": np.array([np.inf], dtype=np.float32)},
    [np.zeros(3, np.float32), (np.array([1.0, np.nan, -np.inf]),)],
    {"b": {"c": np.array([1.0], np.float32), "d": np.full((2, 2), np.inf)}},
]


def test_check_finite_states_accepts_finite_and_neg_inf():
    ok = {"a": np.array([1.0, -np.inf], dtype=np.float32),
          "ids": np.array([1, 2], dtype=np.int32)}
    TD.check_finite_states(ok)
    TD.check_finite_states({"t": torch.tensor([0.5, -float("inf")]),
                            "none": None, "mask": torch.ones(2, dtype=bool)})


@pytest.mark.parametrize("k", range(len(BAD)))
def test_check_finite_states_message_equals_jax(k):
    """NaN and +inf raise with the JAX helper's message, for numpy arrays
    and for the same tree of tensors."""
    tree = BAD[k]
    with pytest.raises(AssertionError) as want:
        JD.check_finite_states(tree, "fold")
    with pytest.raises(AssertionError) as got:
        TD.check_finite_states(tree, "fold")
    assert "lse_pair operand contract" in str(got.value)
    assert str(got.value) == str(want.value)

    def tensors(t):
        if isinstance(t, dict):
            return {key: tensors(v) for key, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(tensors(v) for v in t)
        return torch.as_tensor(t)

    with pytest.raises(AssertionError) as got_t:
        TD.check_finite_states(tensors(tree), "fold")
    assert str(got_t.value) == str(want.value)


def test_fold_engine_raises_on_injected_nan(monkeypatch, trna_records):
    """Under RNA_ALGOS_DEBUG=nans a FoldEngine (which reads it in
    ``__init__``) raises on a NaN BPP, naming the output and the input's
    index; without the flag the same output passes through."""
    real = TM.mccaskill_bpp_batch_auto

    def poisoned(seqs, ns, *args, **kw):
        bpp, presence = real(seqs, ns, *args, **kw)
        bpp = bpp.clone()
        bpp[-1, 0, 1] = float("nan")
        return bpp, presence

    monkeypatch.setattr(TM, "mccaskill_bpp_batch_auto", poisoned)
    seqs = [r.seq for r in trna_records[:2]]
    monkeypatch.setenv("RNA_ALGOS_DEBUG", "nans")
    try:
        engine = TR.FoldEngine(device="cpu")
        assert TD.nan_checks_enabled()
        with pytest.raises(AssertionError, match=r"fold_batch\(N=128\)\['bpp'\]"
                           r"\[\d\]: NaN/\+inf at \(0, 1\)"):
            engine.fold_batch(seqs)
    finally:
        TD.disable_nan_checks()
    monkeypatch.delenv("RNA_ALGOS_DEBUG")
    out = TR.FoldEngine(device="cpu").fold_batch(seqs)
    assert not TD.nan_checks_enabled()
    assert sum(int(np.isnan(b).sum()) for b, _ in out) == 1


def test_align_engine_reads_debug_env(monkeypatch):
    monkeypatch.setenv("RNA_ALGOS_DEBUG", "nans")
    try:
        TR.AlignEngine(device="cpu")
        assert TD.nan_checks_enabled()
    finally:
        TD.disable_nan_checks()


def test_on_cuda():
    assert not TP.on_cuda(torch.zeros(2))
    assert not TP.on_cuda("cpu")
    assert not TP.on_cuda(torch.device("cpu"))
    assert TP.on_cuda("cuda:0") and TP.on_cuda(torch.device("cuda"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            TP.resolve_device("cuda")
    assert TP.resolve_device("cpu") == torch.device("cpu")


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with TT.device_trace(str(log_dir)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.loads((log_dir / files[0]).read_text())
    assert trace["traceEvents"]
