"""The plain reference: it agrees with the program's plain CPU path at small
N for both models' BPPs, with the repository's float64 goldens, and the
program's centroid structures reach its best expected accuracy; its
bfloat16 control does not agree."""

import pathlib

import numpy as np
import pytest
import torch

import bench_cases
from benchlib import check, spec as spec_lib
from benchlib.program import Program
from reference import centroid as RC, mccaskill as R

torch.set_num_threads(2)
MODELS = {"contrafold_surrogate": "contra", "turner2004": "turner"}
GOLDEN = bench_cases.ROOT / "tests" / "golden" / "longn_f64.npz"
# float32 BPPs of the program against the float64 reference at n <= 64
# (measured 9.2e-7 / 4.1e-7, contra / turner)
TOL_PLAIN = 1e-5


def _params(name):
    return spec_lib.load_params(spec_lib._json(
        bench_cases.BENCH_DIR / "configs" / f"{name}.json"))


def _padded(seqs):
    N = max(len(s) for s in seqs)
    x = torch.full((len(seqs), N), R.PSEUDO_BASE, dtype=torch.int64)
    for k, s in enumerate(seqs):
        x[k, :len(s)] = torch.as_tensor(s)
    return x, torch.tensor([len(s) for s in seqs])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_reference_agrees_with_the_programs_plain_path(name):
    params = _params(name)
    cfg = spec_lib._json(bench_cases.BENCH_DIR / "configs" / f"{name}.json")
    rng = np.random.default_rng(17)
    seqs = [rng.integers(0, 4, size=n).astype(np.int8) for n in (9, 33, 64)]
    prog, _ = Program(cfg, params, "cpu").call(seqs)
    tb = R.tables(params, MODELS[name], "cpu", torch.float64)
    refs = check.reference_bpps(seqs, tb, MODELS[name], "cpu")
    got = check.bpp_numbers(prog, refs)["bpp_gap"]
    assert got < TOL_PLAIN
    low = R.tables(params, MODELS[name], "cpu", torch.bfloat16)
    ctl = check.reference_bpps(seqs, low, MODELS[name], "cpu")
    ctl_gap = check.bpp_numbers([(b, b > 0) for b in ctl], refs)["bpp_gap"]
    assert ctl_gap > 100 * TOL_PLAIN


@pytest.mark.skipif(not GOLDEN.exists(), reason="no float64 golden")
@pytest.mark.parametrize("name", sorted(MODELS))
def test_reference_agrees_with_the_float64_golden(name):
    z = np.load(GOLDEN)
    seq = z["seq_245"].astype(np.int64)
    model = MODELS[name]
    tb = R.tables(_params(name), model, "cpu", torch.float64)
    x, ns = _padded([seq])
    got = R.bpp(x, ns, tb, model)[0].numpy()
    want = np.triu(z[f"bpp_245_{model}"])
    # measured 1.4e-12 (contra), 4.6e-8 (turner); without the 2-loop
    # length cap a + b <= 30 the Turner gap is 6.6e-4
    assert np.abs(got - want).max() < 1e-6


def test_programs_structures_reach_the_reference_best():
    spec = bench_cases.tiny_spec("contrafold_surrogate.centroid_trna")
    gammas = spec["traffic"]["gammas"]
    from benchlib import traffic as T

    seqs = T.pool(spec["traffic"], 5, 1)[0]
    prog = Program(spec["config"], spec["params"], "cpu")
    results, structures = prog.call(seqs, gammas)
    tb = R.tables(spec["params"], "contra", "cpu", torch.float64)
    refs = check.reference_bpps(seqs, tb, "contra", "cpu")
    got = check.centroid_numbers(structures, refs, gammas, "cpu")
    assert got["centroid_gap"] < 1e-9
    # the reference's own traceback reaches its best score
    N = max(len(r) for r in refs)
    padded = np.zeros((len(refs), N, N))
    for k, r in enumerate(refs):
        padded[k, :len(r), :len(r)] = r
    t = torch.as_tensor(padded)
    best = RC.best_scores(t, [len(r) for r in refs], gammas)
    own = RC.structures(t, [len(r) for r in refs], gammas)
    for k, r in enumerate(refs):
        for g, gamma in enumerate(gammas):
            pl = RC.pairs(own[k][g], len(r))
            assert pl is not None
            assert RC.score(pl, r, gamma) == pytest.approx(best[k, g],
                                                           abs=1e-9)


def test_dot_bracket_parser_refuses_what_is_no_structure():
    assert RC.pairs("((..))", 6) == [(1, 4), (0, 5)]
    for bad in ("((..)", "(..))", "((..))", "((.x))"):
        assert RC.pairs(bad, 5 if bad != "((.x))" else 6) is None
    assert RC.pairs(")(", 2) is None


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in pathlib.Path(R.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in (
                    "rna_algos_tpu_torch", "rna_algos_tpu", "jax",
                    "benchlib"), (path.name, name)
