"""The port's Durbin path end to end on the CPU: the weights carried
across, ``align_bucket`` and ``AlignEngine``, and the two CLIs, against
the JAX package and the C-baseline golden."""

import itertools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rna_algos_tpu.cli import generate_align_scores as j_gas
from rna_algos_tpu.ops import pallas_align_prob as JPAP
from rna_algos_tpu.params import contralign as JCA
from rna_algos_tpu.parallel.runner import pick_bucket as j_pick_bucket

from rna_algos_tpu_torch.cli import durbin as du_cli
from rna_algos_tpu_torch.cli import generate_align_scores as t_gas
from rna_algos_tpu_torch.constants import PSEUDO_BASE
from rna_algos_tpu_torch.parallel.runner import (AlignEngine, align_bucket,
                                                 pad_seqs)
from rna_algos_tpu_torch.params import contralign as TCA
from rna_algos_tpu_torch.utils.io import read_fasta
from rna_algos_tpu_torch.weights import align_tables

from .conftest import REPO_ROOT
from .scan_cases import single_torch_thread  # noqa: F401
from .test_reference_golden import _parse_triples
from .test_torch_durbin_kernels import jax_scores, random_pairs
from .test_torch_durbin_paths import _jax_prob_ls, port_prob_ls

FASTA = str(REPO_ROOT / "assets" / "sampled_trnas.fa")
GOLDEN = REPO_ROOT / "tests" / "golden" / "c_baseline" / "durbin.txt"
PARAMS = REPO_ROOT / "assets" / "contralign.params.rna"


def random_params_text(rng, scale=0.25):
    """A CONTRAlign parameter file with every feature the parser reads,
    each the published weight plus N(0, scale) noise."""
    lines = []
    for line in JCA.CONTRALIGN_PARAMS_RNA.splitlines():
        name, value = line.split()
        lines.append(f"{name} {float(value) + rng.normal(0.0, scale):.8f}")
    return "\n".join(lines) + "\n"


def test_align_tables_randomized_scores():
    """A randomized score dict: the tables carried across bitwise, and the
    port's probabilities (plain K14 path) those of the JAX kernel path on
    the same dict, with every pair's ln_sigma equal."""
    text = random_params_text(np.random.default_rng(21))
    sc = JCA.parse_contralign_params(text)
    at = align_tables(sc, "cpu")
    assert sorted(at) == sorted(sc)
    for k, v in sc.items():
        assert at[k].dtype == torch.float32
        assert at[k].numpy().tobytes() == np.asarray(v, np.float32).tobytes()
    assert (at["match_scores"][4] == 0).all() and at["insert_scores"][4] == 0
    pairs = random_pairs(np.random.default_rng(22), 6, 32, same=1)
    got, ls, _ = port_prob_ls(*pairs, sc, 32)
    want, ls_j = _jax_prob_ls(*pairs, sc, 32)
    np.testing.assert_array_equal(ls, ls_j)
    assert np.abs(got - want).max() <= 1e-6


def test_align_bucket_matches_jax_rule():
    """The JAX runner's two rules for lengths 3..600: its TPU rule (one
    square power of two >= 64 over the larger pick_bucket) wherever that
    square is a wavefront bucket (<= 256), else the key it gives its row
    scan, (pick_bucket(n1), pick_bucket(n2))."""
    for n1 in range(3, 601):
        for n2 in (3, n1 // 2 + 3, n1, 64, 129, 257, 300, 513, 600):
            n = max(j_pick_bucket(n1), j_pick_bucket(n2))
            N = 64
            while N < n:
                N *= 2
            want = ((N, N) if N <= 256
                    else (j_pick_bucket(n1), j_pick_bucket(n2)))
            assert align_bucket(n1, n2) == want, (n1, n2)


def test_dispatch_by_numerics(monkeypatch):
    """exact and fast run K14 (the same probabilities), parity K15 (within
    the 5e-4 golden budget of them), K15's fast instance as close; a
    bucket that is not a square power of two <= 256 runs the row scan
    (K22) in every mode."""
    from rna_algos_tpu_torch.models import durbin as TD
    from rna_algos_tpu_torch.ops import pairhmm_rows as PR
    from rna_algos_tpu_torch.ops import pallas_align as PA

    s1, n1, s2, n2 = (torch.as_tensor(x) for x in random_pairs(
        np.random.default_rng(51), 4, 64, 20, 60))
    at = align_tables(JCA.build_align_scores(), "cpu")
    got = {m: TD.durbin_match_probs_batch_auto(s1, n1, s2, n2, at, 64, 64,
                                               numerics=m)
           for m in ("exact", "fast", "parity")}
    assert torch.equal(got["exact"], got["fast"])
    assert float((got["exact"] - got["parity"]).abs().max()) < 5e-4
    fast15 = PA.durbin_match_probs_batch_pallas(s1, n1, s2, n2, at, 64,
                                                numerics="fast")
    assert float((fast15 - got["parity"]).abs().max()) < 5e-4
    calls = []
    rows = PR.pairhmm_rows

    def counted(*args):
        calls.append(args[7])
        return rows(*args)

    monkeypatch.setattr(PR, "pairhmm_rows", counted)
    wide = torch.full((4, 128), PSEUDO_BASE, dtype=torch.int32)
    wide[:, :64] = s2
    for m in ("exact", "fast", "parity"):
        calls.clear()
        rect = TD.durbin_match_probs_batch_auto(s1, n1, wide, n2, at, 64,
                                                128, numerics=m)
        assert calls == [False, True] and rect.shape == (4, 64, 128)
        assert (rect[:, :, 64:] == 0).all()
        # the row scan's box is the wavefront's within the golden budget
        assert float((rect[:, :, :64] - got[m]).abs().max()) < 5e-4
    with pytest.raises(ValueError):
        TD.durbin_match_probs_batch_auto(s1, n1, s2, n2, at, 64, 64,
                                         numerics="turbo")


def _wrapped(seqs):
    return [np.concatenate([[PSEUDO_BASE], s, [PSEUDO_BASE]]).astype(np.int32)
            for s in seqs]


def test_align_engine_crop_and_order(single_torch_thread):
    """Pairs of two buckets (64, 128) in mixed order, a reversed and a
    repeated pair: a dict keyed by pair, as the JAX engine returns, each
    result cropped to its pair's lengths and bitwise the pair's result
    alone; a 300-nt pair (the row scan at bucket (384, 384)) cropped too."""
    rng = np.random.default_rng(31)
    lens = (20, 100, 35, 58)
    seqs = _wrapped([rng.integers(0, 4, n) for n in lens])
    pairs = [(1, 2), (0, 2), (3, 1), (2, 3), (0, 2), (2, 0)]
    engine = AlignEngine(device="cpu")
    got = engine.match_probs_pairs(seqs, pairs)
    assert isinstance(got, dict) and list(got) == list(dict.fromkeys(pairs))
    for (a, b) in pairs:
        mat = got[(a, b)]
        assert mat.shape == (len(seqs[a]), len(seqs[b]))
        alone = engine.match_probs_pairs(seqs, [(a, b)])[(a, b)]
        np.testing.assert_array_equal(mat, alone)
    np.testing.assert_array_equal(got[(0, 2)].T.shape, got[(2, 0)].shape)
    assert np.isfinite(got[(1, 2)]).all() and got[(1, 2)].max() > 0.05
    # a 300-nt pair: bucket (384, 384), the row scan, cropped
    long = _wrapped([rng.integers(0, 4, 300), rng.integers(0, 4, 296)])
    mat = engine.match_probs_pairs(long, [(0, 1)])[(0, 1)]
    assert mat.shape == (302, 298) and np.isfinite(mat).all()
    assert (mat[0] == 0).all() and (mat[:, -1] == 0).all()
    assert mat.max() > 0.05 and (mat.sum(axis=1) < 1.001).all()


def _dense(triples, shape):
    m = np.zeros(shape, np.float32)
    for (i, j), p in triples.items():
        m[i, j] = p
    return m


def test_cli_exact_matches_jax_kernel(tmp_path):
    """``cli.durbin --device cpu`` (the plain K14 path) against the JAX
    probability kernel in interpret mode on the 15 tRNA pairs, <= 1e-5."""
    out = tmp_path / "durbin.txt"
    du_cli.main(["-i", FASTA, "-o", str(out), "--device", "cpu"])
    got = _parse_triples(out.read_text())
    recs = read_fasta(FASTA)
    wrapped = _wrapped([r.seq for r in recs])
    pairs = list(itertools.combinations(range(len(recs)), 2))
    assert list(got) == [f"{a},{b}" for a, b in pairs]
    N = 128
    s1 = jnp.asarray(pad_seqs([wrapped[a] for a, _ in pairs], N))
    s2 = jnp.asarray(pad_seqs([wrapped[b] for _, b in pairs], N))
    n1 = jnp.asarray([len(wrapped[a]) for a, _ in pairs], jnp.int32)
    n2 = jnp.asarray([len(wrapped[b]) for _, b in pairs], jnp.int32)
    want = np.asarray(JPAP.durbin_match_probs_batch_pallas_prob(
        s1, n1, s2, n2, jax_scores(JCA.build_align_scores()), N=N,
        interpret=True))
    worst = 0.0
    for k, (a, b) in enumerate(pairs):
        la, lb = len(recs[a].seq), len(recs[b].seq)
        dense = _dense(got[f"{a},{b}"], (la, lb))
        worst = max(worst, float(np.abs(
            dense - want[k, 1:la + 1, 1:lb + 1]).max()))
    assert worst <= 1e-5


def test_cli_parity_matches_c_baseline(tmp_path):
    """``--numerics parity`` (the plain K15 path) against the C-baseline
    golden: the same keys, <= 5e-4 (measured: byte-identical)."""
    out = tmp_path / "durbin.txt"
    du_cli.main(["-i", FASTA, "-o", str(out), "--device", "cpu",
                 "--numerics", "parity"])
    ref = _parse_triples(GOLDEN.read_text())
    got = _parse_triples(out.read_text())
    assert list(got) == list(ref)
    worst = 0.0
    for rid in ref:
        assert set(got[rid]) == set(ref[rid]), rid
        worst = max(worst, max(abs(p - got[rid][k])
                               for k, p in ref[rid].items()))
    assert worst <= 5e-4
    assert out.read_text() == GOLDEN.read_text()


def test_cli_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        du_cli.main(["-i", FASTA, "-o", str(tmp_path / "x.txt")])


@pytest.mark.parametrize("source", ["published", "randomized"])
def test_generate_align_scores_identical(tmp_path, source):
    """The port's codegen writes the JAX CLI's bytes, and its parser the
    JAX parser's tables."""
    src = PARAMS
    if source == "randomized":
        src = tmp_path / "params.txt"
        src.write_text(random_params_text(np.random.default_rng(41)))
    text = src.read_text()
    want, got = JCA.parse_contralign_params(text), TCA.parse_contralign_params(text)
    assert sorted(want) == sorted(got)
    for k in want:
        assert np.asarray(want[k]).tobytes() == np.asarray(got[k]).tobytes()
    j_gas.main(["-i", str(src), "-o", str(tmp_path / "j.py")])
    t_gas.main(["-i", str(src), "-o", str(tmp_path / "t.py")])
    assert (tmp_path / "t.py").read_bytes() == (tmp_path / "j.py").read_bytes()
