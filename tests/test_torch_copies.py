"""The port's own copies of the JAX package's framework-free modules
(``constants``, ``params`` with ``contralign``, ``utils.io``, ``utils.output``,
``utils.checkpoint``) against the originals: tables bitwise, parsed
records and formatted text identical."""

import numpy as np
import pytest

from rna_algos_tpu import constants as JCONST
from rna_algos_tpu.params import build_align_scores as j_align
from rna_algos_tpu.params import build_fold_score_sets as j_fss
from rna_algos_tpu.params import contralign as JCA
from rna_algos_tpu.params import turner as JT
from rna_algos_tpu.utils import checkpoint as JCK
from rna_algos_tpu.utils import io as JIO
from rna_algos_tpu.utils import output as JOUT

from rna_algos_tpu_torch import constants as TCONST
from rna_algos_tpu_torch.params import build_align_scores as t_align
from rna_algos_tpu_torch.params import build_fold_score_sets as t_fss
from rna_algos_tpu_torch.params import contralign as TCA
from rna_algos_tpu_torch.params import turner as TT
from rna_algos_tpu_torch.utils import checkpoint as TCK
from rna_algos_tpu_torch.utils import io as TIO
from rna_algos_tpu_torch.utils import output as TOUT

from .conftest import REPO_ROOT

FASTA = REPO_ROOT / "assets" / "sampled_trnas.fa"


def _assert_bitwise(want, got):
    want, got = np.atleast_1d(want), np.atleast_1d(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    assert want.tobytes() == got.tobytes()


def test_constants_identical():
    names = [k for k in vars(JCONST) if k.isupper()]
    assert names
    for k in names:
        assert getattr(TCONST, k) == getattr(JCONST, k), k


TABLES = {
    "contrafold": (j_fss, t_fss),
    "turner": (JT.active_tables, TT.active_tables),
    "contralign": (j_align, t_align),
}


@pytest.mark.parametrize("which", sorted(TABLES))
def test_tables_bitwise(which):
    want, got = (build() for build in TABLES[which])
    assert sorted(want) == sorted(got)
    if which == "contralign":
        assert TCA.CONTRALIGN_PARAMS_RNA == JCA.CONTRALIGN_PARAMS_RNA
    for k in want:
        _assert_bitwise(want[k], got[k])


def test_read_fasta_identical():
    want = JIO.read_fasta(FASTA)
    got = TIO.read_fasta(FASTA)
    assert len(got) == len(want) == 6
    for w, g in zip(want, got):
        assert g.fasta_id == w.fasta_id
        _assert_bitwise(w.seq, g.seq)


PAIRS = [[], [(0, 9)], [(0, 12), (1, 11), (3, 8)], [(2, 80), (5, 60)]]


@pytest.mark.parametrize("pairs", PAIRS, ids=lambda p: f"{len(p)}pairs")
def test_fold_str_identical(pairs):
    n = 1 + max([j for _, j in pairs], default=9)
    s = TOUT.fold_str(pairs, n)
    assert s == JOUT.fold_str(pairs, n)
    assert TOUT.pairs_from_fold_str(s) == JOUT.pairs_from_fold_str(s)


def test_probs_text_identical():
    rng = np.random.default_rng(5)
    iv = rng.integers(0, 500, 64)
    jv = iv + rng.integers(4, 500, 64)
    pv = np.concatenate([
        rng.random(56, dtype=np.float32),
        np.float32([1.0, 0.5, 1e-7, 3.0517578e-05, 0.99999315, 1e-30,
                    0.1, 2.5e-4]),
    ])
    for p in pv:
        assert TOUT._fmt(p) == JOUT._fmt(p)
    items = list(zip(iv, jv, pv))
    assert TOUT.probs2str(items) == JOUT.probs2str(items)
    assert TOUT.probs2str_arrays(iv, jv, pv) == JOUT.probs2str_arrays(iv, jv, pv)


def test_checkpoint_keys_identical(tmp_path):
    seq = [0, 1, 2, 3, 2, 1]
    for contra in (False, True):
        assert TCK.fold_key(seq, contra) == JCK.fold_key(seq, contra)
    store = TCK.BppStore(str(tmp_path))
    bpp = np.eye(3, dtype=np.float32)
    store.put("k", bpp, bpp > 0)
    got = JCK.BppStore(str(tmp_path)).get("k")
    np.testing.assert_array_equal(got[0], bpp)
