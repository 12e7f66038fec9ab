"""Shared cases of the generic-N scan tests (``tests/test_torch_scan_*``):
seeded batches, the JAX scan run under a given numerics mode, and the
comparisons with their stated tolerances.

Against the jitted JAX scan: the -inf pattern of bppo identical, finite
log values within RTOL_LOG * max(1, |x|), BPPs within TOL_BPP_JIT and
presence equal.  Jitted XLA on the CPU fuses the cubics' multiply-adds
and the port does not; eager JAX does not either, and there the plain
scan is bitwise equal (``test_torch_scan_eager.py``).  The jitted scan
itself sits up to 2.9e-5 from the eager one in BPP at N = 64-160
(measured), hence TOL_BPP_JIT.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rna_algos_tpu import numerics as JN
from rna_algos_tpu.constants import PSEUDO_BASE
from rna_algos_tpu.models import mccaskill as JM
from rna_algos_tpu.ops import scores as JS
from rna_algos_tpu.params import build_fold_score_sets

from rna_algos_tpu_torch.models import mccaskill as TM
from rna_algos_tpu_torch.ops import fold_scan as FS
from rna_algos_tpu_torch.weights import contra_tables, turner_tables

FSS = build_fold_score_sets()
RTOL_LOG = 1e-4
TOL_BPP_JIT = 5e-5
MODES = ("exact", "parity", "fast")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain scan runs thousands of small torch ops; with several test
    workers on the machine, torch's thread pools would oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def single_torch_thread():
    """One torch thread for one test that runs the plain scan (the same
    reason as ``one_torch_thread``) in a module whose other tests keep the
    default."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def scan_batch(N, B, seed):
    """Sequence 0 fills the bucket, the others are shorter."""
    rng = np.random.default_rng(seed)
    ns = np.array([N] + [int(rng.integers(N // 2, N)) for _ in range(B - 1)],
                  np.int32)
    seqs = np.full((B, N), PSEUDO_BASE, np.int32)
    for k, n in enumerate(ns):
        seqs[k, :n] = rng.integers(0, 4, n)
    return seqs, ns


def tables(contra):
    if contra:
        return JS.contra_table_pytree(FSS), contra_tables(FSS, "cpu")
    return JS.turner_table_pytree(), turner_tables("cpu")


def jax_bppo(seqs, ns, jt, N, contra, ash, mode, jit=True):
    """(B, N, N) [b, i, d] log outside x inside weights and the inside
    tables of the JAX scan (``_mccaskill_bpp_body``'s steps), traced under
    ``mode``: jitted, or eagerly op by op with ``jit=False``."""
    def run(s, n):
        with JN.force_mode(mode):
            def one(seq, nn):
                pre = (JS.precompute_contra if contra
                       else JS.precompute_turner)(seq, nn, N, jt)
                ins = JM._inside(seq, nn, N, jt, pre, contra, ash)
                out = JM._outside(seq, nn, N, jt, pre, ins, contra, ash)
                return out, {k: ins[k] for k in ("P_close", "P_ext",
                                                  "P_one", "P_mb")}
            return jax.vmap(one)(s, n)

    args = (jnp.asarray(seqs), jnp.asarray(ns))
    if jit:
        bppo, ins = jax.jit(run)(*args)
    else:
        with jax.disable_jit():
            bppo, ins = run(*args)
    return np.asarray(bppo), {k: np.asarray(v) for k, v in ins.items()}


def jax_bpp(seqs, ns, jt, N, contra, ash, mode):
    """The JAX package's ``mccaskill_bpp_batch`` under ``mode``."""
    with JN.force_mode(mode):
        bpp, presence = JM.mccaskill_bpp_batch(
            jnp.asarray(seqs), jnp.asarray(ns), jt, N=N, contra=contra,
            allows_short_hairpins=ash)
    return np.asarray(bpp), np.asarray(presence)


def port_scan(seqs, ns, tt, N, contra, ash, mode):
    """The port's plain generic path: (bppo, inside state, bpp, presence)."""
    ts = torch.as_tensor(seqs, dtype=torch.int64)
    tn = torch.as_tensor(ns)
    pre = TM._precompute(ts, tn, tt, N, contra)
    ins = FS.scan_inside(ts, tn, tt, pre, contra, ash, mode)
    out = FS.scan_outside(ts, tn, tt, pre, ins, contra, ash, mode)
    bpp, presence = TM._scan_finish(out["bppo"], tn, N, mode)
    return out["bppo"].numpy(), ins, bpp.numpy(), presence.numpy()


def live(ns, N):
    r = np.arange(N)
    return (r[:, None] + r[None, :])[None] < np.asarray(ns)[:, None, None]


def assert_log_close(got, want, mask, label):
    """-inf pattern identical on ``mask``, finite cells within RTOL_LOG *
    max(1, |want|); returns the largest difference."""
    got, want = got[mask], want[mask]
    assert not np.isnan(got).any(), label
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=f"{label}: -inf pattern")
    fin = np.isfinite(want)
    err = np.abs(got[fin] - want[fin])
    if err.size:
        assert (err <= RTOL_LOG * np.maximum(1.0, np.abs(want[fin]))).all(), (
            label, float(err.max()))
    return float(err.max()) if err.size else 0.0


def check_against_jax(N, B, seed, contra, mode, ash=False):
    """The plain generic path against the jitted JAX scan (module
    docstring); returns (max log difference, max BPP difference)."""
    jt, tt = tables(contra)
    seqs, ns = scan_batch(N, B, seed)
    bppo, _ins, bpp, presence = port_scan(seqs, ns, tt, N, contra, ash, mode)
    jbppo, _ = jax_bppo(seqs, ns, jt, N, contra, ash, mode)
    jbpp, jpresence = jax_bpp(seqs, ns, jt, N, contra, ash, mode)
    # bppo: the whole table (the dead cells are -inf in both)
    np.testing.assert_array_equal(np.isfinite(bppo), np.isfinite(jbppo))
    e_log = assert_log_close(bppo, jbppo, np.ones_like(bppo, bool), "bppo")
    e_bpp = float(np.abs(bpp - jbpp).max())
    assert e_bpp <= TOL_BPP_JIT, e_bpp
    np.testing.assert_array_equal(presence, jpresence)
    return e_log, e_bpp
