"""McCaskill at N = 512, 1024 and 2048: the span-chunked tier of
``rna_algos_tpu.ops.pallas_fold_prob`` (``mccaskill_contra_pallas_prob``,
``mccaskill_turner_pallas_prob`` and their N > 256 run bodies), kernels K8
and K9 (CONTRA inside and outside) and K12 and K13 (Turner).

The TPU streamed the score tables through VMEM in R-row chunks and kept
the DP state resident; none of that carries over.  The maths is that of
the stacked tier (``pallas_fold_prob8``) at any N: the same merged tables,
the same outside auxiliaries, the same plain versions (K1's, K2's, K4's and
K5's) and the same sources (``csrc/contra_inside.cu`` etc.).  K8, K9, K12
and K13 run a cluster of C blocks per sequence (``csrc/cluster.cuh``; C
from the batch, N and the card, ``contra_cluster_sizes`` and
``turner_cluster_sizes``) and compute live cells only: a cell with
i + d >= n stays 0.  The long wrappers launch them through
``pallas_fold_prob8``'s helpers and count their own launches.

Two things differ from the stacked tier around the kernels, both as in the
JAX package: past N = 512 the first run's ln_sigma is seeded per sequence
by a run over a 512- (N = 1024) or 1024-nt (N = 2048) prefix
(``_estimate_ls0``), and the retry walk of lanes past 512 nt starts at the
band half-width (``pallas_fold_prob._retrying``).
"""

from . import _build
from . import pallas_fold_prob as PP
from . import pallas_fold_prob8 as P8

# N > 256 tiers, as the JAX package's ``pallas_available``: Turner's N =
# 2048 tier is not there (the JAX package runs it through the XLA scan).
LONG_TIERS_CONTRA = (512, 1024, 2048)
LONG_TIERS_TURNER = (512, 1024)

contra_inside_long_launches = _build.LaunchCounter("contra_inside_long")
contra_outside_long_launches = _build.LaunchCounter("contra_outside_long")
turner_inside_long_launches = _build.LaunchCounter("turner_inside_long")
turner_outside_long_launches = _build.LaunchCounter("turner_outside_long")

# The plain versions: the stacked tier's cores compute the same function at
# any N.
contra_inside_long_plain = P8.contra_inside_plain
contra_outside_long_plain = P8.contra_outside_plain
turner_inside_long_plain = P8.turner_inside_plain
turner_outside_long_plain = P8.turner_outside_plain


def long_tiers(contra):
    return LONG_TIERS_CONTRA if contra else LONG_TIERS_TURNER


def _check_n(name, N, contra):
    if N not in long_tiers(contra):
        raise ValueError(f"{name}: N = {N} is not a long tier "
                         f"{long_tiers(contra)}")


def contra_cluster_sizes(B, N):
    """(K8's, K9's) cluster size, the blocks a sequence runs on, for a
    launch over B sequences at N on the current CUDA device."""
    lib = _build.library().lib
    return (lib.rna_contra_inside_cluster(B, N),
            lib.rna_contra_outside_cluster(B, N))


def turner_cluster_sizes(B, N):
    """(K12's, K13's) cluster size, the blocks a sequence runs on, for a
    launch over B sequences at N on the current CUDA device."""
    lib = _build.library().lib
    return (lib.rna_turner_inside_cluster(B, N),
            lib.rna_turner_outside_cluster(B, N))


def contra_inside_long(mi, KW, scal, ns):
    """Kernel K8 (``csrc/contra_inside.cu``) for CUDA tensors, its
    plain version for CPU tensors.  Arguments as ``contra_inside`` (K1),
    at N = 512, 1024 or 2048."""
    dev = mi["H"].device
    if dev.type == "cpu":
        return contra_inside_long_plain(mi, KW, scal, ns)
    if dev.type != "cuda":
        raise ValueError(f"contra_inside_long: no kernel for device {dev}")
    _check_n("contra_inside_long", mi["H"].shape[1], True)
    out = P8._contra_inside_cuda(mi, KW, scal, ns)
    contra_inside_long_launches.add()
    return out


def contra_outside_long(mo, one, QONE, extR, b0lo, KW, scal, ns, min_span):
    """Kernel K9 (``csrc/contra_outside.cu``) for CUDA tensors, its
    plain version for CPU tensors.  Arguments as ``contra_outside`` (K2),
    at N = 512, 1024 or 2048."""
    dev = one.device
    if dev.type == "cpu":
        return contra_outside_long_plain(
            mo, one, QONE, extR, b0lo, KW, scal, ns, min_span
        )
    if dev.type != "cuda":
        raise ValueError(f"contra_outside_long: no kernel for device {dev}")
    _check_n("contra_outside_long", one.shape[1], True)
    bppo = P8._contra_outside_cuda(mo, one, QONE, extR, b0lo, KW, scal, ns,
                                   min_span)
    contra_outside_long_launches.add()
    return bppo


def turner_inside_long(mi, KT, scal, ns):
    """Kernel K12 (``csrc/turner_inside.cu``) for CUDA tensors, its
    plain version for CPU tensors.  Arguments as ``turner_inside`` (K4),
    at N = 512 or 1024."""
    dev = mi["H"].device
    if dev.type == "cpu":
        return turner_inside_long_plain(mi, KT, scal, ns)
    if dev.type != "cuda":
        raise ValueError(f"turner_inside_long: no kernel for device {dev}")
    _check_n("turner_inside_long", mi["H"].shape[1], False)
    out = P8._turner_inside_cuda(mi, KT, scal, ns)
    turner_inside_long_launches.add()
    return out


def turner_outside_long(mo, one, QONE, extR, KT, scal, ns, min_span):
    """Kernel K13 (``csrc/turner_outside.cu``) for CUDA tensors, its
    plain version for CPU tensors.  Arguments as ``turner_outside`` (K5),
    at N = 512 or 1024."""
    dev = one.device
    if dev.type == "cpu":
        return turner_outside_long_plain(mo, one, QONE, extR, KT, scal, ns,
                                         min_span)
    if dev.type != "cuda":
        raise ValueError(f"turner_outside_long: no kernel for device {dev}")
    _check_n("turner_outside_long", one.shape[1], False)
    bppo = P8._turner_outside_cuda(mo, one, QONE, extR, KT, scal, ns,
                                   min_span)
    turner_outside_long_launches.add()
    return bppo


# ---------------------------------------------------------------------------
# Fixed-scale runs, the prefix seed and the retry loop
# ---------------------------------------------------------------------------

def _contra_run_body(seqs, ns, ct, ln_sigma, N, allows_short_hairpins):
    """Fixed-``ln_sigma`` CONTRA inside (K8) + outside (K9)."""
    return P8._prob8_run_body(seqs, ns, ct, ln_sigma, N,
                              allows_short_hairpins,
                              inside=contra_inside_long,
                              outside=contra_outside_long)


def _turner_run_body(seqs, ns, tt, ln_sigma, N):
    """Fixed-``ln_sigma`` Turner inside (K12) + outside (K13)."""
    return P8._turner_prob8_run_body(seqs, ns, tt, ln_sigma, N,
                                     inside=turner_inside_long,
                                     outside=turner_outside_long)


def _prefix_seed(run_body, seqs, ns, N, base, drift):
    """ln_sigma seed of an N > 512 batch from one run over its first NP
    bases (NP = 512 for N = 1024, 1024 for N = 2048); None at N = 512."""
    if N <= 512:
        return None
    NP = 512 if N <= 1024 else 1024
    ns_small = ns.clamp(max=NP)
    prefix = seqs[:, :NP].contiguous()
    return PP._estimate_ls0(lambda ls: run_body(prefix, ns_small, ls, NP),
                            ns_small, base, drift=drift)


def mccaskill_contra_pallas_prob(seqs, ns, ct, N, allows_short_hairpins=False):
    """Scaled-probability CONTRA McCaskill at a long tier N with rescale
    retries (``mccaskill_contra_pallas_prob``).  ``seqs`` (B, N) int64 and
    ``ns`` (B,) int32 on the device that runs it.  Returns (bppo [d, i],
    ln_sigma per sequence)."""
    _check_n("mccaskill_contra_pallas_prob", N, True)

    def body(s, n, ls, NN):
        return _contra_run_body(s, n, ct, ls, NN, allows_short_hairpins)

    ls0 = _prefix_seed(body, seqs, ns, N, PP.LN_SIGMA0, PP.LS_PREFIX_DRIFT)
    return PP._retrying(lambda ls: body(seqs, ns, ls, N), ns, ls0=ls0)


def mccaskill_turner_pallas_prob(seqs, ns, tt, N):
    """Scaled-probability Turner McCaskill at a long tier N with rescale
    retries seeded at LN_SIGMA0_TURNER (``mccaskill_turner_pallas_prob``).
    Returns (bppo [d, i], ln_sigma per sequence)."""
    _check_n("mccaskill_turner_pallas_prob", N, False)

    def body(s, n, ls, NN):
        return _turner_run_body(s, n, tt, ls, NN)

    ls0 = _prefix_seed(body, seqs, ns, N, PP.LN_SIGMA0_TURNER,
                       PP.LS_PREFIX_DRIFT_TURNER)
    if ls0 is None:
        ls0 = PP.LN_SIGMA0_TURNER
    return PP._retrying(lambda ls: body(seqs, ns, ls, N), ns, ls0=ls0)
