"""Host preparation of the kernels (``rna_algos_tpu.ops.pallas_fold``).

Only the table assembly the probability-space slices use is ported:
``contra_pq_tables``, ``_contra_len_di``, ``turner_precompute_di``,
``_turner_len_di``, ``_skew_qone`` and ``contra_outside_aux``.  The
log-space kernels of that module belong to the parity tier and are not
ported yet (ROADMAP).  Everything takes a leading batch dimension.
"""

import numpy as np
import torch

from ..constants import (
    MAX_HAIRPIN_LEN_EXTRAPOLATION,
    MAX_LOOP_LEN,
    MIN_HAIRPIN_LEN,
    MIN_HAIRPIN_LEN_EXTRAPOLATION,
    NEG_INF,
)

from . import scores as S
from .diag import shift_pq
from .lut import sep_lookup as SEP
from .pallas_skew import skew_pq_batch

W = 31    # 2-loop window extent (MAX_LOOP_LEN + 1)
W2 = 32   # window rows (the extra row is a zero pad)


def contra_pq_tables(seqs, ns, ct, N):
    """[p, q]-layout log score tables: (pq dict of (B, N, N), vb0_m1,
    vb0_x1 (B, N)).  ``seqs`` (B, N) int64, ``ns`` (B,) int."""
    hc = ct["helix_close_scores"]
    tm = ct["terminal_mismatch_scores"]
    dl = ct["dangling_scores_left"]
    dr = ct["dangling_scores_right"]
    bp = ct["basepair_scores"]
    stk = ct["stack_scores"]
    b0x1 = ct["bulge_scores_0x1"]
    i1x1 = ct["interior_scores_1x1"]
    device = seqs.device
    zero = torch.zeros((), device=device)

    pvec = torch.arange(N, device=device)
    x0 = seqs
    x1 = S.sget(seqs, pvec + 1)
    m1 = S.sget(seqs, pvec - 1)
    qv = pvec[None, None, :]
    pv = pvec[None, :, None]
    n = ns.to(device).view(-1, 1, 1)

    JSpq = SEP(hc, (x0,), (x0,)) + SEP(
        tm, (x0, x1), (x0, m1), perm=(0, 2, 1, 3)
    )
    JSrevpq = SEP(hc, (x0,), (x0,), perm=(1, 0)) + SEP(
        tm, (x0, m1), (x0, x1), perm=(1, 3, 0, 2)
    )
    BPpq = SEP(bp, (x0,), (x0,))
    MBCpq = (
        ct["multibranch_score_base"]
        + ct["multibranch_score_basepair"]
        + SEP(hc, (x0,), (x0,))
        + SEP(dl, (x0, x1), (x0,), perm=(0, 2, 1))
        + SEP(dr, (x0,), (x0, m1))
    )
    ACCpq = (
        SEP(hc, (x0,), (x0,), perm=(1, 0))
        + torch.where(
            qv < n - 1, SEP(dl, (x0,), (x0, x1), perm=(1, 0, 2)), zero
        )
        + torch.where(pv > 0, SEP(dr, (x0, m1), (x0,), perm=(1, 2, 0)), zero)
        + BPpq
    )
    canon_pq = SEP(S.canon_mat(device), (x0,), (x0,)) * (qv < n)
    vb0_m1 = b0x1[m1]
    vb0_x1 = b0x1[x1]
    pq = {
        "JS": JSpq,
        "MBC": MBCpq,
        "ACC": ACCpq,
        "CANON": canon_pq,
        "JB": JSrevpq + BPpq,
        "STK": SEP(stk, (x0, x1), (x0, m1), perm=(0, 2, 1, 3))
        + SEP(bp, (x1,), (m1,)),
        "I11": SEP(i1x1, (x1,), (m1,)),
        "B0R": torch.broadcast_to(vb0_m1[:, None, :], (seqs.shape[0], N, N)),
    }
    return pq, vb0_m1, vb0_x1


def _contra_len_di(ct):
    """(W2, W) [b, a] log length/feature constants of the 2-loop body; row
    b = W is a zero pad."""
    bulge, interior = S._contra_len_consts(ct)  # [a, b]
    ab = torch.arange(W, device=bulge.device)
    a, b = ab[:, None], ab[None, :]
    body = torch.where((a == 0) | (b == 0), bulge, interior)
    return torch.cat([body.T, torch.zeros((1, W), device=bulge.device)], dim=0)


def turner_precompute_di(seqs, ns, tt, N):
    """(B, N, N) [d, i] log-space Turner score tables of both kernels.

    As in the JAX package: the position-separable [p, q] lookups, one K3
    skew of all 18 of them, then the [d, i] assembly (hairpin cases with
    the special-hairpin override, the AU/GU terms, and each small-loop raw
    table used twice: minus the inner-pair aug for the inside, translated
    by its (span, lane) offset minus the outer-pair aug for the outside)."""
    stk = tt["stack"]
    i1 = tt["int_1x1"]
    i2 = tt["int_1x2"]
    i4 = tt["int_2x2"]
    b1 = tt["bulge_init"][1]
    dev = seqs.device
    zero = torch.zeros((), device=dev)

    pvec = torch.arange(N, device=dev)
    x0 = seqs
    x1, x2, x3 = (S.sget(seqs, pvec + k) for k in (1, 2, 3))
    m1, m2, m3 = (S.sget(seqs, pvec - k) for k in (1, 2, 3))
    qv = pvec[None, None, :]
    pv = pvec[None, :, None]
    n = ns.to(dev).view(-1, 1, 1)

    augu_pq = SEP(S.augu_mat(dev), (x0,), (x0,)) * tt["augu_penalty"]
    MBCpq = (
        tt["init_multibranch_base"]
        + SEP(tt["tm_multibranch"], (x0, x1), (x0, m1), perm=(1, 3, 0, 2))
        + augu_pq
    )
    c_tm = SEP(tt["tm_multibranch"], (x0, m1), (x0, x1), perm=(0, 2, 1, 3))
    c_d5 = SEP(tt["dangle5"], (x0, m1), (x0,), perm=(0, 2, 1))
    c_d3 = SEP(tt["dangle3"], (x0,), (x0, x1))
    has_l = pv > 0
    has_r = qv < n - 1
    ACCpq = (
        torch.where(
            has_l & has_r,
            c_tm,
            torch.where(has_l, c_d5, torch.where(has_r, c_d3, zero)),
        )
        + augu_pq
    )
    canon_pq = SEP(S.canon_mat(dev), (x0,), (x0,)) * (qv < n)

    def tm_o(f):
        return SEP(tt[f], (x0, x1), (x0, m1), perm=(0, 2, 1, 3))

    def tm_i(f):
        return SEP(tt[f], (x0, m1), (x0, x1), perm=(1, 3, 0, 2))

    pq = {
        "AUG": augu_pq,
        "TMH": tm_o("tm_hairpin"),
        "MBC": MBCpq,
        "ACC": ACCpq,
        "CANON": canon_pq,
        "TMo1": tm_o("tm_interior"),
        "TMo2": tm_o("tm_1xmany"),
        "TMo3": tm_o("tm_2x3"),
        "TMi1": tm_i("tm_interior"),
        "TMi2": tm_i("tm_1xmany"),
        "TMi3": tm_i("tm_2x3"),
        "STK": SEP(stk, (x0, x1), (x0, m1), perm=(0, 2, 1, 3)),
        "B01": b1 + SEP(stk, (x0, x1), (x0, m2), perm=(0, 2, 1, 3)),
        "B10": b1 + SEP(stk, (x0, x2), (x0, m1), perm=(0, 2, 1, 3)),
        "I11": SEP(i1, (x0, x1, x2), (x0, m1, m2), perm=(0, 2, 4, 1, 3, 5)),
        "I12": SEP(i2, (x0, x1, x2), (x0, m1, m2, m3),
                   perm=(0, 2, 5, 1, 3, 4, 6)),
        "I21": SEP(i2, (x3, x2, x1, x0), (m2, m1, x0),
                   perm=(1, 3, 4, 6, 0, 2, 5)),
        "I22": SEP(i4, (x0, x1, x2, x3), (x0, m1, m2, m3),
                   perm=(0, 2, 4, 6, 1, 3, 5, 7)),
    }
    names = sorted(pq)
    skewed = skew_pq_batch([pq[k].contiguous() for k in names])
    sk = {k: v.transpose(1, 2) for k, v in zip(names, skewed)}  # [d, i]
    aug_di = sk["AUG"]

    # hairpin; hlen = d - 1 along the span axis
    hlen = torch.arange(N, device=dev)[:, None] - 1
    hp = tt["hairpin_init"]
    init_in = hp[hlen.clamp(0, MAX_HAIRPIN_LEN_EXTRAPOLATION)]
    extrap = hp[MIN_HAIRPIN_LEN_EXTRAPOLATION - 1] + tt[
        "coeff_hairpin_extrap"
    ] * torch.log(
        hlen.clamp(min=1).to(torch.float32)
        / np.float32(MIN_HAIRPIN_LEN_EXTRAPOLATION - 1)
    )
    init = torch.where(hlen <= MAX_HAIRPIN_LEN_EXTRAPOLATION, init_in, extrap)
    generic = torch.where(
        hlen == MIN_HAIRPIN_LEN,
        hp[hlen.clamp(0, MAX_LOOP_LEN)],
        init + sk["TMH"],
    ) + aug_di
    H_sp_di = S.special_hairpin_id(seqs, tt, N).transpose(1, 2)
    out = {
        "H": torch.where(torch.isfinite(H_sp_di), H_sp_di, generic),
        "MBC": sk["MBC"],
        "ACC": sk["ACC"],
        "CANON": torch.where(
            sk["CANON"] > 0.5, zero, torch.full((), NEG_INF, device=dev)
        ),
        "AUGT": aug_di,
    }
    for k in ("TMo1", "TMo2", "TMo3", "TMi1", "TMi2", "TMi3"):
        out[k] = sk[k]
    # small-loop raw tables: name -> (a+b+2 span offset, a+1 lane offset)
    raw_off = {
        "STK": (2, 1), "B01": (3, 1), "B10": (3, 2), "I11": (4, 2),
        "I12": (5, 2), "I21": (5, 3), "I22": (6, 3),
    }
    in_name = {"STK": "STKT", "I11": "I11T", "I12": "I12T", "I21": "I21T",
               "I22": "I22T"}
    for key, (p, l) in raw_off.items():
        raw = sk[key]
        out[in_name.get(key, key)] = raw - shift_pq(aug_di, -p, l)
        out[key + "O"] = shift_pq(raw, p, -l) - shift_pq(aug_di, p, -l)
    return {k: v.contiguous() for k, v in out.items()}


def _turner_len_di(tt):
    """(W2, W) [b, a] log Turner 2-loop constants (bulge init, interior
    init + Ninio); row b = W is a zero pad."""
    init_int, init_bulge, ninio = S._turner_len_consts(tt)  # [a, b]
    pad = torch.zeros((1, W), device=init_int.device)
    return (
        torch.cat([init_bulge.T, pad], dim=0),
        torch.cat([(init_int + ninio).T, pad], dim=0),
    )


def _skew_qone(one_di, N):
    """QONE[.., t, l] = one(l-t+1, l-1) = one_di[.., t-2, l+1-t] for t >= 2
    and l >= t-1, else 0."""
    device = one_di.device
    t = torch.arange(N, device=device)[:, None]
    l = torch.arange(N, device=device)[None, :]
    ok = (t >= 2) & (l >= t - 1)
    rows = (t - 2).clamp(min=0).expand(N, N)
    cols = (l + 1 - t).clamp(0, N - 1)
    vals = one_di[..., rows, cols]
    return torch.where(ok, vals, torch.zeros((), device=device))


def contra_outside_aux(ns, ext_di, one_di, N):
    """Outside-kernel inputs derived from the inside outputs, in scaled
    probability space (empty-ensemble fill 0, unit fill 1).

    Returns (QONE (B, N, N), extL (B, N) = ext(0, i-1), extR (B, 2N) =
    ext(p, n-1) padded with ones, glob (B,) = ext(0, n-1)).  Unlike the TPU
    version, nothing is pre-rotated by 2N - n: the outside kernel indexes
    ``one`` and ``extR`` at j + 1 directly."""
    device = ext_di.device
    B = ext_di.shape[0]
    ones = torch.ones((B, 1), device=device)
    extL = ext_di[:, :, 0]                              # ext(0, p)
    extL_sh = torch.cat([ones, extL[:, :-1]], dim=1)    # ext(0, i-1)
    pvec = torch.arange(N, device=device)[None, :]
    n = ns.to(device).view(-1, 1)
    rows = (n - 1 - pvec).clamp(0, N - 1)
    vals = torch.gather(ext_di, 1, rows[:, None, :].expand(B, 1, N))[:, 0]
    extR = torch.where(pvec <= n - 1, vals, torch.ones((), device=device))
    extR_pad = torch.cat([extR, torch.ones((B, N), device=device)], dim=1)
    return _skew_qone(one_di, N), extL_sh, extR_pad, extR[:, 0]
