"""Host preparation of the CONTRA kernels (``rna_algos_tpu.ops.pallas_fold``).

Only the table assembly the probability-space slice uses is ported:
``contra_pq_tables``, ``_contra_len_di``, ``_skew_qone`` and
``contra_outside_aux``.  The log-space kernels of that module belong to the
parity tier and are not ported yet (ROADMAP).  Everything takes a leading
batch dimension.
"""

import torch

from . import scores as S
from .lut import sep_lookup as SEP

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
