"""Score tables of the fold (``rna_algos_tpu.ops.scores``).

``sget``, the canonical-pair and AU/GU matrices, the CONTRA and Turner
2-loop length terms and the Turner special-hairpin lookup;
``contra_table_pytree`` and ``turner_table_pytree`` are
``weights.contra_tables`` and ``weights.turner_tables``.  The per-sequence
score assembly of the generic-N scan, batched over a leading dimension:
``canonical_matrix``, ``precompute_turner`` / ``precompute_contra`` (the
(B, N, N) left-layout tables M[b, i, d] = score(i, i + d)) and the per-span
2-loop tensors ``twoloop_{inside,outside}_{turner,contra}``.
"""

import functools

import numpy as np
import torch

from ..constants import (
    A,
    G,
    U,
    CANONICAL_PAIRS,
    MAX_2LOOP_LEN,
    MAX_INTERIOR_ASYMMETRIC,
    MAX_INTERIOR_EXPLICIT,
    MAX_INTERIOR_SYMMETRIC,
    MAX_HAIRPIN_LEN_EXTRAPOLATION,
    MAX_LOOP_LEN,
    MIN_HAIRPIN_LEN,
    MIN_HAIRPIN_LEN_EXTRAPOLATION,
    NEG_INF,
    NUM_BASES_PAD,
    PSEUDO_BASE,
)


def canon_mat(device):
    """(5, 5) float32 canonical-pair indicator (``scores.CANON_MAT``)."""
    m = torch.zeros((NUM_BASES_PAD, NUM_BASES_PAD), dtype=torch.float32)
    for a, b in CANONICAL_PAIRS:
        m[a, b] = 1.0
    return m.to(device)


def augu_mat(device):
    """(5, 5) float32 AU/GU closing-pair indicator (``scores.AUGU_MAT``)."""
    m = torch.zeros((NUM_BASES_PAD, NUM_BASES_PAD), dtype=torch.float32)
    for a, b in ((A, U), (U, A), (G, U), (U, G)):
        m[a, b] = 1.0
    return m.to(device)


def sget(seq, idx):
    """Bases of ``seq`` (..., L) at positions ``idx`` (broadcastable to
    (..., K)), with ``jnp.take(mode="fill", fill_value=PSEUDO_BASE)``
    semantics: an index in [-L, 0) counts from the end, as in NumPy, and
    any index outside [-L, L) reads PSEUDO_BASE.  So on a full-length
    sequence position -1 reads the last base, not the fill; the tables
    only use that value in cells no pair reaches, and it is kept so the
    tables stay bitwise equal to the JAX package's."""
    L = seq.shape[-1]
    valid = (idx >= -L) & (idx < L)
    safe = torch.where(idx < 0, idx + L, idx).clamp(0, L - 1)
    safe = torch.broadcast_to(safe, seq.shape[:-1] + safe.shape[-1:])
    got = torch.gather(seq, -1, safe)
    return torch.where(valid, got, torch.full_like(got, PSEUDO_BASE))


def _contra_len_consts(ct):
    """(31, 31) [a, b] length/feature terms of the CONTRA 2-loop
    (``scores._contra_len_consts``): (bulge, interior)."""
    device = ct["bulge_scores_len_cumulative"].device
    ab = torch.arange(MAX_LOOP_LEN + 1, device=device)
    a, b = ab[:, None], ab[None, :]
    m = a + b
    bulge = ct["bulge_scores_len_cumulative"][(m - 1).clamp(0, MAX_LOOP_LEN - 1)]
    sym = ct["interior_scores_symmetric_cumulative"][
        (a - 1).clamp(0, MAX_INTERIOR_SYMMETRIC - 1)
    ]
    asym = ct["interior_scores_asymmetric_cumulative"][
        ((a - b).abs() - 1).clamp(0, MAX_INTERIOR_ASYMMETRIC - 1)
    ]
    in_explicit = (
        (a >= 1) & (a <= MAX_INTERIOR_EXPLICIT)
        & (b >= 1) & (b <= MAX_INTERIOR_EXPLICIT)
    )
    explicit = torch.where(
        in_explicit,
        ct["interior_scores_explicit"][
            (a - 1).clamp(0, MAX_INTERIOR_EXPLICIT - 1),
            (b - 1).clamp(0, MAX_INTERIOR_EXPLICIT - 1),
        ],
        torch.zeros((), device=device),
    )
    interior = (
        ct["interior_scores_len_cumulative"][(m - 2).clamp(0, MAX_LOOP_LEN - 2)]
        + torch.where(a == b, sym, asym)
        + explicit
    )
    return bulge, interior


def special_hairpin_id(seqs, tt, N):
    """(B, N, N) [i, d] special-hairpin score of [i, i+d] (closing pair
    included), NEG_INF where no special sequence matches
    (``scores.special_hairpin_id`` for a batch).

    A special sequence of length L only lands at d = L - 1, so the
    (N, N, S) select of the JAX version becomes one scatter-max of each
    special's score into its column; the lookup never syncs the host."""
    sp_seqs = tt["special_seqs"]          # (S, Lmax), -1 padded
    sp_lens = tt["special_lens"]          # (S,)
    sp_scores = tt["special_scores"]      # (S,)
    Lmax = sp_seqs.shape[1]
    dev = seqs.device
    B = seqs.shape[0]
    offs = torch.arange(Lmax, device=dev)
    idx = (torch.arange(N, device=dev)[:, None] + offs[None, :]).reshape(-1)
    win = sget(seqs, idx).view(B, N, Lmax)
    ok = (win[:, :, None, :] == sp_seqs[None, None]) | (
        offs[None, None, None, :] >= sp_lens[None, None, :, None]
    )
    match = ok.all(dim=-1)                                    # (B, N, S)
    neg = torch.full((), NEG_INF, device=dev)
    fits = (sp_lens >= 1) & (sp_lens <= N)
    sp_at = torch.where(match & fits, sp_scores[None, None, :], neg)  # (B, N, S)
    col = (sp_lens - 1).clamp(0, N - 1).expand(B, N, -1)
    out = torch.full((B, N, N), NEG_INF, device=dev)
    return out.scatter_reduce_(2, col, sp_at, reduce="amax")


def _turner_len_consts(tt):
    """(31, 31) [a, b] Turner 2-loop terms (``scores._turner_len_consts``):
    (interior init, bulge init, Ninio asymmetry)."""
    device = tt["interior_init"].device
    ab = torch.arange(MAX_LOOP_LEN + 1, device=device)
    a, b = ab[:, None], ab[None, :]
    m = a + b
    init_int = tt["interior_init"][m.clamp(0, MAX_2LOOP_LEN)]
    init_bulge = tt["bulge_init"][m.clamp(1, MAX_2LOOP_LEN)]
    ninio = torch.maximum(
        tt["ninio_coeff"] * (a - b).abs().to(torch.float32), tt["ninio_max"]
    )
    return init_int, init_bulge, ninio


# ---------------------------------------------------------------------------
# Per-sequence score assembly of the generic-N scan: (B, N, N) left-layout
# tables M[b, i, d] = score(i, i + d), and the per-span 2-loop tensors
# ---------------------------------------------------------------------------

WINDOW = MAX_LOOP_LEN + 1   # 2-loop loop lengths 0..30 on each side


def _at(seqs, idx):
    """(B, N, N) bases of ``seqs`` (B, N) at the (N, N) positions ``idx``
    (``sget`` semantics)."""
    B, N = seqs.shape
    return sget(seqs, idx.expand(N, N).reshape(-1)).view(B, N, N)


def canonical_matrix(seqs, ns, N):
    """canon[b, i, d] = is_canonical(seq[i], seq[i+d]) and i + d < n."""
    dev = seqs.device
    i = torch.arange(N, device=dev)[:, None]
    j = i + torch.arange(N, device=dev)[None, :]
    xi, xj = _at(seqs, i), _at(seqs, j)
    n = ns.to(dev).long().view(-1, 1, 1)
    return (canon_mat(dev)[xi, xj] > 0.5) & (j[None] < n)


def precompute_turner(seqs, ns, N, tt):
    """The (B, N, N) left-layout Turner tables of one batch
    (``scores.precompute_turner``): hairpin H (special hairpins included),
    multibranch close MBC, accessible ACC, the AU/GU term AUGU, the outer
    and inner terminal mismatches of the three interior families (TMo_*,
    TMi_*) and the canonical mask."""
    dev = seqs.device
    i = torch.arange(N, device=dev)[:, None]
    dd = torch.arange(N, device=dev)[None, :]
    j = i + dd
    xi, xj = _at(seqs, i), _at(seqs, j)
    s_i1, s_j1 = _at(seqs, i + 1), _at(seqs, j - 1)
    s_im1, s_jp1 = _at(seqs, i - 1), _at(seqs, j + 1)
    n = ns.to(dev).long().view(-1, 1, 1)
    zero = torch.zeros((), device=dev)
    augu = augu_mat(dev)[xi, xj] * tt["augu_penalty"]

    hp = tt["hairpin_init"]
    hlen = dd - 1
    init_in = hp[hlen.clamp(0, MAX_HAIRPIN_LEN_EXTRAPOLATION)]
    extrap = hp[MIN_HAIRPIN_LEN_EXTRAPOLATION - 1] + tt[
        "coeff_hairpin_extrap"
    ] * torch.log(
        hlen.clamp(min=1).to(torch.float32)
        / np.float32(MIN_HAIRPIN_LEN_EXTRAPOLATION - 1)
    )
    init = torch.where(hlen <= MAX_HAIRPIN_LEN_EXTRAPOLATION, init_in, extrap)
    tm = tt["tm_hairpin"][xi, xj, s_i1, s_j1]
    generic = torch.where(
        hlen == MIN_HAIRPIN_LEN, hp[hlen.clamp(0, MAX_LOOP_LEN)], init + tm
    ) + augu
    H_sp = special_hairpin_id(seqs, tt, N)
    H = torch.where(torch.isfinite(H_sp), H_sp, generic)

    MBC = (tt["init_multibranch_base"]
           + tt["tm_multibranch"][xj, xi, s_j1, s_i1] + augu)
    c_tm = tt["tm_multibranch"][xi, xj, s_im1, s_jp1]
    c_d5 = tt["dangle5"][xi, xj, s_im1]
    c_d3 = tt["dangle3"][xi, xj, s_jp1]
    has_l = i > 0
    has_r = j[None] < n - 1
    ACC = torch.where(
        has_l & has_r, c_tm,
        torch.where(has_l, c_d5, torch.where(has_r, c_d3, zero)),
    ) + augu
    out = {"H": H, "MBC": MBC, "ACC": ACC, "AUGU": augu}
    for key, f in (("int", "tm_interior"), ("1xmany", "tm_1xmany"),
                   ("2x3", "tm_2x3")):
        out["TMo_" + key] = tt[f][xi, xj, s_i1, s_j1]
        out["TMi_" + key] = tt[f][xj, xi, s_jp1, s_im1]
    out["canon"] = canonical_matrix(seqs, ns, N)
    return {k: v.contiguous() for k, v in out.items()}


def precompute_contra(seqs, ns, N, ct):
    """The (B, N, N) left-layout CONTRAfold tables of one batch
    (``scores.precompute_contra``): the junction scores JS (pair (i, j))
    and JSrev (read at an inner pair), the base-pair score BP, JB = JSrev +
    BP, hairpin H, multibranch close MBC, accessible ACC and the canonical
    mask."""
    dev = seqs.device
    i = torch.arange(N, device=dev)[:, None]
    dd = torch.arange(N, device=dev)[None, :]
    j = i + dd
    xi, xj = _at(seqs, i), _at(seqs, j)
    s_i1, s_j1 = _at(seqs, i + 1), _at(seqs, j - 1)
    s_im1, s_jp1 = _at(seqs, i - 1), _at(seqs, j + 1)
    n = ns.to(dev).long().view(-1, 1, 1)
    zero = torch.zeros((), device=dev)
    hc = ct["helix_close_scores"]
    tm = ct["terminal_mismatch_scores"]
    dl = ct["dangling_scores_left"]
    dr = ct["dangling_scores_right"]
    bp = ct["basepair_scores"]

    JS = hc[xi, xj] + tm[xi, xj, s_i1, s_j1]
    JSrev = hc[xj, xi] + tm[xj, xi, s_jp1, s_im1]
    BP = bp[xi, xj]
    hlen = dd - 1
    H = torch.where(
        (hlen >= 0) & (hlen <= MAX_LOOP_LEN),
        ct["hairpin_scores_len_cumulative"][hlen.clamp(0, MAX_LOOP_LEN)] + JS,
        torch.full((), NEG_INF, device=dev),
    )
    MBC = (ct["multibranch_score_base"] + ct["multibranch_score_basepair"]
           + hc[xi, xj] + dl[xi, xj, s_i1] + dr[xi, xj, s_j1])
    ACC = (hc[xj, xi]
           + torch.where(j[None] < n - 1, dl[xj, xi, s_jp1], zero)
           + torch.where(i > 0, dr[xj, xi, s_im1], zero)
           + BP)
    out = {"H": H, "MBC": MBC, "ACC": ACC, "JS": JS, "JSrev": JSrev,
           "BP": BP, "JB": JSrev + BP,
           "canon": canonical_matrix(seqs, ns, N)}
    return {k: v.contiguous() for k, v in out.items()}


def _ab(device):
    ab = torch.arange(WINDOW, device=device)
    return ab[:, None], ab[None, :]


def _fam_select(vec_int, vec_1xmany, vec_2x3):
    """Per (a, b) [..., 31, 31] cell, the generic-interior mismatch family:
    1 x n loops, the 2 x 3 loops, every other interior loop."""
    a, b = _ab(vec_int.device)
    is_1 = (a == 1) | (b == 1)
    is_23 = ((a == 2) & (b == 3)) | ((a == 3) & (b == 2))
    return torch.where(is_1, vec_1xmany, torch.where(is_23, vec_2x3, vec_int))


def _lanes(seqs, N, lanes):
    """(b, i) index tensors of the lanes: every (B, N) lane when ``lanes``
    is None (the JAX functions' layout), else the given 1-D pair."""
    if lanes is not None:
        return lanes
    dev = seqs.device
    return (torch.arange(seqs.shape[0], device=dev)[:, None],
            torch.arange(N, device=dev)[None, :])


def _lane_base(seqs, b, p):
    """Base of sequence b at position p (``sget`` semantics), per lane."""
    L = seqs.shape[-1]
    valid = (p >= -L) & (p < L)
    safe = torch.where(p < 0, p + L, p).clamp(0, L - 1)
    return torch.where(valid, seqs[b, safe],
                       torch.full((), PSEUDO_BASE, dtype=seqs.dtype,
                                  device=seqs.device))


def _window(M, b, i, d, fill, inside):
    """W[..., a, b'] of the 2-loop window at lanes (b, i) of span d
    (``diag.window_gather``): M[b, i + 1 + a, d - 2 - (a + b')] for the
    inner pairs of the inside, M[b, i - 1 - a, d + 2 + a + b'] for the
    outer pairs of the outside; ``fill`` outside the table."""
    N = M.shape[-1]
    a, bb = _ab(M.device)
    i3 = i[..., None, None]
    if inside:
        rows, cols = i3 + 1 + a, d - 2 - (a + bb)
    else:
        rows, cols = i3 - 1 - a, d + 2 + a + bb
    ok = (rows >= 0) & (rows < N) & (cols >= 0) & (cols < N)
    vals = M[b[..., None, None], rows.clamp(0, N - 1), cols.clamp(0, N - 1)]
    return torch.where(ok, vals, torch.full((), fill, device=M.device))


def _pick(cases, default):
    """A where-chain: ``cases`` is (predicate, value) in order of
    precedence."""
    out = default
    for cond, val in reversed(cases):
        out = torch.where(cond, val, out)
    return out


def twoloop_inside_turner(seqs, tt, pre, d, N, lanes=None):
    """TL[..., a, b] = Turner 2-loop score, outer (i, i+d), inner
    (i+1+a, i+d-1-b) (``scores.twoloop_inside_turner``): (B, N, 31, 31),
    or (L, 31, 31) for ``lanes`` = (b, i) index tensors of length L."""
    b, i = _lanes(seqs, N, lanes)
    j = i + d
    g = functools.partial(_lane_base, seqs, b)
    xi, xj = g(i), g(j)
    s_i1, s_i2, s_i3 = g(i + 1), g(i + 2), g(i + 3)
    s_j1, s_j2, s_j3 = g(j - 1), g(j - 2), g(j - 3)
    stack = tt["stack"]
    e = (..., None, None)
    stack00 = stack[xi, xj, s_i1, s_j1][e]
    b01 = (tt["bulge_init"][1] + stack[xi, xj, s_i1, s_j2])[e]
    b10 = (tt["bulge_init"][1] + stack[xi, xj, s_i2, s_j1])[e]
    i11 = tt["int_1x1"][xi, xj, s_i1, s_j1, s_i2, s_j2][e]
    i12 = tt["int_1x2"][xi, xj, s_i1, s_j1, s_j2, s_i2, s_j3][e]
    i21 = tt["int_1x2"][s_j2, s_i3, s_j1, s_i2, s_i1, xj, xi][e]
    i22 = tt["int_2x2"][xi, xj, s_i1, s_j1, s_i2, s_j2, s_i3, s_j3][e]

    init_int, init_bulge, ninio = _turner_len_consts(tt)
    aug_out = pre["AUGU"][b, i, d][e]
    W_AUGU = _window(pre["AUGU"], b, i, d, 0.0, True)
    W_TMi = _fam_select(*(_window(pre["TMi_" + f], b, i, d, 0.0, True)
                          for f in ("int", "1xmany", "2x3")))
    TMo = _fam_select(*(pre["TMo_" + f][b, i, d][e]
                        for f in ("int", "1xmany", "2x3")))
    interior_gen = init_int + ninio + TMo + W_TMi + aug_out + W_AUGU
    bulge_gen = init_bulge + aug_out + W_AUGU
    return _turner_cases(stack00, b01, b10, bulge_gen, i11, i12, i21, i22,
                         interior_gen)


def _turner_cases(stack00, b01, b10, bulge_gen, i11, i12, i21, i22,
                  interior_gen):
    a, b = _ab(stack00.device)
    return _pick((
        ((a + b) == 0, stack00),
        ((a == 0) & (b == 1), b01),
        ((a == 1) & (b == 0), b10),
        ((a == 0) | (b == 0), bulge_gen),
        ((a == 1) & (b == 1), i11),
        ((a == 1) & (b == 2), i12),
        ((a == 2) & (b == 1), i21),
        ((a == 2) & (b == 2), i22),
    ), interior_gen)


def twoloop_outside_turner(seqs, tt, pre, d, N, lanes=None):
    """TL[..., a, b] = Turner 2-loop score, outer (i-1-a, i+d+1+b), inner
    (i, i+d) (``scores.twoloop_outside_turner``)."""
    b, i = _lanes(seqs, N, lanes)
    j = i + d
    g = functools.partial(_lane_base, seqs, b)
    xi, xj = g(i), g(j)
    s_im1, s_im2, s_im3 = g(i - 1), g(i - 2), g(i - 3)
    s_jp1, s_jp2, s_jp3 = g(j + 1), g(j + 2), g(j + 3)
    stack = tt["stack"]
    e = (..., None, None)
    stack00 = stack[s_im1, s_jp1, xi, xj][e]
    b01 = (tt["bulge_init"][1] + stack[s_im1, s_jp2, xi, xj])[e]
    b10 = (tt["bulge_init"][1] + stack[s_im2, s_jp1, xi, xj])[e]
    i11 = tt["int_1x1"][s_im2, s_jp2, s_im1, s_jp1, xi, xj][e]
    i12 = tt["int_1x2"][s_im2, s_jp3, s_im1, s_jp2, s_jp1, xi, xj][e]
    i21 = tt["int_1x2"][xj, xi, s_jp1, s_im1, s_im2, s_jp2, s_im3][e]
    i22 = tt["int_2x2"][s_im3, s_jp3, s_im2, s_jp2, s_im1, s_jp1, xi, xj][e]

    init_int, init_bulge, ninio = _turner_len_consts(tt)
    aug_in = pre["AUGU"][b, i, d][e]
    W_AUGU = _window(pre["AUGU"], b, i, d, 0.0, False)
    W_TMo = _fam_select(*(_window(pre["TMo_" + f], b, i, d, 0.0, False)
                          for f in ("int", "1xmany", "2x3")))
    TMi = _fam_select(*(pre["TMi_" + f][b, i, d][e]
                        for f in ("int", "1xmany", "2x3")))
    interior_gen = init_int + ninio + W_TMo + TMi + aug_in + W_AUGU
    bulge_gen = init_bulge + aug_in + W_AUGU
    return _turner_cases(stack00, b01, b10, bulge_gen, i11, i12, i21, i22,
                         interior_gen)


def _contra_body(ct, left, right, i1x1, device):
    """(bulge or interior) length/feature term of the CONTRA 2-loop per
    (a, b), with the 0x1 bulges (``left`` at a = 1, ``right`` at b = 1)
    and the 1x1 interior added."""
    a, b = _ab(device)
    m = a + b
    e = (..., None, None)
    zero = torch.zeros((), device=device)
    bulge_len, interior_len = _contra_len_consts(ct)
    bulge = bulge_len + torch.where(
        m == 1, torch.where(a == 1, left[e], right[e]), zero)
    interior = interior_len + torch.where((a == 1) & (b == 1), i1x1[e], zero)
    return torch.where((a == 0) | (b == 0), bulge, interior)


def twoloop_inside_contra(seqs, ct, pre, d, N, lanes=None):
    """TL[..., a, b] = CONTRA 2-loop score, outer (i, i+d), inner
    (i+1+a, i+d-1-b) (``scores.twoloop_inside_contra``)."""
    b, i = _lanes(seqs, N, lanes)
    j = i + d
    g = functools.partial(_lane_base, seqs, b)
    xi, xj = g(i), g(j)
    s_i1, s_j1 = g(i + 1), g(j - 1)
    e = (..., None, None)
    stack00 = (ct["stack_scores"][xi, xj, s_i1, s_j1]
               + ct["basepair_scores"][s_i1, s_j1])[e]
    b0x1 = ct["bulge_scores_0x1"]
    sel = _contra_body(ct, b0x1[s_i1], b0x1[s_j1],
                       ct["interior_scores_1x1"][s_i1, s_j1], seqs.device)
    body = sel + pre["JS"][b, i, d][e] + _window(pre["JB"], b, i, d, 0.0,
                                                 True)
    a, bb = _ab(seqs.device)
    return torch.where((a + bb) == 0, stack00, body)


def twoloop_outside_contra(seqs, ct, pre, d, N, lanes=None):
    """TL[..., a, b] = CONTRA 2-loop score, outer (i-1-a, i+d+1+b), inner
    (i, i+d) (``scores.twoloop_outside_contra``)."""
    b, i = _lanes(seqs, N, lanes)
    j = i + d
    g = functools.partial(_lane_base, seqs, b)
    xi, xj = g(i), g(j)
    s_im1, s_jp1 = g(i - 1), g(j + 1)
    e = (..., None, None)
    stack00 = (ct["stack_scores"][s_im1, s_jp1, xi, xj]
               + ct["basepair_scores"][xi, xj])[e]
    b0x1 = ct["bulge_scores_0x1"]
    sel = _contra_body(ct, b0x1[s_im1], b0x1[s_jp1],
                       ct["interior_scores_1x1"][s_im1, s_jp1], seqs.device)
    body = (sel + pre["JSrev"][b, i, d][e]
            + _window(pre["JS"], b, i, d, 0.0, False)
            + pre["BP"][b, i, d][e])
    a, bb = _ab(seqs.device)
    return torch.where((a + bb) == 0, stack00, body)
