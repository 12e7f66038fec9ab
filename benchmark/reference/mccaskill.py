"""Plain McCaskill base-pair probabilities for the Turner 2004 and the
CONTRAfold models: the benchmark's reference of the fold.

A frozen copy of the generic-N scan's plain passes (the score assembly,
the 2-loop tensors, the inside and the outside pass over the spans, the
finish), kept here so that later changes of the program cannot move the
yardstick.  It imports nothing of the program.  The arithmetic is log space
with exact log-adds (``torch.logaddexp``, ``torch.logsumexp``) in the dtype
of the tables it is given: float64 for the reference, a lower precision for
the control.

``bpp(seqs, ns, tables, model)`` takes (B, N) int64 base codes padded with
PSEUDO_BASE, the true lengths and the tables of ``tables(params, model,
device, dtype)``, and returns (B, N, N) probabilities, upper triangle,
0 past each length.
"""

import functools

import numpy as np
import torch

A, C, G, U = 0, 1, 2, 3
NUM_BASES = 4
PSEUDO_BASE = 4
NUM_BASES_PAD = 5
CANONICAL_PAIRS = ((A, U), (C, G), (G, C), (G, U), (U, A), (U, G))
MIN_HAIRPIN_LEN = 3
MIN_SPAN_HAIRPIN_CLOSE = MIN_HAIRPIN_LEN + 2
MAX_LOOP_LEN = 30
MAX_2LOOP_LEN = 30
MAX_HAIRPIN_LEN_EXTRAPOLATION = 30
MIN_HAIRPIN_LEN_EXTRAPOLATION = 31
MAX_INTERIOR_SYMMETRIC = 15
MAX_INTERIOR_ASYMMETRIC = 28
MAX_INTERIOR_EXPLICIT = 4
NEG_INF = float("-inf")
W = MAX_LOOP_LEN + 1        # 2-loop loop lengths 0..30 on each side

MODELS = ("turner", "contra")

# params file name -> table key of the Turner model
TURNER_KEYS = {
    "stack": "STACK_SCORES",
    "hairpin_init": "HAIRPIN_SCORES_INIT",
    "bulge_init": "BULGE_SCORES_INIT",
    "interior_init": "INTERIOR_SCORES_INIT",
    "int_1x1": "INTERIOR_SCORES_1X1",
    "int_1x2": "INTERIOR_SCORES_1X2",
    "int_2x2": "INTERIOR_SCORES_2X2",
    "tm_hairpin": "TERMINAL_MISMATCH_SCORES_HAIRPIN",
    "tm_interior": "TERMINAL_MISMATCH_SCORES_INTERIOR",
    "tm_1xmany": "TERMINAL_MISMATCH_SCORES_1XMANY",
    "tm_2x3": "TERMINAL_MISMATCH_SCORES_2X3",
    "tm_multibranch": "TERMINAL_MISMATCH_SCORES_MULTIBRANCH",
    "dangle5": "DANGLING_SCORES_5PRIME",
    "dangle3": "DANGLING_SCORES_3PRIME",
    "special_seqs": "HAIRPIN_SPECIAL_SEQS",
    "special_lens": "HAIRPIN_SPECIAL_LENS",
    "special_scores": "HAIRPIN_SPECIAL_SCORES",
    "ninio_coeff": "NINIO_COEFF",
    "ninio_max": "NINIO_MAX",
    "augu_penalty": "HELIX_AUGU_END_PENALTY",
    "init_multibranch_base": "INIT_MULTIBRANCH_BASE",
    "coeff_num_branches": "COEFF_NUM_BRANCHES",
    "coeff_hairpin_extrap": "COEFF_HAIRPIN_LEN_EXTRAPOLATION",
}
TURNER_INT_KEYS = ("special_seqs", "special_lens")
ATLEAST_KEYS = ("hairpin_scores_len_atleast", "bulge_scores_len_atleast",
                "interior_scores_len_atleast",
                "interior_scores_symmetric_atleast",
                "interior_scores_asymmetric_atleast")
CONTRA_SCALARS = ("multibranch_score_base", "multibranch_score_basepair",
                  "multibranch_score_unpair", "external_score_basepair",
                  "external_score_unpair")


def _canonical(a, b):
    return (a, b) in CANONICAL_PAIRS


def contra_score_sets(raw):
    """The CONTRAfold score set from the raw weights (CONTRAfold's
    ``FoldScoreSets::new`` + ``transfer`` + ``accumulate``): the pair
    tables on canonical pairs only, the length arrays, and the cumulative
    sums of the five "at least" arrays."""
    f32 = np.float32
    out = {
        "stack_scores": np.zeros((5, 5, 5, 5), f32),
        "terminal_mismatch_scores": np.zeros((5, 5, 5, 5), f32),
        "dangling_scores_left": np.zeros((5, 5, 5), f32),
        "dangling_scores_right": np.zeros((5, 5, 5), f32),
        "helix_close_scores": np.zeros((5, 5), f32),
        "basepair_scores": np.zeros((5, 5), f32),
        "interior_scores_explicit": np.asarray(
            raw["interior_scores_explicit"], f32).copy(),
        "bulge_scores_0x1": np.asarray(raw["bulge_scores_0x1"], f32).copy(),
        "interior_scores_1x1": np.asarray(raw["interior_scores_1x1"],
                                          f32).copy(),
    }
    sizes = {"hairpin_scores_len_atleast": MAX_LOOP_LEN + 1,
             "bulge_scores_len_atleast": MAX_LOOP_LEN,
             "interior_scores_len_atleast": MAX_LOOP_LEN - 1,
             "interior_scores_symmetric_atleast": MAX_INTERIOR_SYMMETRIC,
             "interior_scores_asymmetric_atleast": MAX_INTERIOR_ASYMMETRIC}
    for key, size in sizes.items():
        v = np.zeros(size, f32)
        src = np.asarray(raw[key], f32)
        v[:min(size, len(src))] = src[:size]
        out[key] = v
    for a in range(NUM_BASES):
        for b in range(NUM_BASES):
            if not _canonical(a, b):
                continue
            for c in range(NUM_BASES):
                for d in range(NUM_BASES):
                    if _canonical(c, d):
                        out["stack_scores"][a, b, c, d] = \
                            raw["stack_scores"][a][b][c][d]
                    out["terminal_mismatch_scores"][a, b, c, d] = \
                        raw["terminal_mismatch_scores"][a][b][c][d]
                for x in range(NUM_BASES):
                    out["dangling_scores_left"][a, b, x] = \
                        raw["dangling_scores_left"][a][b][x]
                    out["dangling_scores_right"][a, b, x] = \
                        raw["dangling_scores_right"][a][b][x]
            out["helix_close_scores"][a, b] = raw["helix_close_scores"][a][b]
            out["basepair_scores"][a, b] = raw["basepair_scores"][a][b]
    for key in CONTRA_SCALARS:
        out[key] = f32(raw[key])
    for key in ATLEAST_KEYS:
        out[key.replace("_atleast", "_cumulative")] = np.cumsum(out[key],
                                                                dtype=f32)
    return out


def tables(params, model, device, dtype):
    """The model's tables as tensors on ``device``: float tables in
    ``dtype``, index tables int64.  ``params`` are the raw parameter arrays
    of the configuration's params file."""
    if model == "contra":
        fss = contra_score_sets(params)
        return {k: torch.as_tensor(np.asarray(v, np.float64), device=device
                                   ).to(dtype) for k, v in fss.items()}
    if model != "turner":
        raise ValueError(f"unknown model {model!r}")
    out = {}
    for key, name in TURNER_KEYS.items():
        v = np.asarray(params[name])
        if key in TURNER_INT_KEYS:
            out[key] = torch.as_tensor(v.astype(np.int64), device=device)
        else:
            out[key] = torch.as_tensor(v.astype(np.float64),
                                       device=device).to(dtype)
    return out


def _dtype(tbl):
    return next(v.dtype for v in tbl.values() if v.is_floating_point())


def _full(shape, value, like):
    return torch.full(shape, value, dtype=like.dtype, device=like.device)


def _pair_mat(pairs, dev, dtype):
    m = torch.zeros((NUM_BASES_PAD, NUM_BASES_PAD), dtype=dtype)
    for a, b in pairs:
        m[a, b] = 1.0
    return m.to(dev)


def sget(seq, idx):
    """Bases of ``seq`` (..., L) at ``idx``: an index in [-L, 0) counts from
    the end, any index outside [-L, L) reads PSEUDO_BASE."""
    L = seq.shape[-1]
    valid = (idx >= -L) & (idx < L)
    safe = torch.where(idx < 0, idx + L, idx).clamp(0, L - 1)
    safe = torch.broadcast_to(safe, seq.shape[:-1] + safe.shape[-1:])
    got = torch.gather(seq, -1, safe)
    return torch.where(valid, got, torch.full_like(got, PSEUDO_BASE))


def _at(seqs, idx):
    B, N = seqs.shape
    return sget(seqs, idx.expand(N, N).reshape(-1)).view(B, N, N)


def canonical_matrix(seqs, ns, N):
    """canon[b, i, d]: (i, i + d) is a canonical pair inside the sequence."""
    dev = seqs.device
    i = torch.arange(N, device=dev)[:, None]
    j = i + torch.arange(N, device=dev)[None, :]
    xi, xj = _at(seqs, i), _at(seqs, j)
    n = ns.to(dev).long().view(-1, 1, 1)
    canon = _pair_mat(CANONICAL_PAIRS, dev, torch.float32)
    return (canon[xi, xj] > 0.5) & (j[None] < n)


def special_hairpin(seqs, tt, N):
    """(B, N, N) [i, d] special-hairpin score of [i, i + d], -inf where
    no special sequence matches."""
    sp_seqs, sp_lens = tt["special_seqs"], tt["special_lens"]
    sp_scores = tt["special_scores"]
    Lmax = sp_seqs.shape[1]
    dev, B = seqs.device, seqs.shape[0]
    offs = torch.arange(Lmax, device=dev)
    idx = (torch.arange(N, device=dev)[:, None] + offs[None, :]).reshape(-1)
    win = sget(seqs, idx).view(B, N, Lmax)
    ok = (win[:, :, None, :] == sp_seqs[None, None]) | (
        offs[None, None, None, :] >= sp_lens[None, None, :, None])
    match = ok.all(dim=-1)
    fits = (sp_lens >= 1) & (sp_lens <= N)
    sp_at = torch.where(match & fits, sp_scores[None, None, :],
                        _full((), NEG_INF, sp_scores))
    col = (sp_lens - 1).clamp(0, N - 1).expand(B, N, -1)
    out = _full((B, N, N), NEG_INF, sp_scores)
    return out.scatter_reduce_(2, col, sp_at, reduce="amax")


def _turner_len_consts(tt):
    dev, dt = tt["interior_init"].device, tt["interior_init"].dtype
    ab = torch.arange(W, device=dev)
    a, b = ab[:, None], ab[None, :]
    m = a + b
    init_int = tt["interior_init"][m.clamp(0, MAX_2LOOP_LEN)]
    init_bulge = tt["bulge_init"][m.clamp(1, MAX_2LOOP_LEN)]
    ninio = torch.maximum(tt["ninio_coeff"] * (a - b).abs().to(dt),
                          tt["ninio_max"])
    return init_int, init_bulge, ninio


def _contra_len_consts(ct):
    dev = ct["bulge_scores_len_cumulative"].device
    ab = torch.arange(W, device=dev)
    a, b = ab[:, None], ab[None, :]
    m = a + b
    bulge = ct["bulge_scores_len_cumulative"][
        (m - 1).clamp(0, MAX_LOOP_LEN - 1)]
    sym = ct["interior_scores_symmetric_cumulative"][
        (a - 1).clamp(0, MAX_INTERIOR_SYMMETRIC - 1)]
    asym = ct["interior_scores_asymmetric_cumulative"][
        ((a - b).abs() - 1).clamp(0, MAX_INTERIOR_ASYMMETRIC - 1)]
    in_explicit = ((a >= 1) & (a <= MAX_INTERIOR_EXPLICIT)
                   & (b >= 1) & (b <= MAX_INTERIOR_EXPLICIT))
    explicit = torch.where(
        in_explicit,
        ct["interior_scores_explicit"][
            (a - 1).clamp(0, MAX_INTERIOR_EXPLICIT - 1),
            (b - 1).clamp(0, MAX_INTERIOR_EXPLICIT - 1)],
        _full((), 0.0, bulge))
    interior = (ct["interior_scores_len_cumulative"][
        (m - 2).clamp(0, MAX_LOOP_LEN - 2)]
        + torch.where(a == b, sym, asym) + explicit)
    return bulge, interior


def precompute_turner(seqs, ns, N, tt):
    """(B, N, N) left-layout Turner tables M[b, i, d] = score(i, i + d):
    hairpin H (special hairpins included), multibranch close MBC,
    accessible ACC, the AU/GU term AUGU, the terminal mismatches of the
    three interior families (outer TMo_*, inner TMi_*), the canonical
    mask."""
    dev, dt = seqs.device, _dtype(tt)
    i = torch.arange(N, device=dev)[:, None]
    dd = torch.arange(N, device=dev)[None, :]
    j = i + dd
    xi, xj = _at(seqs, i), _at(seqs, j)
    s_i1, s_j1 = _at(seqs, i + 1), _at(seqs, j - 1)
    s_im1, s_jp1 = _at(seqs, i - 1), _at(seqs, j + 1)
    n = ns.to(dev).long().view(-1, 1, 1)
    zero = torch.zeros((), dtype=dt, device=dev)
    augu_pairs = ((A, U), (U, A), (G, U), (U, G))
    augu = _pair_mat(augu_pairs, dev, dt)[xi, xj] * tt["augu_penalty"]

    hp = tt["hairpin_init"]
    hlen = dd - 1
    init_in = hp[hlen.clamp(0, MAX_HAIRPIN_LEN_EXTRAPOLATION)]
    extrap = hp[MIN_HAIRPIN_LEN_EXTRAPOLATION - 1] + tt[
        "coeff_hairpin_extrap"] * torch.log(
        hlen.clamp(min=1).to(dt) / (MIN_HAIRPIN_LEN_EXTRAPOLATION - 1))
    init = torch.where(hlen <= MAX_HAIRPIN_LEN_EXTRAPOLATION, init_in, extrap)
    tm = tt["tm_hairpin"][xi, xj, s_i1, s_j1]
    generic = torch.where(hlen == MIN_HAIRPIN_LEN,
                          hp[hlen.clamp(0, MAX_LOOP_LEN)], init + tm) + augu
    H_sp = special_hairpin(seqs, tt, N)
    H = torch.where(torch.isfinite(H_sp), H_sp, generic)

    MBC = (tt["init_multibranch_base"]
           + tt["tm_multibranch"][xj, xi, s_j1, s_i1] + augu)
    c_tm = tt["tm_multibranch"][xi, xj, s_im1, s_jp1]
    c_d5 = tt["dangle5"][xi, xj, s_im1]
    c_d3 = tt["dangle3"][xi, xj, s_jp1]
    has_l = i > 0
    has_r = j[None] < n - 1
    ACC = torch.where(has_l & has_r, c_tm,
                      torch.where(has_l, c_d5,
                                  torch.where(has_r, c_d3, zero))) + augu
    out = {"H": H, "MBC": MBC, "ACC": ACC, "AUGU": augu}
    for key, f in (("int", "tm_interior"), ("1xmany", "tm_1xmany"),
                   ("2x3", "tm_2x3")):
        out["TMo_" + key] = tt[f][xi, xj, s_i1, s_j1]
        out["TMi_" + key] = tt[f][xj, xi, s_jp1, s_im1]
    out["canon"] = canonical_matrix(seqs, ns, N)
    return {k: v.contiguous() for k, v in out.items()}


def precompute_contra(seqs, ns, N, ct):
    """(B, N, N) left-layout CONTRAfold tables: the junction scores JS
    (pair (i, j)) and JSrev (read at an inner pair), the base-pair score BP,
    JB = JSrev + BP, hairpin H, multibranch close MBC, accessible ACC, the
    canonical mask."""
    dev, dt = seqs.device, _dtype(ct)
    i = torch.arange(N, device=dev)[:, None]
    dd = torch.arange(N, device=dev)[None, :]
    j = i + dd
    xi, xj = _at(seqs, i), _at(seqs, j)
    s_i1, s_j1 = _at(seqs, i + 1), _at(seqs, j - 1)
    s_im1, s_jp1 = _at(seqs, i - 1), _at(seqs, j + 1)
    n = ns.to(dev).long().view(-1, 1, 1)
    zero = torch.zeros((), dtype=dt, device=dev)
    hc = ct["helix_close_scores"]
    tm = ct["terminal_mismatch_scores"]
    dl = ct["dangling_scores_left"]
    dr = ct["dangling_scores_right"]
    bp = ct["basepair_scores"]

    JS = hc[xi, xj] + tm[xi, xj, s_i1, s_j1]
    JSrev = hc[xj, xi] + tm[xj, xi, s_jp1, s_im1]
    BP = bp[xi, xj]
    hlen = dd - 1
    H = torch.where((hlen >= 0) & (hlen <= MAX_LOOP_LEN),
                    ct["hairpin_scores_len_cumulative"][
                        hlen.clamp(0, MAX_LOOP_LEN)] + JS,
                    torch.full((), NEG_INF, dtype=dt, device=dev))
    MBC = (ct["multibranch_score_base"] + ct["multibranch_score_basepair"]
           + hc[xi, xj] + dl[xi, xj, s_i1] + dr[xi, xj, s_j1])
    ACC = (hc[xj, xi]
           + torch.where(j[None] < n - 1, dl[xj, xi, s_jp1], zero)
           + torch.where(i > 0, dr[xj, xi, s_im1], zero) + BP)
    out = {"H": H, "MBC": MBC, "ACC": ACC, "JS": JS, "JSrev": JSrev,
           "BP": BP, "JB": JSrev + BP,
           "canon": canonical_matrix(seqs, ns, N)}
    return {k: v.contiguous() for k, v in out.items()}


def _ab(device):
    ab = torch.arange(W, device=device)
    return ab[:, None], ab[None, :]


def _fam_select(vec_int, vec_1xmany, vec_2x3):
    """Per (a, b) cell the interior mismatch family: 1 x n loops, 2 x 3
    loops, every other interior loop."""
    a, b = _ab(vec_int.device)
    is_1 = (a == 1) | (b == 1)
    is_23 = ((a == 2) & (b == 3)) | ((a == 3) & (b == 2))
    return torch.where(is_1, vec_1xmany, torch.where(is_23, vec_2x3,
                                                     vec_int))


def _lane_base(seqs, b, p):
    L = seqs.shape[-1]
    valid = (p >= -L) & (p < L)
    safe = torch.where(p < 0, p + L, p).clamp(0, L - 1)
    return torch.where(valid, seqs[b, safe],
                       torch.full((), PSEUDO_BASE, dtype=seqs.dtype,
                                  device=seqs.device))


def _window(M, b, i, d, fill, inside):
    """The 2-loop window at lanes (b, i) of span d: M[b, i + 1 + a,
    d - 2 - (a + b')] (the inner pairs, inside) or M[b, i - 1 - a,
    d + 2 + a + b'] (the outer pairs, outside); ``fill`` off the table."""
    N = M.shape[-1]
    a, bb = _ab(M.device)
    i3 = i[..., None, None]
    if inside:
        rows, cols = i3 + 1 + a, d - 2 - (a + bb)
    else:
        rows, cols = i3 - 1 - a, d + 2 + a + bb
    ok = (rows >= 0) & (rows < N) & (cols >= 0) & (cols < N)
    vals = M[b[..., None, None], rows.clamp(0, N - 1), cols.clamp(0, N - 1)]
    return torch.where(ok, vals, _full((), fill, vals))


def _pick(cases, default):
    out = default
    for cond, val in reversed(cases):
        out = torch.where(cond, val, out)
    return out


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


def twoloop_inside_turner(seqs, tt, pre, d, lanes):
    """TL[L, a, b]: Turner 2-loop score, outer (i, i + d), inner
    (i + 1 + a, i + d - 1 - b), at lanes (b, i)."""
    b, i = lanes
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


def twoloop_outside_turner(seqs, tt, pre, d, lanes):
    """TL[L, a, b]: Turner 2-loop score, outer (i - 1 - a, i + d + 1 + b),
    inner (i, i + d)."""
    b, i = lanes
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


def _contra_body(ct, left, right, i1x1):
    a, b = _ab(left.device)
    m = a + b
    e = (..., None, None)
    zero = _full((), 0.0, left)
    bulge_len, interior_len = _contra_len_consts(ct)
    bulge = bulge_len + torch.where(
        m == 1, torch.where(a == 1, left[e], right[e]), zero)
    interior = interior_len + torch.where((a == 1) & (b == 1), i1x1[e], zero)
    return torch.where((a == 0) | (b == 0), bulge, interior)


def twoloop_inside_contra(seqs, ct, pre, d, lanes):
    """TL[L, a, b]: CONTRAfold 2-loop score, outer (i, i + d), inner
    (i + 1 + a, i + d - 1 - b)."""
    b, i = lanes
    j = i + d
    g = functools.partial(_lane_base, seqs, b)
    xi, xj = g(i), g(j)
    s_i1, s_j1 = g(i + 1), g(j - 1)
    e = (..., None, None)
    stack00 = (ct["stack_scores"][xi, xj, s_i1, s_j1]
               + ct["basepair_scores"][s_i1, s_j1])[e]
    b0x1 = ct["bulge_scores_0x1"]
    sel = _contra_body(ct, b0x1[s_i1], b0x1[s_j1],
                       ct["interior_scores_1x1"][s_i1, s_j1])
    body = sel + pre["JS"][b, i, d][e] + _window(pre["JB"], b, i, d, 0.0,
                                                 True)
    a, bb = _ab(seqs.device)
    return torch.where((a + bb) == 0, stack00, body)


def twoloop_outside_contra(seqs, ct, pre, d, lanes):
    """TL[L, a, b]: CONTRAfold 2-loop score, outer (i - 1 - a,
    i + d + 1 + b), inner (i, i + d)."""
    b, i = lanes
    j = i + d
    g = functools.partial(_lane_base, seqs, b)
    xi, xj = g(i), g(j)
    s_im1, s_jp1 = g(i - 1), g(j + 1)
    e = (..., None, None)
    stack00 = (ct["stack_scores"][s_im1, s_jp1, xi, xj]
               + ct["basepair_scores"][xi, xj])[e]
    b0x1 = ct["bulge_scores_0x1"]
    sel = _contra_body(ct, b0x1[s_im1], b0x1[s_jp1],
                       ct["interior_scores_1x1"][s_im1, s_jp1])
    body = (sel + pre["JSrev"][b, i, d][e]
            + _window(pre["JS"], b, i, d, 0.0, False)
            + pre["BP"][b, i, d][e])
    a, bb = _ab(seqs.device)
    return torch.where((a + bb) == 0, stack00, body)


def _scalars(tbl, contra):
    if contra:
        return tuple(tbl[k] for k in (
            "external_score_unpair", "external_score_basepair",
            "multibranch_score_unpair", "multibranch_score_basepair"))
    return (tbl["coeff_num_branches"],)


def inside(seqs, ns, tbl, pre, contra):
    """The inside pass, one span at a time over every lane: the log tables
    close, ext, mb, one in left layout [b, i, d] and qone, qrm, qrmmb in
    right layout [b, j, d]."""
    B, N = seqs.shape
    dev, dt = seqs.device, _dtype(tbl)
    neg = torch.full((), NEG_INF, dtype=dt, device=dev)
    st = {k: torch.full((B, N, N), 0.0 if k == "ext" else NEG_INF,
                        dtype=dt, device=dev)
          for k in ("close", "ext", "mb", "one", "qone", "qrm", "qrmmb")}
    close, ext, mb, one = st["close"], st["ext"], st["mb"], st["one"]
    qone, qrm, qrmmb = st["qone"], st["qrm"], st["qrmmb"]
    n = ns.to(dev).long()
    twoloop = twoloop_inside_contra if contra else twoloop_inside_turner
    if contra:
        eu, ebp, mbu, mbbp = _scalars(tbl, True)
    else:
        (coeff,) = _scalars(tbl, False)
    lse = torch.logaddexp
    a, b = _ab(dev)
    cap = a + b <= MAX_2LOOP_LEN

    for d in range(N):
        L = N - d
        i = torch.arange(L, device=dev)
        j = i + d
        live = j[None, :] < n[:, None]
        close_new = neg.expand(B, L).clone()
        if d + 1 >= MIN_SPAN_HAIRPIN_CLOSE:
            bi, ii = (pre["canon"][:, :L, d] & live).nonzero(as_tuple=True)
            if bi.numel():
                TL = twoloop(seqs, tbl, pre, d, (bi, ii))
                Wc = _window(close, bi, ii, d, NEG_INF, True)
                two = torch.logsumexp(torch.where(
                    cap, Wc + TL, neg).reshape(-1, W * W), -1)
                mb_in = mb[bi, ii + 1, d - 2] if d >= 2 else neg.expand(
                    bi.shape)
                close_new[bi, ii] = lse(lse(pre["H"][bi, ii, d], two),
                                        mb_in + pre["MBC"][bi, ii, d])
        acc = close_new + pre["ACC"][:, :L, d]
        prev = qrm[:, j - 1, d - 1] if d >= 1 else neg.expand(B, L)
        if contra:
            rm_new = lse(prev + eu, acc + ebp)
            prev_mb = qrmmb[:, j - 1, d - 1] if d >= 1 else neg.expand(B, L)
            rmmb_new = lse(prev_mb + mbu, acc + mbbp)
        else:
            rm_new = lse(prev, acc)

        # the O(d) sums over t = k - i in [0, d): ext over [0, d - 1], the
        # multibranch sums over [1, d - 1]
        t = torch.arange(d, device=dev)
        Qrow = qrm[:, j[:, None], (d - t)[None, :]]
        Qrow[:, :, :1] = rm_new[:, :, None]
        ext_prev = ext[:, i[:, None], (t - 1).clamp(min=0)[None, :]]
        ext_prev[:, :, :1] = 0.0
        mask = t >= 1
        one_prev = torch.where(
            mask, one[:, i[:, None], (t - 1).clamp(min=0)[None, :]], neg)
        if contra:
            x = torch.where(mask, qrmmb[:, j[:, None], (d - t)[None, :]], neg)
            s1_terms = x + mbu * t.to(dt)
        else:
            x = torch.where(mask, Qrow + coeff, neg)
            s1_terms = x
        ext_sum, s1_sum, s2 = torch.logsumexp(
            torch.stack([Qrow + ext_prev, s1_terms, one_prev + x]), -1)
        if contra:
            ext_new = lse((eu * float(d + 1)).expand(B, L), ext_sum)
            s1 = lse(rmmb_new, s1_sum)
        else:
            ext_new = lse(torch.zeros((), dtype=dt, device=dev).expand(B, L),
                          ext_sum)
            s1 = lse(rm_new + coeff, s1_sum)
        one_new = lse(s1, s2)

        for table, vals in ((close, close_new), (ext, ext_new), (mb, s2),
                            (one, one_new)):
            table[:, :L, d] = torch.where(live, vals, table[:, :L, d])
        right = [(qone, one_new), (qrm, rm_new)]
        if contra:
            right.append((qrmmb, rmmb_new))
        for table, vals in right:
            table[:, j, d] = torch.where(live, vals, table[:, j, d])
    return st


def outside(seqs, ns, tbl, pre, ins, contra):
    """The outside pass, spans in decreasing order.  Returns bppo [b, i, d],
    the log probability of pair (i, i + d), -inf where it cannot pair."""
    B, N = seqs.shape
    dev, dt = seqs.device, _dtype(tbl)
    neg0 = torch.full((), NEG_INF, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    bppo, G, qpm, qpm2 = (torch.full((B, N, N), NEG_INF, dtype=dt,
                                     device=dev) for _ in range(4))
    close, ext, one, qone = (ins[k] for k in ("close", "ext", "one", "qone"))
    n = ns.to(dev).long()
    twoloop = twoloop_outside_contra if contra else twoloop_outside_turner
    if contra:
        eu, ebp, mbu, mbbp = _scalars(tbl, True)
    else:
        (coeff,) = _scalars(tbl, False)
    lse = torch.logaddexp
    nmax = int(n.max())

    for d in range(N - 1, -1, -1):
        L = N - d
        i = torch.arange(L, device=dev)
        j = i + d
        live = j[None, :] < n[:, None]
        valid = d + 1 >= MIN_SPAN_HAIRPIN_CLOSE

        # pm / pm2: pairs (i, k) with k = j + t > j, t in [1, n - 1 - j]
        Lt = max(nmax - d, 1)
        t = torch.arange(Lt, device=dev)
        tl = (t[None, None, :] >= 1) & (j[None, :, None] + t
                                         < n[:, None, None])
        Xr = G[:, i[:, None], (d + t).clamp(max=N - 1)[None, :]]
        S_one = one[:, (j + 1).clamp(max=N - 1)[:, None],
                    (t - 2).clamp(min=0)[None, :]]
        S_one = torch.where(t >= 2, S_one, neg0)
        pm2_t = Xr + mbu * (t.to(dt) - 1.0) if contra else Xr
        pm, pm2 = torch.logsumexp(torch.where(
            tl, torch.stack([Xr + S_one, pm2_t]), neg0), -1)
        if not valid:
            continue
        qpm[:, j, d] = torch.where(live, pm, qpm[:, j, d])
        qpm2[:, j, d] = torch.where(live, pm2, qpm2[:, j, d])

        pair = live & torch.isfinite(close[:, :L, d])
        bi, ii = pair.nonzero(as_tuple=True)
        if not bi.numel():
            continue
        jj = ii + d
        nb = n[bi]
        cl = close[bi, ii, d]
        acc = cl + pre["ACC"][bi, ii, d]
        lt = torch.where(ii >= 1, ext[bi, 0, (ii - 1).clamp(min=0)], zero)
        rt = torch.where(jj <= nb - 2,
                         ext[bi, (jj + 1).clamp(max=N - 1),
                             (nb - 2 - jj).clamp(min=0)], zero)
        base = lt + acc + rt - ext[bi, 0, nb - 1]
        if contra:
            base = base + ebp

        # 2-loop context: outer (i - 1 - a, j + 1 + b) inside the sequence
        TLo = twoloop(seqs, tbl, pre, d, (bi, ii))
        a, b = _ab(dev)
        inner = ((ii[:, None, None] - 1 - a >= 0)
                 & (jj[:, None, None] + 1 + b <= nb[:, None, None] - 1)
                 & (a + b <= MAX_2LOOP_LEN))
        Wb = _window(bppo, bi, ii, d, NEG_INF, False)
        Wcl = torch.where(inner, _window(close, bi, ii, d, NEG_INF, False),
                          neg0)
        two_terms = torch.where(torch.isfinite(Wcl),
                                Wb + cl[:, None, None] - Wcl + TLo, neg0)
        two = torch.logsumexp(two_terms.reshape(-1, W * W), -1)

        # multibranch context: k = i - t < i, t in [1, i]
        Lc = int(ii.max())
        ctx = neg0.expand(bi.shape)
        if Lc >= 1:
            tc = torch.arange(1, Lc + 1, device=dev)
            ok = tc[None, :] <= ii[:, None]
            col = (d + tc).clamp(max=N - 1)[None, :]
            R_pm = qpm[bi[:, None], jj[:, None], col]
            R_pm2 = qpm2[bi[:, None], jj[:, None], col]
            S_qone = qone[bi[:, None], (ii - 1).clamp(min=0)[:, None],
                          (tc - 2).clamp(min=0)[None, :]]
            S_qone = torch.where(tc[None, :] >= 2, S_qone, neg0)
            acc_mb = (acc + (mbbp if contra else coeff))[:, None]
            ta = acc_mb + R_pm2 + S_qone
            if contra:
                tb = acc_mb + R_pm + mbu * (tc.to(dt) - 1.0)
            else:
                tb = acc_mb + R_pm
            tcc = acc_mb + R_pm + S_qone
            ctx = torch.logsumexp(torch.where(
                ok, torch.stack([ta, tb, tcc]), neg0), -1)
            ctx = torch.logsumexp(ctx, 0)
        bp = lse(lse(base, two), ctx)
        bppo[bi, ii, d] = bp
        G[bi, ii, d] = bp + pre["MBC"][bi, ii, d] - cl
    return bppo


def bpp(seqs, ns, tbl, model):
    """(B, N, N) base-pair probabilities, upper triangle, of ``seqs``
    (B, N) int64 of true lengths ``ns``."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}")
    contra = model == "contra"
    B, N = seqs.shape
    pre = (precompute_contra if contra else precompute_turner)(
        seqs, ns, N, tbl)
    ins = inside(seqs, ns, tbl, pre, contra)
    bppo = outside(seqs, ns, tbl, pre, ins, contra)
    dev = seqs.device
    span = (torch.arange(N, device=dev)[None, :]
            - torch.arange(N, device=dev)[:, None])          # j - i
    sq = torch.gather(bppo, 2, span.clamp(min=0).expand(B, N, N))
    return torch.where(span >= 0, torch.exp(sq), torch.zeros((), dtype=sq.dtype,
                                                               device=dev))
