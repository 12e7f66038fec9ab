"""Kernels K20 and K21: the span steps of the generic-N McCaskill scan
(``rna_algos_tpu.models.mccaskill._inside`` / ``_outside``).

The JAX package folds every bucket its TPU kernels do not take with an XLA
``lax.scan`` over the spans: increasing for the inside pass, decreasing for
the outside pass, one anti-diagonal a step, in cubic log space under
"exact" and "parity" and with ``logaddexp`` under "fast".  Here each step is
one launch of a hand-written kernel (``csrc/fold_scan.cu``): K20 for the
inside, K21 for the outside, N launches a pass, one block a live lane
(sequence b, left end i, i + d < n).

Every sum is ``numerics.lse_reduce``'s halving tree at the term indices the
JAX scan gives them: the 2-loop window at a * 31 + b (961 terms), the O(d)
sums at their term t, the multibranch context at t, N + t and 2N + t.  As
``lse_pair(x, -inf)`` is ``x`` bit for bit, a tree over the live terms only
gives the same bits, so the plain versions and the kernels pay O(d) a lane
and agree bit for bit under the cubic modes.

The state tables are (B, N, N) float32: left layout [b, i, d] = state(i,
i + d) for close, ext, mb, one (inside) and bppo, G (outside), right layout
[b, j, e] = state(j - e, j) for rm, rmmb, one (inside) and pm, pm2
(outside).  Only live cells are written; the others keep their fills.
CPU tensors run the plain versions, CUDA tensors the kernels; any other
device raises.
"""

import torch

from ..constants import MIN_SPAN_HAIRPIN_CLOSE, NEG_INF
from ..numerics import check_mode, lse_pair, lse_reduce

from . import _build
from . import scores as S

W = S.WINDOW            # 2-loop window extent
LEAVES = 16             # tree leaves a thread while the block can grow
MAX_LEAVES = 128        # 2^SCAN_MAX_LG in csrc/fold_scan.cu
MIN_THREADS, MAX_THREADS = 64, 1024
# The kernels' largest N: K21's context tree (3N terms) in one block.  One
# (N, N) float32 table takes 7.6 GB there, and a sequence ~22 of them, so
# the card's memory binds first.
MAX_N = MAX_LEAVES * MAX_THREADS // 3

inside_launches = _build.LaunchCounter("scan_inside")
outside_launches = _build.LaunchCounter("scan_outside")

INSIDE_STATE = ("close", "ext", "mb", "one", "qone", "qrm", "qrmmb")
INSIDE_FILLS = {"ext": 0.0}            # every other table starts at -inf
OUTSIDE_STATE = ("bppo", "g", "qpm", "qpm2")
TURNER_TABLES = ("H", "MBC", "ACC", "AUGU", "TMo_int", "TMo_1xmany",
                 "TMo_2x3", "TMi_int", "TMi_1xmany", "TMi_2x3")
CONTRA_TABLES = ("H", "MBC", "ACC", "JS", "JB", "JSrev", "BP")
TURNER_PARAMS = ("stack", "int_1x1", "int_1x2", "int_2x2", "bulge_init",
                 "coeff_num_branches")
CONTRA_PARAMS = ("stack_scores", "basepair_scores", "bulge_scores_0x1",
                 "interior_scores_1x1", "external_score_unpair",
                 "external_score_basepair", "multibranch_score_unpair",
                 "multibranch_score_basepair")


def min_span(contra, allows_short_hairpins):
    """Shortest span a pair may close: 2 for CONTRA with short hairpins,
    else MIN_SPAN_HAIRPIN_CLOSE (the Turner model ignores the option)."""
    return 2 if (contra and allows_short_hairpins) else MIN_SPAN_HAIRPIN_CLOSE


def _neg(shape, dev):
    return torch.full(shape, NEG_INF, device=dev)


def _state(names, B, N, dev, fills):
    """The state tables, each (B, N, N), at their fills (-inf unless
    ``fills`` names another)."""
    return {k: torch.full((B, N, N), fills.get(k, NEG_INF), device=dev)
            for k in names}


def _scalars(tbl, contra):
    if contra:
        return tuple(tbl[k] for k in CONTRA_PARAMS[4:])
    return (tbl["coeff_num_branches"],)


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors)
# ---------------------------------------------------------------------------

def scan_inside_plain(seqs, ns, tbl, pre, contra, allows_short_hairpins=False,
                      mode="exact"):
    """The inside pass (``_inside``) in plain PyTorch, one span at a time
    over every lane of the batch.  ``seqs`` (B, N) int64, ``ns`` (B,),
    ``pre`` ``precompute_contra`` / ``precompute_turner``.  Returns the
    state dict of INSIDE_STATE (``qrmmb`` -inf for Turner)."""
    check_mode(mode)
    B, N = seqs.shape
    dev = seqs.device
    st = _state(INSIDE_STATE, B, N, dev, INSIDE_FILLS)
    close, ext, mb, one = st["close"], st["ext"], st["mb"], st["one"]
    qone, qrm, qrmmb = st["qone"], st["qrm"], st["qrmmb"]
    n = ns.to(dev).long()
    twoloop = S.twoloop_inside_contra if contra else S.twoloop_inside_turner
    if contra:
        eu, ebp, mbu, mbbp = _scalars(tbl, True)
    else:
        (coeff,) = _scalars(tbl, False)
    span_min = min_span(contra, allows_short_hairpins)
    lse = lambda a, b: lse_pair(a, b, mode)  # noqa: E731

    for d in range(N):
        L = N - d
        i = torch.arange(L, device=dev)
        j = i + d
        live = j[None, :] < n[:, None]                       # (B, L)
        close_new = _neg((B, L), dev)
        if d + 1 >= span_min:
            bi, ii = (pre["canon"][:, :L, d] & live).nonzero(as_tuple=True)
            if bi.numel():
                TL = twoloop(seqs, tbl, pre, d, N, lanes=(bi, ii))
                Wc = S._window(close, bi, ii, d, NEG_INF, True)
                two = lse_reduce((Wc + TL).reshape(-1, W * W), -1, mode)
                mb_in = (mb[bi, ii + 1, d - 2] if d >= 2
                         else _neg(bi.shape, dev))
                mb_term = mb_in + pre["MBC"][bi, ii, d]
                close_new[bi, ii] = lse(lse(pre["H"][bi, ii, d], two),
                                        mb_term)
        acc = close_new + pre["ACC"][:, :L, d]
        prev = qrm[:, j - 1, d - 1] if d >= 1 else _neg((B, L), dev)
        if contra:
            rm_new = lse(prev + eu, acc + ebp)
            prev_mb = qrmmb[:, j - 1, d - 1] if d >= 1 else _neg((B, L), dev)
            rmmb_new = lse(prev_mb + mbu, acc + mbbp)
        else:
            rm_new = lse(prev, acc)

        # the O(d) sums over t = k - i in [0, d): ext over [0, d - 1],
        # the multibranch sums over [1, d - 1]
        t = torch.arange(d, device=dev)
        Qrow = qrm[:, j[:, None], (d - t)[None, :]]          # rm(i + t, j)
        Qrow[:, :, :1] = rm_new[:, :, None]
        ext_prev = ext[:, i[:, None], (t - 1).clamp(min=0)[None, :]]
        ext_prev[:, :, :1] = 0.0
        mask = t >= 1
        one_prev = torch.where(
            mask, one[:, i[:, None], (t - 1).clamp(min=0)[None, :]],
            torch.full((), NEG_INF, device=dev))
        if contra:
            x = torch.where(mask, qrmmb[:, j[:, None], (d - t)[None, :]],
                            torch.full((), NEG_INF, device=dev))
            s1_terms = x + mbu * t.to(torch.float32)
        else:
            x = torch.where(mask, Qrow + coeff,
                            torch.full((), NEG_INF, device=dev))
            s1_terms = x
        # the three trees in one call: elementwise, so the same bits
        ext_sum, s1_sum, s2 = lse_reduce(
            torch.stack([Qrow + ext_prev, s1_terms, one_prev + x]), -1, mode)
        span = float(d + 1)
        base = 0.0 + eu * span if contra else torch.zeros((), device=dev)
        ext_new = lse(base.expand(B, L), ext_sum)
        s1 = lse(rmmb_new, s1_sum) if contra else lse(rm_new + coeff, s1_sum)
        one_new = lse(s1, s2)

        # live lanes only: the others keep their fills
        for table, vals in ((close, close_new), (ext, ext_new), (mb, s2),
                            (one, one_new)):
            table[:, :L, d] = torch.where(live, vals, table[:, :L, d])
        right = [(qone, one_new), (qrm, rm_new)]
        if contra:
            right.append((qrmmb, rmmb_new))
        for table, vals in right:
            table[:, j, d] = torch.where(live, vals, table[:, j, d])
    return st


def scan_outside_plain(seqs, ns, tbl, pre, inside, contra,
                       allows_short_hairpins=False, mode="exact"):
    """The outside pass (``_outside``) in plain PyTorch, spans in
    decreasing order.  ``inside`` is the inside pass's state dict.  Returns
    the state dict of OUTSIDE_STATE: bppo [b, i, d] is the log outside x
    inside weight of pair (i, i + d), -inf where it cannot pair."""
    check_mode(mode)
    B, N = seqs.shape
    dev = seqs.device
    st = _state(OUTSIDE_STATE, B, N, dev, {})
    bppo, G, qpm, qpm2 = st["bppo"], st["g"], st["qpm"], st["qpm2"]
    close, ext, one, qone = (inside[k] for k in ("close", "ext", "one",
                                                 "qone"))
    n = ns.to(dev).long()
    twoloop = S.twoloop_outside_contra if contra else S.twoloop_outside_turner
    if contra:
        eu, ebp, mbu, mbbp = _scalars(tbl, True)
    else:
        (coeff,) = _scalars(tbl, False)
    span_min = min_span(contra, allows_short_hairpins)
    neg0 = torch.full((), NEG_INF, device=dev)
    zero = torch.zeros((), device=dev)
    lse = lambda a, b: lse_pair(a, b, mode)  # noqa: E731

    for d in range(N - 1, -1, -1):
        L = N - d
        i = torch.arange(L, device=dev)
        j = i + d
        live = j[None, :] < n[:, None]
        valid = d + 1 >= span_min

        # pm / pm2: pairs (i, k) with k = j + t > j, t in [1, n - 1 - j]
        Lt = max(int(n.max()) - d, 1)
        t = torch.arange(Lt, device=dev)
        tl = (t[None, None, :] >= 1) & (j[None, :, None] + t < n[:, None, None])
        Xr = G[:, i[:, None], (d + t).clamp(max=N - 1)[None, :]]
        S_one = one[:, (j + 1).clamp(max=N - 1)[:, None],
                    (t - 2).clamp(min=0)[None, :]]
        S_one = torch.where(t >= 2, S_one, neg0)
        if contra:
            pm2_t = Xr + mbu * (t.to(torch.float32) - 1.0)
        else:
            pm2_t = Xr
        pm, pm2 = lse_reduce(torch.where(tl, torch.stack([Xr + S_one, pm2_t]),
                                         neg0), -1, mode)
        if not valid:
            pm, pm2 = _neg((B, L), dev), _neg((B, L), dev)
        qpm[:, j, d] = torch.where(live, pm, qpm[:, j, d])
        qpm2[:, j, d] = torch.where(live, pm2, qpm2[:, j, d])

        if not valid:
            continue
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

        # 2-loop context: outer (i - 1 - a, j + 1 + b), inside the sequence
        TLo = twoloop(seqs, tbl, pre, d, N, lanes=(bi, ii))
        a, b = S._ab(dev)
        inner = ((ii[:, None, None] - 1 - a >= 0)
                 & (jj[:, None, None] + 1 + b <= nb[:, None, None] - 1))
        Wb = S._window(bppo, bi, ii, d, NEG_INF, False)
        Wcl = torch.where(inner, S._window(close, bi, ii, d, NEG_INF, False),
                          neg0)
        two_terms = torch.where(torch.isfinite(Wcl),
                                Wb + cl[:, None, None] - Wcl + TLo, neg0)

        # multibranch context: k = i - t < i, t in [1, i]; the terms at
        # t, N + t and 2N + t of one tree.  Both trees in one call, each
        # padded with -inf to the wider one's width: the same bits.
        Lc = int(ii.max())
        width = max(W * W, 2 * N + Lc + 1)
        x = _neg((2, bi.numel(), width), dev)
        x[0, :, :W * W] = two_terms.reshape(-1, W * W)
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
                tb = acc_mb + R_pm + mbu * (tc.to(torch.float32) - 1.0)
            else:
                tb = acc_mb + R_pm
            tcc = acc_mb + R_pm + S_qone
            for s, terms in enumerate((ta, tb, tcc)):
                x[1, :, s * N + 1:s * N + Lc + 1] = torch.where(ok, terms,
                                                                neg0)
        two, ctx = lse_reduce(x, -1, mode)
        bp = lse(lse(base, two), ctx)
        bppo[bi, ii, d] = bp
        G[bi, ii, d] = bp + pre["MBC"][bi, ii, d] - cl
    return st


# ---------------------------------------------------------------------------
# Kernels (CUDA tensors)
# ---------------------------------------------------------------------------

def _device(name, t):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type


def threads(extent):
    """Threads a block for trees of up to ``extent`` terms: a power of two
    in [MIN_THREADS, MAX_THREADS] with LEAVES terms a thread; past
    MAX_THREADS * LEAVES each thread takes more (the kernel doubles its
    leaves until they cover the tree), up to MAX_LEAVES."""
    T = MIN_THREADS
    while T * LEAVES < extent and T < MAX_THREADS:
        T *= 2
    if T * MAX_LEAVES < extent:
        raise ValueError(f"fold_scan: a tree of {extent} terms exceeds one "
                         f"block ({MAX_THREADS} threads x {MAX_LEAVES} "
                         "leaves)")
    return T


def _check(name, seqs, ns, tables, tnames, params, pnames, state, snames):
    B, N = seqs.shape
    dev = seqs.device
    if N > MAX_N:
        raise ValueError(f"{name}: N = {N} > MAX_N = {MAX_N} (K21's context "
                         f"tree of 3N terms in one block of {MAX_THREADS} "
                         f"threads x {MAX_LEAVES} leaves)")
    want = {k: (tables[k], (B, N, N), torch.float32) for k in tnames}
    want["canon"] = (tables["canon"], (B, N, N), torch.bool)
    want.update({k: (state[k], (B, N, N), torch.float32) for k in snames})
    want["seqs"] = (seqs, (B, N), torch.int32)
    want["ns"] = (ns, (B,), torch.int32)
    for k in pnames:
        want[k] = (params[k], tuple(params[k].shape), torch.float32)
    for k, (t, shape, dt) in want.items():
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {k} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                f"expected a contiguous {dt} {shape} on {dev}")


def _ptrs(ts):
    return (_build._P * len(ts))(*[t.data_ptr() for t in ts])


def _launch_args(seqs, ns, tbl, contra):
    """The score-table and parameter names of a model, its parameters with
    the (31, 31) length terms, and the int32 sequences and lengths."""
    tnames = CONTRA_TABLES if contra else TURNER_TABLES
    pnames = CONTRA_PARAMS if contra else TURNER_PARAMS
    params = dict(tbl)
    if contra:
        params["bulge_len"], params["interior_len"] = (
            t.contiguous() for t in S._contra_len_consts(tbl))
        pnames = pnames + ("bulge_len", "interior_len")
    else:
        params["init_int"], params["init_bulge"], params["ninio"] = (
            t.contiguous() for t in S._turner_len_consts(tbl))
        pnames = pnames + ("init_int", "init_bulge", "ninio")
    s32 = seqs.to(torch.int32).contiguous()
    n32 = ns.to(torch.int32).contiguous()
    return tnames, pnames, params, s32, n32


def scan_inside(seqs, ns, tbl, pre, contra, allows_short_hairpins=False,
                mode="exact"):
    """The inside pass: kernel K20 (``csrc/fold_scan.cu``) once a span for
    CUDA tensors, ``scan_inside_plain`` for CPU tensors.  Returns the state
    dict of INSIDE_STATE; the kernels write the live cells (i + d < n)
    only, the others keep their fills."""
    if _device("scan_inside", seqs) == "cpu":
        return scan_inside_plain(seqs, ns, tbl, pre, contra,
                                 allows_short_hairpins, mode)
    B, N = seqs.shape
    dev = seqs.device
    st = _state(INSIDE_STATE, B, N, dev, INSIDE_FILLS)
    tnames, pnames, params, s32, n32 = _launch_args(seqs, ns, tbl, contra)
    _check("scan_inside", s32, n32, pre, tnames, params, pnames, st,
           INSIDE_STATE)
    lib = _build.library()
    tabs = _ptrs([pre[k] for k in tnames])
    pars = _ptrs([params[k] for k in pnames])
    sts = _ptrs([st[k] for k in INSIDE_STATE])
    stream = _build.stream_ptr(dev)
    fast = int(check_mode(mode) == "fast")
    span_min = min_span(contra, allows_short_hairpins)
    for d in range(N):
        lib.call("rna_scan_inside", tabs, _build.ptr(pre["canon"]), pars,
                 sts, _build.ptr(s32), _build.ptr(n32), B, N, d,
                 int(contra), fast, span_min, threads(max(W * W, d)), stream)
        inside_launches.count += 1
    return st


def scan_outside(seqs, ns, tbl, pre, inside, contra,
                 allows_short_hairpins=False, mode="exact"):
    """The outside pass: kernel K21 once a span (N - 1 down to 0) for CUDA
    tensors, ``scan_outside_plain`` for CPU tensors.  ``inside`` is the
    inside pass's state dict.  Returns the state dict of OUTSIDE_STATE,
    live cells written, the others their fills."""
    if _device("scan_outside", seqs) == "cpu":
        return scan_outside_plain(seqs, ns, tbl, pre, inside, contra,
                                  allows_short_hairpins, mode)
    B, N = seqs.shape
    dev = seqs.device
    st = _state(OUTSIDE_STATE, B, N, dev, {})
    tnames, pnames, params, s32, n32 = _launch_args(seqs, ns, tbl, contra)
    ins = {k: inside[k] for k in ("close", "ext", "one", "qone")}
    both = dict(st, **ins)
    names = ("close", "ext", "one", "qone") + OUTSIDE_STATE
    _check("scan_outside", s32, n32, pre, tnames, params, pnames, both, names)
    lib = _build.library()
    tabs = _ptrs([pre[k] for k in tnames])
    pars = _ptrs([params[k] for k in pnames])
    sts = _ptrs([both[k] for k in names])
    stream = _build.stream_ptr(dev)
    fast = int(check_mode(mode) == "fast")
    span_min = min_span(contra, allows_short_hairpins)
    for d in range(N - 1, -1, -1):
        lib.call("rna_scan_outside", tabs, _build.ptr(pre["canon"]), pars,
                 sts, _build.ptr(s32), _build.ptr(n32), B, N, d,
                 int(contra), fast, span_min,
                 threads(max(W * W, 3 * N - d)), stream)
        outside_launches.count += 1
    return st
