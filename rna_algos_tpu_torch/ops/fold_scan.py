"""Kernels K20 and K21: the inside and outside passes of the generic-N
McCaskill scan (``rna_algos_tpu.models.mccaskill._inside`` / ``_outside``).

The JAX package folds every bucket its TPU kernels do not take with an XLA
``lax.scan`` over the spans: increasing for the inside pass, decreasing for
the outside pass, one anti-diagonal a step, in cubic log space under
"exact" and "parity" and with ``logaddexp`` under "fast".  Here each pass
is one cooperative launch of a hand-written kernel (``csrc/fold_scan.cu``):
K20 for the inside, K21 for the outside.  Its blocks stay resident and walk
the spans with one grid barrier a span; at each span the live lanes
(sequence b, left end i, i + d < n) go to groups of g threads, g a power of
two chosen for the span and the kind of work (``span_work``), and a unit
of threads takes its items in rounds (``span_units``).  The lanes that
carry a 2-loop window (K20: those that can close; K21: those that can
pair) are listed two spans ahead, and their windows summed a span ahead,
so that each kind of work gets groups of its own width.

Every sum is ``numerics.lse_reduce``'s halving tree at the term indices the
JAX scan gives them: the 2-loop window at a * 31 + b (961 terms), the O(d)
sums at their term t, the multibranch context at t, N + t and 2N + t.
Thread t of a group holds the terms t + m g and closes the halving tree
over them in bit-reversed order of m; the group then halves over its
threads.  As ``lse_pair(x, -inf)`` is ``x`` bit for bit, a tree over the
live terms only, or one that skips a dead run whole, gives the same bits,
so the plain versions and the kernels pay O(d) a lane and agree bit for bit
under the cubic modes.

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
SCAN_T = 512            # threads a block (csrc/fold_scan.cu)
LG_INSIDE = 7           # K20: at most 2^7 tree leaves a thread
LG_OUTSIDE = 8          # K21: 2^8
MIN_LEAVES = 4          # a span's widest tree: >= 4 leaves a thread
RUN = 4                 # a thread takes its positions 4 at a time
# The kernels' largest N: K21's context tree (3N terms) over one block at
# 2^LG_OUTSIDE leaves a thread.  One (N, N) float32 table takes 7.6 GB
# there, and a sequence ~22 of them, so the card's memory binds first.
MAX_N = SCAN_T * 2 ** LG_OUTSIDE // 3
# Groups at most GROUP_CAP threads wide (a power of two), and a pass on at
# most GRID_CAP blocks (0: as many as the card keeps resident).  The
# checks lower them to reach the narrowest groups a span allows and lanes
# taken in many rounds (chip_smoke.narrow_groups).
GROUP_CAP = SCAN_T
GRID_CAP = 0

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


def pow2_ceil(x):
    """Least power of two >= x (1 for x <= 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def inside_window_terms(d):
    """K20's 2-loop window at span d: the (a, b) with a + b <= d - 2 and
    a, b <= 30."""
    return sum(min(W - 1, d - 2 - a) + 1 for a in range(min(W - 1, d - 2)
                                                       + 1))


def inside_window_extent(d):
    """The last live window term a * 31 + b at span d, plus one."""
    if d < 2:
        return 0
    a = min(W - 1, d - 2)
    return a * W + min(W - 1, d - 2 - a) + 1


def group_width(E, width, count, threads, lg, cap=None):
    """The group width of a kind of work at a span (``scan_group`` in
    csrc/fold_scan.cu): a power of two no wider than the widest tree's E
    live terms over MIN_LEAVES leaves a thread, nor than ``threads`` (the
    grid's) over the ``count`` items, nor than ``cap``; no narrower than
    the widest tree's ``width`` (a power of two) over 2^lg leaves a thread;
    at most SCAN_T.  Refuses a tree no block holds (N past MAX_N)."""
    cap = GROUP_CAP if cap is None else cap
    if width > SCAN_T << lg:
        raise ValueError(f"fold_scan: a tree {width} wide exceeds one block "
                         f"({SCAN_T} threads x {1 << lg} leaves)")
    g = pow2_ceil((E + MIN_LEAVES - 1) // MIN_LEAVES)
    g = min(g, 1 << (max(1, threads // max(count, 1)).bit_length() - 1))
    g = max(min(g, cap), max(1, width >> lg))
    return min(g, SCAN_T)


def span_work(inside, d, N, lanes, listed, min_span_, threads, cap=None):
    """The work of span d in the order the kernel takes it: (kind, span of
    its lanes, count, group width), ``lanes(d)`` the live lanes of a span
    and ``listed(d)`` the lanes of its list.  K20: the windows of span
    d + 1's closing lanes, the list of span d + 2's (groups of 1), span d's
    lanes.  K21: the contexts of span d's pair lanes, the pm/pm2 trees of
    its lanes, the windows of span d - 1's pair lanes, the list of span
    d - 2's.  A kind with no items is left out."""
    out = []

    def add(kind, at, count, E, width, lg):
        if count > 0:
            out.append((kind, at, count,
                        1 if kind == "list" else
                        group_width(E, width, count, threads, lg, cap)))

    if inside:
        if 2 <= d + 1 < N:
            add("window", d + 1, listed(d + 1), inside_window_terms(d + 1),
                pow2_ceil(inside_window_extent(d + 1)), LG_INSIDE)
        if d + 2 < N and d + 3 >= min_span_:
            add("list", d + 2, lanes(d + 2), 0, 1, 0)
        add("lanes", d, lanes(d), d, pow2_ceil(d), LG_INSIDE)
    else:
        if d + 1 >= min_span_:
            add("context", d, listed(d), max(3 * (N - 1 - d), 1),
                pow2_ceil(3 * N - d), LG_OUTSIDE)
        add("pm", d, lanes(d), max(N - 1 - d, 1), pow2_ceil(N - d),
            LG_OUTSIDE)
        if d >= 1 and d >= min_span_:
            add("window", d - 1, listed(d - 1), W * W, pow2_ceil(W * W),
                LG_OUTSIDE)
        if d - 2 >= 0 and d - 1 >= min_span_:
            add("list", d - 2, lanes(d - 2), 0, 1, 0)
    return out


def span_units(g, items, blocks):
    """The items of a kind of work as ``span_lanes`` in csrc/fold_scan.cu
    hands them out, for every thread of the grid: arrays over (block,
    thread) of the thread's index t in its group, its group in the block,
    and the item of each round (a list; -1 where the thread's group
    idles)."""
    import numpy as np

    tb = np.arange(SCAN_T)[None, :]
    blk = np.arange(blocks)[:, None]
    per = max(g, 32)
    lpu = per // g
    units = (SCAN_T // per) * blocks
    u = (tb // per) * blocks + blk
    gin = (tb % per) // g
    rounds, first = [], u * lpu
    while (first < items).any():
        item = first + gin
        rounds.append(np.where((first < items) & (item < items), item, -1))
        first = first + units * lpu
    return (np.broadcast_to(tb & (g - 1), u.shape),
            np.broadcast_to(tb // g, u.shape), rounds)


def lane_offsets(ns, N):
    """(N, B + 1) int32: entry [d, b] counts the live lanes of span d in
    the sequences before b (lane l of span d is sequence b's left end
    l - [d, b])."""
    ns = ns.to(torch.int32)
    d = torch.arange(N, device=ns.device, dtype=torch.int32)
    live = (ns[None, :] - d[:, None]).clamp(min=0)
    off = torch.zeros((N, ns.numel() + 1), dtype=torch.int32,
                      device=ns.device)
    off[:, 1:] = torch.cumsum(live, 1, dtype=torch.int32)
    return off


def grid_blocks(inside, contra, mode):
    """The blocks of a pass: as many as the card keeps resident for the
    kernel instance (a cooperative launch takes no more), at most
    GRID_CAP if set."""
    out = _build.ctypes.c_int(0)
    _build.library().call("rna_scan_blocks", int(inside), int(contra),
                          int(check_mode(mode) == "fast"),
                          _build.ctypes.byref(out))
    return min(out.value, GRID_CAP) if GRID_CAP else out.value


def _check(name, seqs, ns, tables, tnames, params, pnames, state, snames):
    B, N = seqs.shape
    dev = seqs.device
    if N > MAX_N:
        raise ValueError(f"{name}: N = {N} > MAX_N = {MAX_N} (K21's context "
                         f"tree of 3N terms in one block of {SCAN_T} "
                         f"threads x {1 << LG_OUTSIDE} leaves)")
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


def _pass(inside, seqs, ns, tbl, pre, state, names, contra,
          allows_short_hairpins, mode):
    """One cooperative launch of K20 (``inside``) or K21 on the (B, N, N)
    ``state`` tables, in the order of ``names``."""
    B, N = seqs.shape
    dev = seqs.device
    tnames, pnames, params, s32, n32 = _launch_args(seqs, ns, tbl, contra)
    _check("scan_inside" if inside else "scan_outside", s32, n32, pre,
           tnames, params, pnames, state, names)
    lib = _build.library()
    lanes = lane_offsets(n32, N)
    # the work lists (3 B N entries, then N counts at zero) and the window
    # sums (2 B N, -inf)
    lists = torch.zeros(3 * B * N + N, dtype=torch.int32, device=dev)
    windows = _neg((2, B, N), dev)
    lib.call("rna_scan_pass", int(inside), _ptrs([pre[k] for k in tnames]),
             _build.ptr(pre["canon"]), _ptrs([params[k] for k in pnames]),
             _ptrs([state[k] for k in names]), _build.ptr(s32),
             _build.ptr(n32), _build.ptr(lanes), _build.ptr(lists),
             _build.ptr(windows), B, N, int(contra),
             int(check_mode(mode) == "fast"),
             min_span(contra, allows_short_hairpins), GROUP_CAP,
             grid_blocks(inside, contra, mode), _build.stream_ptr(dev))


def scan_inside(seqs, ns, tbl, pre, contra, allows_short_hairpins=False,
                mode="exact"):
    """The inside pass: kernel K20 (``csrc/fold_scan.cu``), one launch,
    for CUDA tensors, ``scan_inside_plain`` for CPU tensors.  Returns the
    state dict of INSIDE_STATE; the kernel writes the live cells (i + d <
    n) only, the others keep their fills."""
    if _device("scan_inside", seqs) == "cpu":
        return scan_inside_plain(seqs, ns, tbl, pre, contra,
                                 allows_short_hairpins, mode)
    B, N = seqs.shape
    st = _state(INSIDE_STATE, B, N, seqs.device, INSIDE_FILLS)
    _pass(True, seqs, ns, tbl, pre, st, INSIDE_STATE, contra,
          allows_short_hairpins, mode)
    inside_launches.count += 1
    return st


def scan_outside(seqs, ns, tbl, pre, inside, contra,
                 allows_short_hairpins=False, mode="exact"):
    """The outside pass: kernel K21, one launch (spans N - 1 down to 0),
    for CUDA tensors, ``scan_outside_plain`` for CPU tensors.  ``inside``
    is the inside pass's state dict.  Returns the state dict of
    OUTSIDE_STATE, live cells written, the others their fills."""
    if _device("scan_outside", seqs) == "cpu":
        return scan_outside_plain(seqs, ns, tbl, pre, inside, contra,
                                  allows_short_hairpins, mode)
    B, N = seqs.shape
    st = _state(OUTSIDE_STATE, B, N, seqs.device, {})
    names = ("close", "ext", "one", "qone") + OUTSIDE_STATE
    both = dict(st, **{k: inside[k] for k in names[:4]})
    _pass(False, seqs, ns, tbl, pre, both, names, contra,
          allows_short_hairpins, mode)
    outside_launches.count += 1
    return st
