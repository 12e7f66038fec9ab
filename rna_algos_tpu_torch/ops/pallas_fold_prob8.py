"""McCaskill in scaled probability space, N <= 256, both models
(``rna_algos_tpu.ops.pallas_fold_prob8``): the merged table precomputes,
kernels K1/K2 (CONTRA inside/outside) and K4/K5 (Turner inside/outside),
and the fixed-scale runs wrapped in the rescale-retry loop.

The TPU stacked G sequences along sublanes and aged a lane-major window;
none of that layout is carried over.  Here each kernel runs one CUDA block
per sequence (``csrc/contra_inside.cu``, ``csrc/contra_outside.cu``,
``csrc/turner_inside.cu``, ``csrc/turner_outside.cu``; their block size
comes from the batch and the card, ``contra_block_threads`` and
``turner_block_threads``, and they compute live cells only, i + d < n; the
long tier's K8,
K9, K12 and K13, a cluster of blocks per sequence, are entries of the same
sources past N = 256, launched through the helpers below by
``pallas_fold_long``).  The plain versions
below compute the same recurrences for the whole batch with tensor ops per
span; the wrappers use them for CPU tensors only.  The two models share
every recurrence but the 2-loop term, so each pass has one plain core
(``_inside_plain``, ``_outside_plain``) that takes the model's 2-loop term
and window inserts as functions.
"""

import functools

import torch

from ..constants import MIN_SPAN_HAIRPIN_CLOSE

from . import _build
from . import pallas_fold as PF
from . import pallas_fold_prob as PP
from .diag import shift_pq as sh
from .pallas_skew import skew_pq_batch

INSIDE_TABLES = ("H", "MBC", "ACC", "JS", "STK", "I11", "B0R", "B0L", "JB")
OUTSIDE_TABLES = (
    "CLOSE", "MBC", "ACCB", "ACCMB", "STKO", "I11O", "B0RO", "JRB", "JSN",
)
TURNER_INSIDE_TABLES = (
    "H", "MBC", "ACC", "AUGC", "TMO1C", "TMO2C", "TMO3C",
    "SP00", "SP01", "SP10", "SP11", "SP12", "SP21", "SP22",
    "AUGT", "TMI1", "TMI2", "TMI3",
)
TURNER_OUTSIDE_TABLES = (
    "CLOSE", "MBC", "ACCB", "ACCMB", "AUGT", "TMI1C", "TMI2C", "TMI3C",
    "SP00", "SP01", "SP10", "SP11", "SP12", "SP21", "SP22",
    "TMO1", "TMO2", "TMO3",
)
# Turner small-loop cells as (name, window age, lane offset): the inner
# pair of span d - 1 - age at lane i + offset (the outside mirrors the
# lane offset).  Age k of a window ring holds span d - 1 - k (inside) or
# d + 1 + k (outside).
TURNER_SPECIALS = (
    ("SP00", 1, 1), ("SP01", 2, 1), ("SP10", 2, 2), ("SP11", 3, 2),
    ("SP12", 4, 2), ("SP21", 4, 3), ("SP22", 5, 3),
)
TM3_AGE = 6   # the two 2x3 cells (a, b) = (2, 3), (3, 2): age a + b + 1
MAX_N = 256  # the stacked tier; pallas_fold_long serves 512, 1024, 2048

inside_launches = _build.LaunchCounter("contra_inside")
outside_launches = _build.LaunchCounter("contra_outside")
turner_inside_launches = _build.LaunchCounter("turner_inside")
turner_outside_launches = _build.LaunchCounter("turner_outside")


def contra_prob_mats_merged(seqs, ns, ct, ln_sigma, N):
    """Merged probability-space tables, built in [p, q] log space, then
    exponentiated and skewed (kernel K3) to the [d, i] layout.

    Returns (mi, mo_pre, ACC_di, b0lo): the inside tables, the outside
    tables known before the inside pass, the raw ACC grid and the outside
    b0lo lane vector (B, N)."""
    pq, v_m1, v_x1 = PF.contra_pq_tables(seqs, ns, ct, N)
    LENlog = PF._contra_len_di(ct)
    len11_log = LENlog[1, 1]
    len10_log = LENlog[1, 0]
    len01_log = LENlog[0, 1]
    hp_cum = ct["hairpin_scores_len_cumulative"]
    MAXL = hp_cum.shape[0] - 1
    dev = seqs.device
    zero = torch.zeros((), device=dev)

    p = torch.arange(N, device=dev)[:, None]
    q = torch.arange(N, device=dev)[None, :]
    span = (q - p + 1).to(torch.float32)
    hlen = q - p - 1
    ls = ln_sigma.view(-1, 1, 1)
    ls1 = ln_sigma.view(-1, 1)
    canon = pq["CANON"]
    JS, JB = pq["JS"], pq["JB"]
    STK, I11 = pq["STK"], pq["I11"]
    vq2 = torch.where(q[0] + 2 < N, torch.roll(v_m1, -2, dims=1), zero)
    e = torch.exp
    tabs = {
        "H": canon * torch.where(
            (hlen >= 0) & (hlen <= MAXL),
            e(hp_cum[hlen.clamp(0, MAXL)] + JS - span * ls),
            zero,
        ),
        "MBC": canon * e(pq["MBC"] - 2.0 * ls),
        "ACC": e(pq["ACC"]),
        "JS": canon * e(JS),
        "STK": canon * e(STK - sh(JB, 1, -1) - 2.0 * ls),
        "I11": canon * e(JS + I11 + len11_log - 4.0 * ls),
        "B0R": canon * e(JS + v_m1[:, None, :] + len10_log - 3.0 * ls),
        "JB": e(JB),
        "STKO": e(sh(STK, -1, 1) - sh(JS, -1, 1) - 2.0 * ls),
        "I11O": e(JB + sh(I11, -2, 2) + len11_log - 4.0 * ls),
        "B0RO": e(JB + vq2[:, None, :] + len10_log - 3.0 * ls),
    }
    b0l_vec = e(v_x1 + len01_log - 3.0 * ls1)
    b0lo = e(v_m1 + len01_log - 3.0 * ls1)

    names = sorted(tabs)
    skewed = skew_pq_batch([tabs[k] for k in names])
    di = {
        k: v.transpose(1, 2).contiguous() for k, v in zip(names, skewed)
    }
    mbbp = torch.exp(ct["multibranch_score_basepair"])
    mi = {
        "H": di["H"],
        "MBC": di["MBC"],
        "ACC": di["ACC"],
        "JS": di["JS"],
        "STK": di["STK"],
        "I11": di["I11"],
        "B0R": di["B0R"],
        "B0L": di["JS"] * b0l_vec[:, None, :],
        "JB": di["JB"],
    }
    mo_pre = {
        "MBC": di["MBC"],
        "ACCMB": di["ACC"] * mbbp,
        "STKO": di["STKO"],
        "I11O": di["I11O"],
        "B0RO": di["B0RO"],
        "JRB": di["JB"],
        "JSN": di["JS"],
    }
    return mi, mo_pre, di["ACC"], b0lo


# ---------------------------------------------------------------------------
# K1: inside wavefront
# ---------------------------------------------------------------------------

def _window(K, rows, gidx):
    """sum_a (K @ rows)[a, gidx[a, i]]: one banded 2-loop window, (B, N)."""
    return torch.bmm(K, rows).gather(2, gidx).sum(1)


def _inside_plain(H, MBC, ACC, scal, ns, two_at, insert):
    """The inside recurrences K1 and K4 share, for the whole batch:
    (close, ext, one), each (B, N, N) [d, i], rows at or past each
    sequence's length zero.  ``two_at(d)`` is the 2-loop term of span d
    (B, N); ``insert(d, c)`` records span d's close for later windows."""
    B, N, _ = H.shape
    dev = H.device
    eu1, ebp, mbu1, mbbp = (scal[:, k:k + 1] for k in range(4))
    n_max = int(ns.max())
    zeros = functools.partial(torch.zeros, device=dev)
    close, ext, one = zeros(B, N, N), zeros(B, N, N), zeros(B, N, N)
    S2 = zeros(B, N, N + 1)           # s2 of span s at row s
    RMp, RMMp = zeros(B, N, 2 * N), zeros(B, N, 2 * N)
    EXTsh = zeros(B, N + 1, N)        # row t = ext(t - 1); row 0 = 1
    EXTsh[:, 0] = 1.0
    ONEsh = zeros(B, N + 1, N)        # row t = one(t - 1)
    S1 = zeros(B, N + 1)
    lanes = torch.arange(N, device=dev)
    rm_prev, rmmb_prev = zeros(B, N), zeros(B, N)
    epow = torch.ones((B, 1), device=dev)
    for d in range(n_max):
        two = two_at(d)
        mb_term = S2[:, d - 2, 1:N + 1] * MBC[:, d] if d >= 2 else 0.0
        c = H[:, d] + two + mb_term
        if d + 1 < MIN_SPAN_HAIRPIN_CLOSE:
            c = torch.zeros_like(c)
        close[:, d] = c
        acc = c * ACC[:, d]
        rm_new = rm_prev * eu1 + acc * ebp
        rmmb_new = rmmb_prev * mbu1 + acc * mbbp
        epow = epow * eu1
        RMp[:, d, :N] = rm_new
        RMMp[:, d, :N] = rmmb_new
        insert(d, c)
        if d >= 1:
            t = torch.arange(d, device=dev)
            rt, ct_ = (d - t)[:, None], lanes[None, :] + t[:, None]
            es = (RMp[:, rt, ct_] * EXTsh[:, :d]).sum(1)
            s2 = (RMMp[:, rt, ct_][:, 1:] * ONEsh[:, 1:d]).sum(1)
            rmm_nb = RMMp[:, d - 1, 1:N + 1]
        else:
            es = s2 = rmm_nb = zeros(B, N)
        ext_new = epow + es
        s1v = mbu1 * (rmm_nb + S1[:, 1:N + 1])
        S1[:, :N] = s1v
        one_new = rmmb_new + s1v + s2
        S2[:, d, :N] = s2
        ext[:, d] = ext_new
        one[:, d] = one_new
        EXTsh[:, d + 1] = ext_new
        ONEsh[:, d + 1] = one_new
        rm_prev, rmmb_prev = rm_new, rmmb_new
    live = lanes[None, :, None] < ns.to(dev).view(-1, 1, 1)
    z = torch.zeros((), device=dev)
    return (torch.where(live, close, z), torch.where(live, ext, z),
            torch.where(live, one, z))


class _InsideRing:
    """A plain-version window buffer: span s at row s + 32 (rows below 32
    are the spans < 0, zero), lanes 0..N-1 plus a 33-lane zero pad."""

    def __init__(self, B, N, dev):
        self.N = N
        self.buf = torch.zeros((B, N + 32, N + 33), device=dev)
        r32 = torch.arange(32, device=dev)
        self.r32 = r32
        lanes = torch.arange(N, device=dev)
        self.gidx = (lanes[None, :] + 1 + r32[:, None]).expand(B, 32, N)

    def window(self, K, d):
        """sum_{a, r} K[a, r] * row(span d-1-r, lane i+1+a)."""
        return _window(K, self.buf[:, d + 31 - self.r32], self.gidx)

    def at(self, d, age, off):
        """(B, N): span d - 1 - age at lanes i + off."""
        return self.buf[:, d + 31 - age, off:off + self.N]

    def put(self, d, row):
        self.buf[:, d + 32, :self.N] = row


def contra_inside_plain(mi, KW, scal, ns):
    """Plain version of K1 for the whole batch: (close, ext, one), each
    (B, N, N) [d, i], rows at or past each sequence's length zero."""
    H, MBC, ACC, JS, STK, I11, B0R, B0L, JB = (mi[k] for k in INSIDE_TABLES)
    B, N, _ = H.shape
    ins = _InsideRing(B, N, H.device)   # close*JB

    def two_at(d):
        two = JS[:, d] * ins.window(KW, d)
        two = two + STK[:, d] * ins.at(d, 1, 1)
        two = two + B0R[:, d] * ins.at(d, 2, 1)
        two = two + B0L[:, d] * ins.at(d, 2, 2)
        two = two + I11[:, d] * ins.at(d, 3, 2)
        return two

    def insert(d, c):
        ins.put(d, c * JB[:, d])

    return _inside_plain(H, MBC, ACC, scal, ns, two_at, insert)


def contra_block_threads(B, N):
    """(K1's, K2's) block size, the threads a sequence runs on, for a launch
    over B sequences at N <= 256 on the current CUDA device: of 1,024, 512
    and 256, the one that runs the batch in the fewest waves of resident
    blocks (``csrc/narrow.cuh`` ``rna_nw_threads``)."""
    lib = _build.library().lib
    return (lib.rna_contra_inside_threads(B, N),
            lib.rna_contra_outside_threads(B, N))


def contra_inside(mi, KW, scal, ns):
    """Kernel K1 (``csrc/contra_inside.cu``) for CUDA tensors, its plain
    version for CPU tensors.  ``mi``: the 9 merged (B, N, N) [d, i] inside
    tables; ``KW`` (B, 32, 32) window matrix; ``scal`` (B, 4); ``ns`` (B,)."""
    dev = mi["H"].device
    if dev.type == "cpu":
        return contra_inside_plain(mi, KW, scal, ns)
    if dev.type != "cuda":
        raise ValueError(f"contra_inside: no kernel for device {dev}")
    N = mi["H"].shape[1]
    if N > MAX_N or N % 32:
        raise ValueError(f"contra_inside: N = {N} (need N <= 256, N % 32 == 0)")
    out = _contra_inside_cuda(mi, KW, scal, ns)
    inside_launches.add()
    return out


def _prob_scratch(B, N, dev, count):
    """``count`` (B, N, N) history scratches of a probability wavefront
    kernel (rm and rmmb inside; pm, pm2 and g outside): the kernels write
    each cell they read before reading it, live cells only."""
    return tuple(torch.empty((B, N, N), device=dev) for _ in range(count))


def _contra_inside_cuda(mi, KW, scal, ns):
    """Check the inputs of the CONTRA inside kernel (K1 at N <= 256, K8
    past it) and launch it: (close, ext, one), zero at every dead cell
    (i + d >= n), which both skip."""
    entry = "rna_contra_inside"
    dev = mi["H"].device
    B, N, _ = mi["H"].shape
    ins = {k: mi[k] for k in INSIDE_TABLES}
    ins.update(KW=KW, scal=scal, ns=ns)
    shapes = {k: (B, N, N) for k in INSIDE_TABLES}
    shapes.update(KW=(B, 32, 32), scal=(B, 4), ns=(B,))
    _build.check_cuda(entry, ins, shapes, dev)
    close, ext, one = (torch.zeros((B, N, N), device=dev) for _ in range(3))
    rm, rmm = _prob_scratch(B, N, dev, 2)
    args = [ins[k] for k in INSIDE_TABLES] + [
        KW, scal, ns, close, ext, one, rm, rmm]
    _build.library().call(
        entry, *[_build.ptr(t) for t in args], B, N, _build.stream_ptr(dev),
    )
    return close, ext, one


# ---------------------------------------------------------------------------
# K2: outside wavefront
# ---------------------------------------------------------------------------

def _outside_plain(CLOSE, MBC, ACCB, ACCMB, one, QONE, extR, scal, ns,
                   min_span, two_at, insert):
    """The outside recurrences K2 and K5 share, for the whole batch: bppo
    (B, N, N) [d, i].  ``two_at(d)`` is the 2-loop context of span d before
    the factor close; ``insert(d, bp, inv_close)`` records span d for later
    windows."""
    B, N, _ = CLOSE.shape
    dev = CLOSE.device
    mbu1 = scal[:, 2:3]
    n_max = int(ns.max())
    zeros = functools.partial(torch.zeros, device=dev)
    z = torch.zeros((), device=dev)
    bppo = zeros(B, N, N)
    Gt = zeros(B, N + 1, N)           # g of span s at row s
    ONEpad = torch.cat([one, zeros(B, N, N)], dim=2)
    PMp, PM2p = zeros(B, N + 1, 2 * N), zeros(B, N + 1, 2 * N)  # lane N + l
    lanes = torch.arange(N, device=dev)
    # pm at lane l of span d sums the live terms t < n - 2 - d - l only, so
    # no one cell past a sequence's end is read (the long kernels leave
    # those unwritten; tests/test_torch_long_deadcells.py)
    tl = lanes[:, None] + lanes[None, :]     # [t, l]
    n_b = ns.to(dev).view(-1, 1, 1)
    qa = zeros(B, N)
    p2prev = zeros(B, N)
    for d in range(n_max - 1, -1, -1):
        span_ok = d + 1 >= min_span
        c = CLOSE[:, d]
        # a subnormal close counts as 0, as where XLA flushes subnormals:
        # its reciprocal would overflow
        pos = c >= PP.FLT_MIN
        inv_close = torch.where(pos, 1.0 / torch.where(pos, c, 1.0), z)
        basev = c * ACCB[:, d] * extR[:, d + 1:d + 1 + N]
        two = two_at(d) * c
        acc_mb = c * ACCMB[:, d]
        T = N - 2 - d
        if T > 0:
            terms = Gt[:, d + 2:d + 2 + T] * ONEpad[:, :T, d + 1:d + 1 + N]
            pm = torch.where(tl[:T] < n_b - 2 - d, terms, z).sum(1)
        else:
            pm = zeros(B, N)
        pm_new = pm if span_ok else zeros(B, N)
        pm2_raw = Gt[:, d + 1] + mbu1 * p2prev
        p2prev = pm2_raw
        pm2_new = pm2_raw if span_ok else zeros(B, N)
        qa = torch.cat(
            [zeros(B, 1), PMp[:, d + 1, N:2 * N - 1] + mbu1 * qa[:, :N - 1]],
            dim=1,
        )
        T2 = N - 1 - d
        if T2 > 0:
            t = torch.arange(1, T2 + 1, device=dev)
            rt, ct_ = (d + t)[:, None], N + lanes[None, :] - t[:, None]
            qo = QONE[:, 1:T2 + 1]
            sa = (PM2p[:, rt, ct_] * qo).sum(1)
            sbc = (PMp[:, rt, ct_] * qo).sum(1)
        else:
            sa = sbc = zeros(B, N)
        mb_ctx = acc_mb * (sa + sbc + qa)
        bp = basev + two + mb_ctx
        if not span_ok:
            bp = torch.zeros_like(bp)
        bp = torch.where(pos, bp, z)
        bppo[:, d] = bp
        insert(d, bp, inv_close)
        Gt[:, d] = bp * MBC[:, d] * inv_close
        PMp[:, d, N:] = pm_new
        PM2p[:, d, N:] = pm2_new
    return bppo


class _OutsideRing:
    """A plain-version outside window buffer: span s at row s, lanes at
    32 + l (32 zero lanes to the left); rows >= N stay zero."""

    def __init__(self, B, N, dev):
        self.N = N
        self.buf = torch.zeros((B, N + 32, N + 32), device=dev)
        r32 = torch.arange(32, device=dev)
        lanes = torch.arange(N, device=dev)
        self.gidx = (lanes[None, :] + 31 - r32[:, None]).expand(B, 32, N)

    def window(self, K, d):
        """sum_{a, r} K[a, r] * row(span d+1+r, lane i-1-a)."""
        return _window(K, self.buf[:, d + 1:d + 33], self.gidx)

    def at(self, d, age, off):
        """(B, N): span d + 1 + age at lanes i - off."""
        return self.buf[:, d + 1 + age, 32 - off:32 - off + self.N]

    def put(self, d, row):
        self.buf[:, d, 32:] = row


def contra_outside_plain(mo, one, QONE, extR, b0lo, KW, scal, ns, min_span):
    """Plain version of K2 for the whole batch: bppo (B, N, N) [d, i]."""
    (CLOSE, MBC, ACCB, ACCMB, STKO, I11O, B0RO, JRB, JSN) = (
        mo[k] for k in OUTSIDE_TABLES
    )
    B, N, _ = CLOSE.shape
    g2 = _OutsideRing(B, N, CLOSE.device)   # bppo*JSN/close

    def two_at(d):
        jrb = JRB[:, d]
        two = jrb * g2.window(KW, d)
        two = two + STKO[:, d] * g2.at(d, 1, 1)
        two = two + B0RO[:, d] * g2.at(d, 2, 1)
        two = two + jrb * b0lo * g2.at(d, 2, 2)
        two = two + I11O[:, d] * g2.at(d, 3, 2)
        return two

    def insert(d, bp, inv_close):
        g2.put(d, bp * JSN[:, d] * inv_close)

    return _outside_plain(CLOSE, MBC, ACCB, ACCMB, one, QONE, extR, scal,
                          ns, min_span, two_at, insert)


def contra_outside(mo, one, QONE, extR, b0lo, KW, scal, ns, min_span):
    """Kernel K2 (``csrc/contra_outside.cu``) for CUDA tensors, its plain
    version for CPU tensors.  ``mo``: the 9 merged (B, N, N) outside
    tables; ``one`` the inside one-table; ``QONE`` (B, N, N); ``extR``
    (B, 2N); ``b0lo`` (B, N); ``KW`` (B, 32, 32); ``scal`` (B, 4);
    ``ns`` (B,)."""
    dev = one.device
    if dev.type == "cpu":
        return contra_outside_plain(
            mo, one, QONE, extR, b0lo, KW, scal, ns, min_span
        )
    if dev.type != "cuda":
        raise ValueError(f"contra_outside: no kernel for device {dev}")
    N = one.shape[1]
    if N > MAX_N or N % 32:
        raise ValueError(f"contra_outside: N = {N} (need N <= 256, N % 32 == 0)")
    bppo = _contra_outside_cuda(mo, one, QONE, extR, b0lo, KW, scal, ns,
                                min_span)
    outside_launches.add()
    return bppo


def _contra_outside_cuda(mo, one, QONE, extR, b0lo, KW, scal, ns, min_span):
    """Check the inputs of the CONTRA outside kernel (K2 at N <= 256, K9
    past it) and launch it: bppo."""
    entry = "rna_contra_outside"
    dev = one.device
    B, N, _ = one.shape
    ins = {k: mo[k] for k in OUTSIDE_TABLES}
    ins.update(ONE=one, QONE=QONE, EXTR=extR, B0LO=b0lo, KW=KW, scal=scal,
               ns=ns)
    shapes = {k: (B, N, N) for k in OUTSIDE_TABLES + ("ONE", "QONE")}
    shapes.update(EXTR=(B, 2 * N), B0LO=(B, N), KW=(B, 32, 32), scal=(B, 4),
                  ns=(B,))
    _build.check_cuda(entry, ins, shapes, dev)
    bppo = torch.zeros((B, N, N), device=dev)
    pm, pm2, g = _prob_scratch(B, N, dev, 3)
    args = [ins[k] for k in OUTSIDE_TABLES] + [
        one, QONE, extR, b0lo, KW, scal, ns, bppo, pm, pm2, g]
    _build.library().call(
        entry, *[_build.ptr(t) for t in args], B, N, int(min_span),
        _build.stream_ptr(dev),
    )
    return bppo


# ---------------------------------------------------------------------------
# Turner: merged tables, K4 (inside) and K5 (outside)
# ---------------------------------------------------------------------------

def _turner_merge_inside(pmats):
    """Fold CANON and the outer-terminal-mismatch * aug products into the
    [d, i] inside tables (``_turner_merge_inside``)."""
    canon = pmats["CANON"]
    augc = pmats["AUGT"] * canon
    return {
        "H": pmats["H"] * canon,
        "MBC": pmats["MBC"] * canon,
        "ACC": pmats["ACC"],
        "AUGC": augc,
        "TMO1C": pmats["TMo1"] * augc,
        "TMO2C": pmats["TMo2"] * augc,
        "TMO3C": pmats["TMo3"] * augc,
        "SP00": pmats["STKT"] * canon,
        "SP01": pmats["B01"] * canon,
        "SP10": pmats["B10"] * canon,
        "SP11": pmats["I11T"] * canon,
        "SP12": pmats["I12T"] * canon,
        "SP21": pmats["I21T"] * canon,
        "SP22": pmats["I22T"] * canon,
        "AUGT": pmats["AUGT"],
        "TMI1": pmats["TMi1"],
        "TMI2": pmats["TMi2"],
        "TMI3": pmats["TMi3"],
    }


def _turner_merge_outside(close, pmats, extL, glob, mbbp):
    """The [d, i] outside tables (``_turner_merge_outside``); ``close`` is
    the inside close table."""
    aug = pmats["AUGT"]
    inv_glob = (1.0 / glob)[:, None, None]
    return {
        "CLOSE": close,
        "MBC": pmats["MBC"],
        "ACCB": pmats["ACC"] * extL[:, None, :] * inv_glob,
        "ACCMB": pmats["ACC"] * mbbp[:, None, None],
        "AUGT": aug,
        "TMI1C": pmats["TMi1"] * aug,
        "TMI2C": pmats["TMi2"] * aug,
        "TMI3C": pmats["TMi3"] * aug,
        "SP00": pmats["STKO"],
        "SP01": pmats["B01O"],
        "SP10": pmats["B10O"],
        "SP11": pmats["I11O"],
        "SP12": pmats["I12O"],
        "SP21": pmats["I21O"],
        "SP22": pmats["I22O"],
        "TMO1": pmats["TMo1"],
        "TMO2": pmats["TMo2"],
        "TMO3": pmats["TMo3"],
    }


def turner_inside_plain(mi, KT, scal, ns):
    """Plain version of K4 for the whole batch: (close, ext, one), each
    (B, N, N) [d, i], rows at or past each sequence's length zero.

    ``KT`` (B, 3, 32, 32) holds the window matrices (KI, KB, K2); ``scal``
    (B, 6) is ``_turner_scal_rows``.  Window rings: g = close*AUGT (bulges
    and the small-loop cells), g*TMI1 (generic interior), g*TMI2 (1xn and
    2x3-edge arms), g*TMI3 (the two 2x3 cells)."""
    B, N, _ = mi["H"].shape
    dev = mi["H"].device
    l32, l23 = scal[:, 4:5], scal[:, 5:6]
    KI, KB, K2 = KT[:, 0], KT[:, 1], KT[:, 2]
    caw, gw1, gw2, gw3 = (_InsideRing(B, N, dev) for _ in range(4))

    def two_at(d):
        two = mi["TMO1C"][:, d] * gw1.window(KI, d)
        two = two + mi["AUGC"][:, d] * caw.window(KB, d)
        two = two + mi["TMO2C"][:, d] * gw2.window(K2, d)
        two = two + mi["TMO3C"][:, d] * (
            l32 * gw3.at(d, TM3_AGE, 3) + l23 * gw3.at(d, TM3_AGE, 4)
        )
        for name, age, off in TURNER_SPECIALS:
            two = two + mi[name][:, d] * caw.at(d, age, off)
        return two

    def insert(d, c):
        g = c * mi["AUGT"][:, d]
        caw.put(d, g)
        gw1.put(d, g * mi["TMI1"][:, d])
        gw2.put(d, g * mi["TMI2"][:, d])
        gw3.put(d, g * mi["TMI3"][:, d])

    return _inside_plain(mi["H"], mi["MBC"], mi["ACC"], scal, ns, two_at,
                         insert)


def turner_inside(mi, KT, scal, ns):
    """Kernel K4 (``csrc/turner_inside.cu``) for CUDA tensors, its plain
    version for CPU tensors.  ``mi``: the 18 merged (B, N, N) [d, i] inside
    tables; ``KT`` (B, 3, 32, 32); ``scal`` (B, 6); ``ns`` (B,)."""
    dev = mi["H"].device
    if dev.type == "cpu":
        return turner_inside_plain(mi, KT, scal, ns)
    if dev.type != "cuda":
        raise ValueError(f"turner_inside: no kernel for device {dev}")
    N = mi["H"].shape[1]
    if N > MAX_N or N % 32:
        raise ValueError(f"turner_inside: N = {N} (need N <= 256, N % 32 == 0)")
    out = _turner_inside_cuda(mi, KT, scal, ns)
    turner_inside_launches.add()
    return out


def turner_block_threads(B, N):
    """(K4's, K5's) block size, the threads a sequence runs on, for a launch
    over B sequences at N <= 256 on the current CUDA device, by K1's rule
    (``contra_block_threads``)."""
    lib = _build.library().lib
    return (lib.rna_turner_inside_threads(B, N),
            lib.rna_turner_outside_threads(B, N))


def _turner_inside_cuda(mi, KT, scal, ns):
    """Check the inputs of the Turner inside kernel (K4 at N <= 256, K12
    past it) and launch it: (close, ext, one), zero at every dead cell
    (i + d >= n), which both skip."""
    entry = "rna_turner_inside"
    dev = mi["H"].device
    B, N, _ = mi["H"].shape
    ins = {k: mi[k] for k in TURNER_INSIDE_TABLES}
    ins.update(KT=KT, scal=scal, ns=ns)
    shapes = {k: (B, N, N) for k in TURNER_INSIDE_TABLES}
    shapes.update(KT=(B, 3, 32, 32), scal=(B, 6), ns=(B,))
    _build.check_cuda(entry, ins, shapes, dev)
    close, ext, one = (torch.zeros((B, N, N), device=dev) for _ in range(3))
    rm, rmm = _prob_scratch(B, N, dev, 2)
    args = [KT, scal, ns, close, ext, one, rm, rmm]
    _build.library().call(
        entry, _build.ptr_array(ins, TURNER_INSIDE_TABLES),
        *[_build.ptr(t) for t in args], B, N, _build.stream_ptr(dev),
    )
    return close, ext, one


def turner_outside_plain(mo, one, QONE, extR, KT, scal, ns, min_span):
    """Plain version of K5 for the whole batch: bppo (B, N, N) [d, i].

    Window rings, lanes descending: g2 = bppo*AUGT/close, g2*TMO1, g2*TMO2,
    g2*TMO3, read with the inner-pair factors AUGT, TMI1C, TMI2C, TMI3C."""
    B, N, _ = mo["CLOSE"].shape
    dev = mo["CLOSE"].device
    l32, l23 = scal[:, 4:5], scal[:, 5:6]
    KI, KB, K2 = KT[:, 0], KT[:, 1], KT[:, 2]
    og, gw1, gw2, gw3 = (_OutsideRing(B, N, dev) for _ in range(4))

    def two_at(d):
        two = mo["TMI1C"][:, d] * gw1.window(KI, d)
        two = two + mo["AUGT"][:, d] * og.window(KB, d)
        two = two + mo["TMI2C"][:, d] * gw2.window(K2, d)
        two = two + mo["TMI3C"][:, d] * (
            l32 * gw3.at(d, TM3_AGE, 3) + l23 * gw3.at(d, TM3_AGE, 4)
        )
        for name, age, off in TURNER_SPECIALS:
            two = two + mo[name][:, d] * og.at(d, age, off)
        return two

    def insert(d, bp, inv_close):
        g2 = bp * mo["AUGT"][:, d] * inv_close
        og.put(d, g2)
        gw1.put(d, g2 * mo["TMO1"][:, d])
        gw2.put(d, g2 * mo["TMO2"][:, d])
        gw3.put(d, g2 * mo["TMO3"][:, d])

    return _outside_plain(mo["CLOSE"], mo["MBC"], mo["ACCB"], mo["ACCMB"],
                          one, QONE, extR, scal, ns, min_span, two_at, insert)


def turner_outside(mo, one, QONE, extR, KT, scal, ns, min_span):
    """Kernel K5 (``csrc/turner_outside.cu``) for CUDA tensors, its plain
    version for CPU tensors.  ``mo``: the 18 merged (B, N, N) outside
    tables; ``one`` the inside one-table; ``QONE`` (B, N, N); ``extR``
    (B, 2N); ``KT`` (B, 3, 32, 32); ``scal`` (B, 6); ``ns`` (B,)."""
    dev = one.device
    if dev.type == "cpu":
        return turner_outside_plain(mo, one, QONE, extR, KT, scal, ns,
                                    min_span)
    if dev.type != "cuda":
        raise ValueError(f"turner_outside: no kernel for device {dev}")
    N = one.shape[1]
    if N > MAX_N or N % 32:
        raise ValueError(f"turner_outside: N = {N} (need N <= 256, N % 32 == 0)")
    bppo = _turner_outside_cuda(mo, one, QONE, extR, KT, scal, ns, min_span)
    turner_outside_launches.add()
    return bppo


def _turner_outside_cuda(mo, one, QONE, extR, KT, scal, ns, min_span):
    """Check the inputs of the Turner outside kernel (K5 at N <= 256, K13
    past it) and launch it: bppo, zero at every dead cell (i + d >= n),
    which both skip."""
    entry = "rna_turner_outside"
    dev = one.device
    B, N, _ = one.shape
    ins = {k: mo[k] for k in TURNER_OUTSIDE_TABLES}
    ins.update(ONE=one, QONE=QONE, EXTR=extR, KT=KT, scal=scal, ns=ns)
    shapes = {k: (B, N, N) for k in TURNER_OUTSIDE_TABLES + ("ONE", "QONE")}
    shapes.update(EXTR=(B, 2 * N), KT=(B, 3, 32, 32), scal=(B, 6), ns=(B,))
    _build.check_cuda(entry, ins, shapes, dev)
    bppo = torch.zeros((B, N, N), device=dev)
    pm, pm2, g = _prob_scratch(B, N, dev, 3)
    args = [one, QONE, extR, KT, scal, ns, bppo, pm, pm2, g]
    _build.library().call(
        entry, _build.ptr_array(ins, TURNER_OUTSIDE_TABLES),
        *[_build.ptr(t) for t in args], B, N, int(min_span),
        _build.stream_ptr(dev),
    )
    return bppo


# ---------------------------------------------------------------------------
# One fixed-scale run and the rescale-retry loop
# ---------------------------------------------------------------------------

def _prob8_run_body(seqs, ns, ct, ln_sigma, N, allows_short_hairpins,
                    inside=None, outside=None):
    """Fixed-``ln_sigma`` inside + outside: (bppo [d, i], glob).  ``inside``
    and ``outside`` are the kernel wrappers, K1 and K2 unless given (the
    long tier passes K8 and K9)."""
    inside = inside or contra_inside
    outside = outside or contra_outside
    mi, mo_pre, ACC_di, b0lo = contra_prob_mats_merged(
        seqs, ns, ct, ln_sigma, N
    )
    KW = PP._banded_window_kernel(PP._contra_len_prob(ct, ln_sigma))
    scal = PP._scal_rows(ct, ln_sigma)
    close, ext, one = inside(mi, KW, scal, ns)
    QONE, extL, extR, glob = PF.contra_outside_aux(ns, ext, one, N)
    ebp = scal[:, 1]
    mo = dict(mo_pre)
    mo["ACCB"] = (
        ACC_di * extL[:, None, :] * (1.0 / glob)[:, None, None]
        * ebp[:, None, None]
    )
    mo["CLOSE"] = close
    min_span = 2 if allows_short_hairpins else MIN_SPAN_HAIRPIN_CLOSE
    bppo = outside(mo, one, QONE, extR, b0lo, KW, scal, ns, min_span)
    return bppo, glob


def mccaskill_contra_prob(seqs, ns, ct, N, allows_short_hairpins=False):
    """Scaled-probability CONTRA McCaskill with rescale retries
    (``mccaskill_contra_pallas_prob8``).  ``seqs`` (B, N) int64 and ``ns``
    (B,) int32 on the device that runs it.  Returns (bppo [d, i] basepair
    probabilities, ln_sigma per sequence)."""
    if N > MAX_N:
        raise ValueError(f"stacked tier: N = {N} > {MAX_N} (the long tiers "
                         "are ops.pallas_fold_long)")

    def run(ls):
        return _prob8_run_body(seqs, ns, ct, ls, N, allows_short_hairpins)

    return PP._retrying(run, ns)


def _turner_prob8_run_body(seqs, ns, tt, ln_sigma, N, inside=None,
                           outside=None):
    """Fixed-``ln_sigma`` Turner inside + outside: (bppo [d, i], glob);
    the kernel wrappers K4 and K5 unless given (the long tier passes K12
    and K13)."""
    inside = inside or turner_inside
    outside = outside or turner_outside
    pmats = PP.turner_prob_mats(seqs, ns, tt, ln_sigma, N)
    LENBp, LENIp = PP._turner_len_prob(tt, ln_sigma)
    KB, K2, KI = PP._turner_banded_kernels(LENBp, LENIp)
    KT = torch.stack([KI, KB, K2], dim=1).contiguous()
    scal = PP._turner_scal_rows(tt, ln_sigma, LENIp)
    mi = {k: v.contiguous() for k, v in _turner_merge_inside(pmats).items()}
    close, ext, one = inside(mi, KT, scal, ns)
    QONE, extL, extR, glob = PF.contra_outside_aux(ns, ext, one, N)
    mo = _turner_merge_outside(close, pmats, extL, glob, scal[:, 3])
    mo = {k: v.contiguous() for k, v in mo.items()}
    bppo = outside(mo, one, QONE, extR, KT, scal, ns, MIN_SPAN_HAIRPIN_CLOSE)
    return bppo, glob


def mccaskill_turner_prob(seqs, ns, tt, N):
    """Scaled-probability Turner McCaskill with rescale retries seeded at
    LN_SIGMA0_TURNER (``mccaskill_turner_pallas_prob8``).  ``seqs`` (B, N)
    int64 and ``ns`` (B,) int32 on the device that runs it.  Returns
    (bppo [d, i] basepair probabilities, ln_sigma per sequence)."""
    if N > MAX_N:
        raise ValueError(f"stacked tier: N = {N} > {MAX_N} (the long tiers "
                         "are ops.pallas_fold_long)")

    def run(ls):
        return _turner_prob8_run_body(seqs, ns, tt, ls, N)

    return PP._retrying(run, ns, ls0=PP.LN_SIGMA0_TURNER)
