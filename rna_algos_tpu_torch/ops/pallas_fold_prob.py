"""Scaled probability-space helpers (``rna_algos_tpu.ops.pallas_fold_prob``).

The scale constants, the CONTRA and Turner 2-loop length matrices and
their banded forms, the Turner score transform, the per-sequence scalar
rows and the rescale-retry loop.  A state covering span s stores
Z * sigma^-s for a per-sequence ``ln_sigma``; sequences whose scaled
partition function leaves [GLOB_LO, GLOB_HI] re-run at a corrected scale
(``_retrying``).
"""

import torch

from . import pallas_fold as PF
from .pallas_fold import W, W2, _contra_len_di

LN_SIGMA0 = 0.9          # initial per-base scale (CONTRA; typical folded RNA)
LN_SIGMA0_TURNER = 0.5   # Turner per-base log-Z is lower (~0.35 random,
                         # ~0.5-0.7 structured)
RETRY_STEP = 0.9         # ln_sigma bisection step on over/underflow
MAX_RETRIES = 10
# Scaled-Z guard band: anything outside [GLOB_LO, GLOB_HI] re-runs (a
# partition function near the float32 denormal cliff silently flushes the
# small outside intermediates).
GLOB_LO = 1e-24
GLOB_HI = 1e24
FLT_MIN = float(torch.finfo(torch.float32).tiny)   # smallest normal float32


def _contra_len_prob(ct, ln_sigma):
    """(B, W2, W) [b, a] 2-loop length constants exp(LEN - (a+b+2)*ln_s)."""
    base = _contra_len_di(ct)
    dev = base.device
    ab = (
        torch.arange(W2, dtype=torch.float32, device=dev)[:, None]
        + torch.arange(W, dtype=torch.float32, device=dev)[None, :]
        + 2.0
    )
    return torch.exp(base[None] - ab[None] * ln_sigma[:, None, None])


def _banded_kernel(LENp, keep):
    """(B, 32, 32) banded matrix K[a, r] = LEN[r-a-1, a] on keep(a, b)."""
    dev = LENp.device
    a_i = torch.arange(32, device=dev)[:, None]
    r_i = torch.arange(32, device=dev)[None, :]
    b_v = r_i - a_i - 1
    valid = (b_v >= 0) & (b_v <= 30 - a_i) & (a_i <= 30) & keep(a_i, b_v)
    bs = b_v.clamp(0, W2 - 1)
    as_ = torch.broadcast_to(a_i.clamp(0, W - 1), bs.shape)
    gathered = LENp[:, bs, as_]
    return torch.where(valid[None], gathered, torch.zeros((), device=dev))


# The 2-loop cells (a, b) the kernels add as separate terms (stack, bulge
# 0x1 / 1x0, interior 1x1), left out of the window matrix.
SPECIALS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _banded_window_kernel(LENp):
    """CONTRA window matrix: the full band minus the 4 special cells."""

    def keep(a_i, b_v):
        v = torch.ones(torch.broadcast_shapes(a_i.shape, b_v.shape),
                       dtype=torch.bool, device=a_i.device)
        for (sa, sb) in SPECIALS:
            v = v & ~((a_i == sa) & (b_v == sb))
        return v

    return _banded_kernel(LENp, keep)


def _scal_rows(ct, ln_sigma):
    """(B, 4) per-sequence scalars of both kernels: [eu1, ebp, mbu1, mbbp]
    (the first four columns of the JAX package's scalar rows)."""
    B = ln_sigma.shape[0]
    eu1 = torch.exp(ct["external_score_unpair"] - ln_sigma)
    ebp = torch.exp(ct["external_score_basepair"]).expand(B)
    mbu1 = torch.exp(ct["multibranch_score_unpair"] - ln_sigma)
    mbbp = torch.exp(ct["multibranch_score_basepair"]).expand(B)
    return torch.stack([eu1, ebp, mbu1, mbbp], dim=1).to(torch.float32)


# Turner: the recurrences are the CONTRA ones with eu = ebp = mbu = 0 and
# mbbp = COEFF_NUM_BRANCHES; only the 2-loop window and the score transform
# differ.  (a + b + 2) span powers of the small-loop replacement tables,
# which bypass the LEN' path that carries the power of generic cells:
_TURNER_SP_POW = {
    "STKT": 2, "B01": 3, "B10": 3, "I11T": 4, "I12T": 5, "I21T": 5,
    "I22T": 6,
    "STKO": 2, "B01O": 3, "B10O": 3, "I11O": 4, "I12O": 5, "I21O": 5,
    "I22O": 6,
}


def turner_prob_mats(seqs, ns, tt, ln_sigma, N):
    """(B, N, N) [d, i] probability-space Turner tables, the span powers
    of ``ln_sigma`` (B,) folded in."""
    m = PF.turner_precompute_di(seqs, ns, tt, N)
    dev = seqs.device
    spanv = (torch.arange(N, dtype=torch.float32, device=dev) + 1.0)[:, None]
    ls = ln_sigma.view(-1, 1, 1)
    out = {
        "H": torch.exp(m["H"] - spanv * ls),
        "MBC": torch.exp(m["MBC"] - 2.0 * ls),
        "CANON": torch.where(m["CANON"] > -1.0, 1.0, 0.0),
    }
    for k in ("ACC", "AUGT", "TMo1", "TMo2", "TMo3", "TMi1", "TMi2", "TMi3"):
        out[k] = torch.exp(m[k])
    for k, p in _TURNER_SP_POW.items():
        out[k] = torch.exp(m[k] - float(p) * ls)
    return out


def _turner_len_prob(tt, ln_sigma):
    """(B, W2, W) exp(LENB - (a+b+2)*ln_s), exp(LENI - (a+b+2)*ln_s)."""
    LENB, LENI = PF._turner_len_di(tt)
    dev = LENB.device
    ab = (
        torch.arange(W2, dtype=torch.float32, device=dev)[:, None]
        + torch.arange(W, dtype=torch.float32, device=dev)[None, :]
        + 2.0
    )
    f = ab[None] * ln_sigma[:, None, None]
    return torch.exp(LENB[None] - f), torch.exp(LENI[None] - f)


def _turner_banded_kernels(LENBp, LENIp):
    """Turner window matrices (KB, K2, KI), each (B, 32, 32): bulges, the
    1xn / 2x3-edge interior arms and the generic interior."""
    KB = _banded_kernel(
        LENBp,
        lambda a, b: ((a == 0) & (b >= 2)) | ((a >= 2) & (b == 0)),
    )
    K2 = _banded_kernel(
        LENIp,
        lambda a, b: ((a == 1) & (b >= 3)) | ((a >= 3) & (b == 1)),
    )
    KI = _banded_kernel(
        LENIp,
        lambda a, b: (
            ((a == 2) & (b >= 4)) | ((a == 3) & (b >= 3))
            | ((a >= 4) & (b >= 2))
        ),
    )
    return KB, K2, KI


def _turner_scal_rows(tt, ln_sigma, LENIp):
    """(B, 6) per-sequence scalars of the Turner kernels: [u, 1, u,
    exp(coeff_num_branches), LENI'[3, 2], LENI'[2, 3]] with u =
    exp(-ln_sigma), the last two the scaled TM3 cell constants."""
    B = ln_sigma.shape[0]
    u = torch.exp(-ln_sigma)
    ones = torch.ones_like(u)
    coeffp = torch.exp(tt["coeff_num_branches"]).expand(B)
    return torch.stack(
        [u, ones, u, coeffp, LENIp[:, 3, 2], LENIp[:, 2, 3]], dim=1
    ).to(torch.float32).contiguous()


def _flags(bppo, glob):
    """(bad_hi, bad_lo) per sequence.  Underflow evidence wins: glob == 0
    makes 1/glob (and the bppo sum) non-finite, and reading that as
    overflow would walk ln_sigma the wrong way."""
    s = bppo.sum(dim=(1, 2))
    bad_lo = torch.isfinite(glob) & (glob < GLOB_LO)
    bad_hi = (
        ~torch.isfinite(glob) | (glob > GLOB_HI)
        | (~torch.isfinite(s) & ~bad_lo)
    )
    return bad_hi, bad_lo


# Per-base log-Z grows slightly with length (longer-range pairs engage);
# the float64 oracle puts the drift from a 512-nt prefix to ~1000 nt at
# +0.013 (CONTRA) / +0.035 (Turner) on random sequences, so the prefix seed
# is centred on the expected full-length value.
LS_PREFIX_DRIFT = 0.013
LS_PREFIX_DRIFT_TURNER = 0.035
# Lanes longer than this start the blind walk at the band half-width.
LONG_N = 512
LONG_STEP_WIDTH = 55.0   # first step min(RETRY_STEP, 55/n)
LONG_STEP_GROWTH = 1.5   # per same-direction step


def _estimate_ls0(run_small, ns_small, base, drift=0.0):
    """Per-sequence ln_sigma seed from one run over a truncated prefix
    (``_estimate_ls0``): at N > 256 the representable band is only ~+-55/n
    wide in ln_sigma, and every retry re-runs the whole batch.  The prefix
    pass at ``base`` measures each sequence's per-base log-Z, ``drift``
    centres it on the full length.  A prefix whose scaled Z is 0 or not
    finite keeps ``base`` (a subnormal counts as 0, as in ``_retrying``)."""
    f32 = torch.float32
    B, dev = ns_small.shape[0], ns_small.device
    ls0 = torch.full((B,), base, dtype=f32, device=dev)
    _bppo, glob = run_small(ls0)
    ok = torch.isfinite(glob) & (glob >= FLT_MIN)
    nf = ns_small.to(f32).clamp(min=1.0)
    z = drift + ls0 + torch.log(torch.where(ok, glob, torch.ones_like(glob))) / nf
    return torch.where(ok, z, ls0)


def _retrying(run, ns, ls0=None, jump=True):
    """Rescale-retry loop around a (ln_sigma,) -> (bppo, glob) run for
    sequences of lengths ``ns`` (B,), seeded at ``ls0``: a scalar, a (B,)
    tensor (the prefix seed of ``_estimate_ls0``) or None for LN_SIGMA0
    (the Turner paths pass LN_SIGMA0_TURNER).

    A host loop that syncs once per iteration (``any()``) with the JAX
    loop's logic: sequences whose scaled Z left the guard band re-run; a
    finite normal glob jumps straight to ln(glob)/n, a 0/inf one walks,
    halving its step on a direction flip; at most MAX_RETRIES iterations.
    The walk starts at RETRY_STEP, or for lanes of n > 512 at
    min(RETRY_STEP, 55/n), growing 1.5x per same-direction step (their
    band is too narrow for the fixed step).  ``jump=False`` is the JAX
    loop called without ``ns`` (the Durbin pair-HMM): every bad lane walks
    from RETRY_STEP, no jump and no long-n growth; ``ns`` then only sizes
    the batch.  Returns (bppo, ln_sigma)."""
    f32 = torch.float32
    B, dev = ns.shape[0], ns.device
    nf = ns.to(f32).clamp(min=1.0)
    if torch.is_tensor(ls0):
        ls = ls0.to(device=dev, dtype=f32).expand(B).clone()
    else:
        seed = LN_SIGMA0 if ls0 is None else ls0
        ls = torch.full((B,), seed, dtype=f32, device=dev)
    bppo, glob = run(ls)
    bh, bl = _flags(bppo, glob)
    longn = (nf > LONG_N) & jump
    step = torch.where(longn, (LONG_STEP_WIDTH / nf).clamp(max=RETRY_STEP),
                       torch.full((B,), RETRY_STEP, dtype=f32, device=dev))
    grow = torch.where(longn, LONG_STEP_GROWTH, 1.0).to(f32)
    last_dir = torch.zeros((B,), dtype=f32, device=dev)
    k = 0
    while k < MAX_RETRIES and bool((bh | bl).any()):
        bad = bh | bl
        direction = bh.to(f32) - bl.to(f32)
        step = torch.where(direction * last_dir < 0, step * 0.5,
                           torch.where(last_dir != 0, step * grow, step))
        # a subnormal glob counts as 0 (walk, no jump): XLA flushes
        # subnormals to zero on the TPU and the CPU, so the JAX loop never
        # jumps from one
        can_jump = bad & torch.isfinite(glob) & (glob >= FLT_MIN) & jump
        to_band = torch.log(torch.where(can_jump, glob,
                                        torch.ones_like(glob))) / nf
        ls = ls + torch.where(can_jump, to_band, step * direction)
        bppo, glob = run(ls)
        bh, bl = _flags(bppo, glob)
        last_dir = direction
        k += 1
    return bppo, ls
