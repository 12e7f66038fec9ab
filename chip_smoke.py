"""GPU smoke run of the PyTorch / CUDA port (rna_algos_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU and nvcc.  Phases, each fatal on failure:

1. card name and power limit, the kernels' nvcc build from csrc/ (one
   nvcc per source, in parallel);
2. each kernel against its plain PyTorch version on the card (K3 bitwise in
   both directions, also on the Turner precompute's 18 tables at once; K1,
   K2 (CONTRA) and K4, K5 (Turner) within stated tolerances at N = 128,
   B = 64 and N = 256, B = 32, on the live cells (i + d < n) with their
   dead cells exactly 0, also on edge batches at each bucket <= 256 of the
   probability path (n = 1-5, just past a power of two, n = N) and with
   NaN in every dead input cell and scratch word, each launch's block size
   printed; the long tier's K8, K9 (CONTRA) and K12, K13
   (Turner), the same four sources launched past N = 256 as a cluster of
   blocks per sequence, at N = 512, B = 8 and N = 1024, B = 4, and K8, K9
   also at N = 2048, B = 2, the main paths' N = 512, B = 32, N = 1024,
   B = 16 (and CONTRA's N = 2048, B = 8; Turner's prefix pass N = 512,
   B = 16), and N = 512, B = 80 (more clusters than fit at once: waves),
   each launch's cluster size printed, compared on the live cells
   (i + d < n) with their dead cells exactly 0, at a fixed ln_sigma that
   centres each sequence's scaled Z; the Durbin pair-HMM's K14
   (probability space) and K15 (log space), forward and backward, on the
   630 tRNA pairs at N = 128 and 2,016 random pairs at N = 256, at each
   pair's settled ln_sigma, bitwise (planes and corners), also with their
   output planes NaN-filled and on edge batches at N = 64 and 256 (n = 3,
   n = N, n1 != n2, mixed lengths); the parity tier's log-space K16, K17
   (CONTRA) and K18, K19 (Turner) at N = 128, B = 192 and N = 256, B = 96
   on random sequences, each bitwise equal there and on edge batches at
   N = 32, 64 and 256 (n = 1, 2, 3 and lengths around powers of two),
   K16/K18 on the live cells (i + d < n) with the fills in the dead ones,
   and with NaN in every dead input cell and scratch word, each launch's
   threads a lane printed); K15's fast instance (the hardware log-add)
   on the Durbin sets and edge batches within RTOL_LOG_FAST; the Durbin
   row scan K22, forward and backward, bitwise under exact (planes and
   corners, also NaN-filled) at the RNase P set's buckets (384, 512) and
   (512, 384) and the SSU set's commonest bucket (all their pairs), fast
   at (384, 512) within RTOL_LOG_FAST, and on the ROWS_EDGE batches (n = 2,
   3, n = N, n1 != n2; a tRNA against 4,100-4,224-nt records at (128,
   4224), past what K22 held before its redesign; a few rows against
   33,000-40,000-nt records, past what its registers hold) under exact,
   parity and fast; the generic-N scan's
   K20 (inside) and K21
   (outside), one cooperative launch a pass, both models, at N = 384,
   B = 8 and
   N = 1536, B = 2 (exact and fast) and on edge batches at N = 160 (n = 1,
   2, 3, n = N, a mix; exact, fast and parity), bitwise on the live cells
   under exact and parity (within RTOL_SCAN_FAST under fast), under exact
   also with NaN in every state cell and every dead score-table cell and
   with the narrowest groups the spans allow on a grid of SCAN_NARROW[1]
   blocks (lanes taken in many rounds); the gamma-centroid MEA fill K23
   with the 18 gammas on records of different n (MEA_CHECK: buckets 96
   and 256, the main paths' 128 x 192 and 256 x 96 records in the
   launches centroid_structures makes of them, bucket 512 x 8, one
   1,536-nt record, N = 332 / 333 on each side of the switch from the
   shared to the cluster form and 511 / 512 of one record on each side of
   a cluster-size switch), bitwise, also with its output NaN-filled and
   with one NaN BPP cell; and each
   one's time
   beside the plain version's, its bound and, for K3, the time of one
   torch.gather computing the same skew, at the main paths' shapes; then
   the native host runtime (_native, csrc/native_host.c, built by cc):
   its batch traceback on K23's fills at the two main-path shapes and one
   1,536-nt record, the pairs equal to the plain traceback's at every
   (record, gamma), each one's time; centroid_structures' fill, copy and
   native traceback timed apart at the two main-path shapes (the plain
   traceback never called, the native one once a launch); and its
   formatter byte-identical to probs2str on the 1,536-nt record's
   triples, each one's time;
3. the main paths, FoldEngine(device="cuda").fold_batch for CONTRA and for
   Turner, each on the six tRNAs tiled to B = 192 (bucket 128) and on 96
   seeded random sequences of 150-200 nt (bucket 256), then each on the
   long batches (32 sequences of 300-500 nt, bucket 512; 16 of 600-1,000,
   bucket 1024; CONTRA 8 of 1,100-2,000, bucket 2048), each path run with
   every launch count set to 0 just before it and read just after; the
   BPPs held against the plain path on the card (for a long batch, on the
   sequences where both settle on the same ln_sigma, at least half of
   them), the tRNA goldens and the float64 long-n goldens
   (tests/golden/longn_f64*.npz); AlignEngine(device="cuda") on all pairs
   of the six tRNAs tiled to 36 (630 pairs, bucket 128) and of 64 seeded
   random 150-200 nt sequences (2,016 pairs, bucket 256) through K14, and
   on the 630 pairs in parity through K15, each counted on its own with
   the plain wavefront never called, held against the plain path on the
   card (exact: every pair's ln_sigma equal), with its peak memory;
   FoldEngine(numerics="parity") for both models on the tRNA and the
   150-200 nt batches, each counted on its own (one K16/K17 or K18/K19
   launch a bucket, the plain log wavefronts never called), against the
   plain path on the card (the same presence, BPP within 1e-5), with its
   seqs/s and peak memory; the generic-N paths (K20/K21 one launch a pass,
   the plain scan never called), each against the plain path on the card
   (the same presence, BPP within 1e-5): Turner exact on seq_1536 of
   tests/golden/longn_f64_1536.npz and four seeded 1,409-1,536 nt
   sequences (bucket 1536, SSU rRNA scale; seq_1536 also against its
   float64 golden within TOL_GOLDEN_SCAN), CONTRA exact on two seeded
   2,817-2,944 nt sequences (bucket 2944, LSU rRNA scale; the plain path
   on the first), and parity for both models on eight seeded 300-384 nt
   sequences (bucket 384), each with seqs/s and peak memory; and Turner
   exact on a seeded 5,600-nt sequence beside seq_1536
   (bucket 5632), seq_1536 against its float64 golden, the long one's BPPs
   against the probability gates; K15's fast instance through
   durbin_match_probs_batch_pallas(numerics="fast") on the 630 tRNA pairs;
   the row scan's paths (K22; ROWS_RUNS), AlignEngine on all 496 pairs of
   32 random 300-450 nt sequences (RNase P scale) under exact and parity,
   all 28 pairs of 8 random 1,400-1,536 nt sequences (SSU rRNA scale)
   under exact, and the 66 pairs of the tRNAs with six of the RNase P
   sequences (K14 and K22 in one call), each counted on its own with the
   plain versions never called, a subset held bitwise against the plain
   path on the card, with pairs/s and peak memory;
4. the centroid CLI on assets/sampled_trnas.fa, each run counted (K23
   and the native traceback launched, their plain versions never called): with -c byte for byte
   against tests/golden/c_baseline/centroid_contra/, without -c against
   centroid_turner/ under the gamma = 1 tie rule (``turner_centroid_verdict``);
   and cli.mccaskill -c on the tRNAs mixed with a 400-nt and a 900-nt
   record, in input order, the tRNA records byte-identical to a tRNA-only
   run; cli.durbin --numerics parity against
   tests/golden/c_baseline/durbin.txt (same keys, <= 5e-4) and cli.durbin
   on the card against --device cpu (<= 1e-5); cli.mccaskill -c and
   cli.durbin on the tRNAs with each record's native text held against
   probs2str's on the same triples; cli.mccaskill --numerics
   parity with and without -c against the c_baseline triples (the same
   keys, <= 5e-4) and cli.centroid_fold --numerics parity against the
   centroid goldens (CONTRA byte for byte, Turner under the tie rule);
   cli.mccaskill and cli.centroid_fold --numerics parity -c on a 400-nt
   record (the generic scan at bucket 512) on the card against
   --device cpu; cli.durbin under exact and parity on a tRNA and three
   RNase P records (row-scan buckets), and on a tRNA and a 4,100-nt
   record (bucket (96, 4224)), the card's output byte-identical to
   --device cpu's;
5. seqs/s (pairs/s for Durbin) of every main-path configuration, kernel
   path and plain path, and the peak device memory of each long batch;
6. the eval pipeline, eval.pipeline.run_all on assets/synth_rfam_seed.sth
   (both models, both programs, the 18 gammas), its fold and MEA fill
   counted (K1/K2, K4/K5, K3, K23 and the native traceback launched, their
   plain versions never called): 18 rows a
   column, strict JSON, each column's best F1 at the floors of the
   committed report's test and best MCC above 0.3; the largest per-gamma
   gap of PPV, sensitivity, F1 and MCC to eval_artifacts/eval_report.json,
   the PhaseTimer split and the wall time printed;
7. both engines over a data mesh of one entry on the card and of two
   entries on the one card, against the engines without a mesh: CONTRA on
   the tRNA tile (B = 192) and 32 sequences of 300-500 nt (bucket 512),
   Turner on the tRNA tile, AlignEngine on the 630 tRNA pairs and the
   mixed set; each mesh run counted; bitwise with one entry, and with two
   wherever a sequence or pair settles on the same ln_sigma with the same
   launch shape, else within TOL_MAIN_VS_PLAIN, the counts printed.

The line before the last is the kernels' JSON record, after the phases'
records (the native host runtime's is {"native": ...}); the last line is
{"ok": true, "device": {...}}.  Without a GPU it exits non-zero and prints
no result.
"""

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SHAPES_CHECK = ((128, 64), (256, 32))
SHAPES_MAIN = ((128, 192), (256, 96))
# The long tier: kernel checks, and the main paths' shapes, per model.
LONG_CHECK = {"contra": ((512, 8), (1024, 4), (2048, 2), (512, 32),
                         (1024, 16), (2048, 8), (512, 80)),
              "turner": ((512, 8), (1024, 4), (512, 32), (1024, 16),
                         (512, 16), (512, 80))}
# The kernels that compute live cells only (i + d < n) and leave the dead
# ones the zeros their wrappers pass: K1, K2 (CONTRA) and K4, K5 (Turner) at
# N <= 256 and the cluster kernels K8, K9, K12 and K13, compared with their
# plain versions on the live cells.
LIVE_ONLY = ("contra_inside", "contra_outside",
             "turner_inside", "turner_outside",
             "contra_inside_long", "contra_outside_long",
             "turner_inside_long", "turner_outside_long")
# The probability wavefronts at N <= 256 (csrc/narrow.cuh's layout).
PROB = ("contra_inside", "contra_outside", "turner_inside", "turner_outside")
# K1/K2 and K4/K5 on batches that reach the edges of their layout, at each
# bucket the probability path takes at N <= 256
# (parallel.runner.kernel_bucket): no span that can close (n < 5), lengths
# just past a power of two and n = N.
PROB_EDGE = {64: (1, 2, 3, 4, 5, 33, 63, 64),
             128: (1, 2, 3, 4, 5, 65, 127, 128),
             256: (1, 2, 3, 4, 5, 129, 255, 256)}
LONG_MAIN = {"contra": ((512, 32), (1024, 16), (2048, 8)),
             "turner": ((512, 32), (1024, 16))}
# bucket -> (batch, shortest, longest) of the long main-path batches
LONG_BATCHES = {512: (32, 300, 500), 1024: (16, 600, 1000),
                2048: (8, 1100, 2000)}
# K1/K2 kernel vs plain on the card: both FP32, sums in different orders
# (sequential FMA in the kernel, tree sums and a matmul in the plain
# version), all terms positive, so the error stays relative.
RTOL_INSIDE = 1e-4
# below this the scaled states are float32 rounding noise near the
# denormal range, where one summation order can round to 0
ATOL_TINY = 1e-30
ATOL_BPPO = 1e-5
TOL_MAIN_VS_PLAIN = 1e-4
# Timed launches of a long kernel (after one warm-up), and the least share
# of a long batch's sequences whose kernel and plain runs must settle on the
# same ln_sigma for their BPPs to be compared (1-2 a batch differ by an ulp)
LONG_REPS = 3
MIN_SAME_LS_SHARE = 0.5
TOL_GOLDEN = 5e-4
TOL_GOLDEN_245 = 1e-4
# The one Turner centroid cell where the probability path may leave the
# cubic golden: record 0 of centroid_threshold=1.fa pairs (2, 80) in the
# golden at BPP 1.0000076; the probability path's BPP there is ~0.999993,
# and gamma = 1 pairs only above 1 (a tie within ~1e-5).
TURNER_TIE = ("centroid_threshold=1.fa", 0, (2, 80))
# Published peaks of one H100 SXM (the bound_ms of each kernel): HBM3
# bytes/s and FP32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# Window FMAs per (span, lane) cell of the long kernels K8/K9 and K12/K13,
# from their loops: CONTRA's banded 31 x 31 window (496 cells); Turner's KI
# (435), KB (60) and K2 (56) arms, the 2 TM3 and the 7 small-loop cells.
WINDOW_FMAS = {"contra": 496, "turner": 560}
# FMAs at every live cell of K4/K5 besides the window: Turner's 2 TM3 and 7
# small-loop cells.
TURNER_CELL_FMAS = 9
# FLOPs per cell outside the window and the O(d) sums: the special cells,
# close, and the rm/rmmb/epow updates (inside); base, pm2, qa and bppo
# (outside).
CELL_FLOPS = 16
# Durbin pair-HMM (K14, K15).  Kernel vs plain on the card: both round
# every add and multiply on its own (the kernel through _rn intrinsics) in
# the same association, so bitwise is required, planes and corners of both
# passes, also with the output planes NaN-filled before the launch (the
# kernels write every cell once, with no pre-fill).  The edge batches hold
# n = 3 (one base), n = N (a full bucket), n1 != n2 and mixed lengths in
# one launch, as wrapped lengths.
DURBIN_EDGE = {64: (3, 3, 4, 17, 33, 40, 63, 64, 64),
               256: (3, 5, 33, 129, 200, 255, 256, 256)}
TOL_DURBIN = {"exact": 1e-5, "parity": 1e-4}   # path vs plain path
TOL_DURBIN_CLI = 1e-5        # exact CLI on the card vs on the CPU
# Durbin sets: the tRNA fixture x 6 (as scripts/bench_suite.py's
# durbin_all_pairs) and 64 seeded random 150-200 nt sequences, all pairs.
DURBIN_RFAM = (64, 150, 200, 2016)   # count, shortest, longest, seed
# Float operations per live cell and pass (forward, backward): K14's
# multiply-adds of M, I, D (and the context ssum backward); K15's adds and
# cubic log-adds (8 operations each: sub, 3 mul, 3 add, add).
# K15's fast instance counts a hardware log-add as 6 (max, sub, abs, exp,
# log1p, add).
PAIRHMM_CELL_OPS = {"pairhmm_prob": (13, 17), "pairhmm_log": (42, 61),
                    "pairhmm_log_fast": (34, 49)}
# K15's fast instance vs its plain version on the card: the -inf pattern
# identical, finite cells within RTOL_LOG_FAST * max(1, |x|) (the card's
# exp and log1p against torch.logaddexp's; a path's probabilities within
# TOL_DURBIN_FAST).
RTOL_LOG_FAST = 1e-5
TOL_DURBIN_FAST = 1e-5
# The Durbin row scan, kernel K22 (ops/pairhmm_rows.py): every pair the
# wavefronts K14/K15 do not take (rectangular buckets, buckets past 256).
# Kernel vs plain on the card under "exact" and "parity" (one cubic
# instance): both round every add on its own and sum the delete state in
# lax.associative_scan's tree, so bitwise is required, planes and corners
# of both passes, also with the planes NaN-filled (every cell written
# once); "fast" within RTOL_LOG_FAST.  The sets (count, shortest, longest,
# seed of the random sequences): RNase P scale, all 496 pairs of 32 in
# buckets (384 | 512)^2; SSU rRNA scale, all 28 pairs of 8; and the mixed
# set, the 6 tRNAs with the first ROWS_MIXED RNase P sequences (66 pairs,
# K14 and K22 in one call).  ROWS_EDGE: wrapped lengths (n1, n2) in one
# rectangular bucket, n = 2 (no inner cell), 3, n = N, n1 != n2; a tRNA
# against 4,100-4,224-nt records (the (128, 4224) bucket, a cluster of 8
# blocks a pair); a few rows against 33,000-40,000-nt records (65,536
# columns: the runs in the global scratch).  ROWS_LONG_RECORD: the length
# of the record that cli.durbin aligns against a tRNA past 4,096 nt.
ROWS_RNASEP = (32, 300, 450, 450)
ROWS_SSU = (8, 1400, 1536, 1536)
ROWS_MIXED = 6
ROWS_EDGE = {(64, 96): ((2, 2), (3, 96), (64, 2), (64, 96), (33, 65),
                        (2, 50), (17, 3), (63, 95), (40, 40)),
             (128, 4224): ((78, 4224), (78, 4100), (128, 4097), (2, 4224),
                           (100, 2)),
             (8, 40000): ((8, 40000), (6, 33000), (3, 40000))}
ROWS_LONG_RECORD = 4100
# The buckets K22 is held at (the RNase P set's two rectangles and the SSU
# set's commonest bucket), and the pairs of a path held against the plain
# path (the first ROWS_SUBSET of its K22 bucket with the fewest rows, whose
# plain passes cost the least; all of the mixed set's K14 pairs).
ROWS_CHECK = (("rnasep_P496", (384, 512)), ("rnasep_P496", (512, 384)),
              ("ssu_P28", None))
ROWS_SUBSET = 3
# Float operations of a K22 pass (the bound), a cubic log-add 8, an add 1,
# as this run's data needs them: per live cell (n1 - 1)(n2 - 1) 33 forward
# (M: 2 log-adds, 4 adds; I: 1 log-add, 3 adds; the scan's leaf: 2 adds),
# 52 backward (and the context: 2 log-adds, 3 adds); per combine of the
# associative-scan tree over a row's n2 - 1 live columns 9 (an add and a
# log-add), the c tree's adds once a pass.
ROWS_CELL_OPS = (33, 52)
ROWS_COMBINE_OPS = 9
# The parity tier's log kernels K16-K19 vs their plain versions on the card:
# both round every add and multiply on its own (the kernels through _rn
# intrinsics) and sum in the same tree order, so bitwise is required (and
# the CPU tests' budget against JAX stated: the -inf pattern identical,
# finite cells within RTOL_LOG * max(1, |x|)).  The inside kernels compute
# live cells only (i + d < n): the dead ones keep the wrappers' fills
# (LOG_INSIDE_FILLS), which nothing downstream reads, so they are compared
# on the live cells.  A parity main path vs its plain path: the
# same presence, BPP within TOL_PARITY_MAIN.
RTOL_LOG = 1e-4
TOL_PARITY_MAIN = 1e-5
LOG_KERNELS = ("contra_inside_log", "contra_outside_log", "turner_inside_log",
               "turner_outside_log")
# K16-K19 split every tree exactly as the halving tree splits, so they
# are held bitwise to their plain versions also on batches that reach
# the split's edges: n = 1, 2, 3 (k = 0 at every first span), trees smaller
# than a lane's thread group, lanes whose context trees are all -inf (i = 0,
# or k = 0), lengths just past a power of two.  With the main shapes they
# reach every group size (G = 32, 16, 8, 4 at N = 32, 64, 128, 256; N = 64
# is the parity path's smallest bucket).
# The wrappers' fills of the inside kernels' (close, ext, one) dead cells.
LOG_INSIDE_FILLS = (float("-inf"), 0.0, float("-inf"))
LOG_EDGE = {32: (1, 2, 3, 4, 5, 7, 9, 16, 31, 32),
            64: (1, 2, 3, 16, 17, 33, 63, 64),
            256: (1, 2, 3, 5, 30, 33, 64, 129, 200, 256)}
# Float operations of the log kernels (the bound): a cubic lse_pair counts
# 8 (sub, 3 mul, 3 add, add), an add or a multiply 1, as this run's data
# needs them.  Inside (log_inside_terms): 10 per 2-loop window leaf (2 adds,
# 1 log-add) and 18 for close (2 log-adds, 2 adds) at the cells that can
# close (live, CANON finite, from span MIN_SPAN_HAIRPIN_CLOSE on); 9 per ext
# term t < d (add + log-add) and 19 per s1/s2 term 1 <= t < d (mul + add +
# log-add; add + log-add) and 47 for rm/rmmb, ext's base and the finishing
# log-adds at every live cell.  Outside (log_outside_terms): 11 per window
# cell (3 adds, 1 log-add), 19 per pm/pm2 term, 20 per multibranch term and
# 40 for the rest, plus 9 a cell for the QONEMB column.  Bytes: each input
# where this run's data needs it (log_inside_bytes, log_outside_bytes), the
# outputs written once whole.
LOG_OPS = {"inside": (10, 18, 9, 19, 47), "outside": (11, 19, 20, 40, 9)}
# Inside inputs besides CANON: the [d, i] tables read at the cells that can
# close, those read there and at their (d - 2, i + 1) (CONTRA's JB: the
# window ring's row and the stack's inner pair), and the (32, 31) length
# tables.
LOG_INSIDE_INPUTS = {"contra_inside_log": (8, 1, 1),
                     "turner_inside_log": (17, 0, 2)}
# Outside inputs besides CLOSE, ONEP and QONE: the other [d, i] tables, the
# per-lane vectors (EXTR besides) and the (32, 31) length tables.
LOG_OUTSIDE_INPUTS = {"contra_outside_log": (7, 2, 1),
                      "turner_outside_log": (16, 1, 2)}

# The generic-N scan, kernels K20 (inside) and K21 (outside) of
# ops/fold_scan.py, one cooperative launch a pass.  Kernel vs plain on the card: under
# "exact" and "parity" (one kernel instance: the mode only switches "fast")
# both round every add and multiply on its own and sum in the same halving
# trees, so bitwise is required on the live cells (i + d < n; right-layout
# tables: j < n), also with NaN in every state cell before the pass and in
# every dead cell of the score tables (CANON's dead cells set true); under
# "fast" the -inf pattern identical and finite cells within
# RTOL_SCAN_FAST * max(1, |x|) (the sums' order and the card's exp and log
# differ from the CPU's; a few ulps of log Z move bppo by ~1e-5).  Parity
# runs exact's kernel instance and plain passes, so the kernel phase holds
# it on SCAN_EDGE only (the parity paths hold it at N = 384).  SCAN_CHECK:
# parity's first generic bucket and the SSU rRNA bucket; SCAN_EDGE: n = 1,
# 2, 3, n = N and a mix, at N = 160 (not a power of two).
SCAN_CHECK = ((384, 8), (1536, 2))
SCAN_EDGE = {160: (1, 2, 3, 160, 45, 97, 130, 159)}
# The schedule held at its narrowest (narrow_groups): groups at most
# SCAN_NARROW[0] threads wide, so each span takes the narrowest its trees
# allow (2^LG leaves a thread: K21's context at 256 at N = 1536), on a
# grid of SCAN_NARROW[1] blocks, so that a span's lanes take many rounds.
SCAN_NARROW = (1, 8)
RTOL_SCAN_FAST = 1e-4
SCAN_STATE = {"scan_inside": ("close", "ext", "mb", "one", "qone", "qrm",
                              "qrmmb"),
              "scan_outside": ("bppo", "g", "qpm", "qpm2")}
# The generic main paths: (count, shortest, longest, seed) of the seeded
# random sequences.  Turner exact at SSU rRNA scale, with seq_1536 of
# tests/golden/longn_f64_1536.npz (bucket 1536); CONTRA exact at LSU rRNA
# scale (bucket 2944; its plain path, ~85 s a sequence on the card, on
# the first sequence only); parity, both models, RNase P scale (bucket 384).
SCAN_TURNER = (4, 1409, 1536, 1536)
SCAN_CONTRA = (2, 2817, 2944, 2944)
SCAN_PARITY = (8, 300, 384, 384)
# K21's context trees past 16,384 terms (groups of at least 128 threads at
# 256 leaves a thread): one seeded sequence of this length with seq_1536
# beside it
# (bucket 5,632).  A base's pair probabilities sum to at most 1 in exact
# arithmetic; the cubic numerics move that sum by up to 6.40e-3 (the JAX
# scan, jitted on the CPU) and 6.42e-3 (the port's plain path) from the
# float64 golden at n = 1536, so the gate is 1 + TOL_GOLDEN_SCAN (and the
# same for one pair's probability).
SCAN_LONG = 5600
# A generic path vs its plain path on the card: the same presence, BPP
# within TOL_SCAN_MAIN (the kernels are bitwise equal to the plain versions,
# so 0.0 is what a run reads).  The Turner n = 1536 golden: the JAX scan's
# own drift from float64 there, 5.376e-3 (exact numerics, jitted on the
# CPU; the port's plain path reads 5.374e-3 on the CPU), plus 1e-3
# (tests/test_torch_scan_golden.py, marked slow, measures both).
TOL_SCAN_MAIN = 1e-5
TOL_GOLDEN_SCAN = 6.4e-3
# Float operations of the scan kernels (the bound), as LOG_OPS counts them:
# a cubic lse_pair 8, an add or a multiply 1.  Inside: 10 per window leaf
# (a + b <= d - 2, a, b <= 30) and 18 for close at the cells that can close
# (live, canonical, span >= min_span); 9 per ext term (t < d), 19 per s1/s2
# term (1 <= t < d) and 47 for the rest at every live cell.  Outside: 11
# per window leaf (outer pair inside the sequence), 30 per context t
# (three leaves, 1 <= t <= i) and 40 for the rest at the pair cells (close
# finite, span >= min_span); 19 per pm/pm2 term (1 <= t <= n - 1 - j) at
# every live cell of a valid span.  Bytes: each input and state cell once
# at the live cells, each output once.
SCAN_OPS = {"inside": (10, 18, 9, 19, 47), "outside": (11, 30, 40, 19)}
# (B, N, N) tables a pass reads at its live cells (score tables, inputs
# from the inside pass) and writes (state), by model.
SCAN_TABLES = {("scan_inside", "contra"): (5, 7),
               ("scan_inside", "turner"): (10, 6),
               ("scan_outside", "contra"): (9, 4),
               ("scan_outside", "turner"): (13, 4)}

def random_batch(B, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, 4, size=int(rng.integers(lo, hi + 1))))
            for _ in range(B)]


def sized_batch(N, B, seed, lengths=None):
    """B random sequences of N/2 + 10 (at least 30) to N nt, or one of each
    of ``lengths``."""
    if lengths is None:
        return random_batch(B, max(30, N // 2 + 10), N, seed)
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, 4, size=n)) for n in lengths]


def padded(seqs, N, device):
    from rna_algos_tpu_torch.parallel.runner import pad_seqs

    arr = torch.as_tensor(pad_seqs(seqs, N), dtype=torch.int64, device=device)
    ns = torch.as_tensor([len(s) for s in seqs], dtype=torch.int32,
                         device=device)
    return arr, ns


def wrappers(name):
    """(kernel wrapper, plain version) of a kernel by name."""
    from rna_algos_tpu_torch.ops import pallas_fold as PF
    from rna_algos_tpu_torch.ops import pallas_fold_long as PL
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8

    mod = (PL if name.endswith("_long") else PF if name.endswith("_log")
           else P8)
    return getattr(mod, name), getattr(mod, name + "_plain")


def centred_ln_sigma(glob_at, ns, ls0):
    """Per-sequence ln_sigma that centres the scaled Z near 1, from inside
    passes alone: the retry loop's jumps and walks bring it into the guard
    band, one more jump to ln(glob)/n centres it (past N = 256 the band is
    only ~+-55/n wide, so one fixed value does not fit a batch, and at its
    edge the outside pass's 1/Z overflows)."""
    from rna_algos_tpu_torch.ops import pallas_fold_prob as PP

    def run(ls):
        glob = glob_at(ls)
        return torch.zeros((glob.shape[0], 1, 1), device=glob.device), glob

    ls = PP._retrying(run, ns, ls0=ls0)[1]
    return ls + torch.log(glob_at(ls)) / ns.to(torch.float32)


def kernel_inputs(N, B, seed, device, lengths=None):
    """The inputs the CONTRA main path hands its inside and outside kernels
    (K1/K2 at N <= 256, K8/K9 past it) and K3: at ln_sigma = 0.9 for
    N <= 256, at a centred per-sequence ln_sigma past it.  Random sequences
    of N/2 + 10 (at least 30) to N nt, or of ``lengths`` (then B is
    len(lengths))."""
    from rna_algos_tpu_torch.ops import pallas_fold as PF
    from rna_algos_tpu_torch.ops import pallas_fold_prob as PP
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8
    from rna_algos_tpu_torch.parallel.runner import FoldEngine

    long = N > P8.MAX_N
    names = (("contra_inside_long", "contra_outside_long") if long
             else ("contra_inside", "contra_outside"))
    inside = wrappers(names[0])[0]
    batch = sized_batch(N, B, seed, lengths)
    B = len(batch)
    seqs, ns = padded(batch, N, device)
    ct = FoldEngine(uses_contra_model=True, device=device).tbl

    def prep(ls):
        mi, mo_pre, acc, b0lo = P8.contra_prob_mats_merged(seqs, ns, ct, ls, N)
        KW = PP._banded_window_kernel(PP._contra_len_prob(ct, ls))
        scal = PP._scal_rows(ct, ls)
        close, ext, one = inside(mi, KW, scal, ns)
        return mi, mo_pre, acc, b0lo, KW, scal, close, ext, one

    if long:
        ls = centred_ln_sigma(
            lambda l: PF.contra_outside_aux(ns, *prep(l)[7:], N)[3], ns,
            PP.LN_SIGMA0)
    else:
        ls = torch.full((B,), 0.9, device=device)
    mi, mo_pre, acc, b0lo, KW, scal, close, ext, one = prep(ls)
    QONE, extL, extR, glob = PF.contra_outside_aux(ns, ext, one, N)
    mo = dict(mo_pre)
    mo["ACCB"] = (acc * extL[:, None, :] * (1.0 / glob)[:, None, None]
                  * scal[:, 1][:, None, None])
    mo["CLOSE"] = close
    pq, _, _ = PF.contra_pq_tables(seqs, ns, ct, N)
    return dict(
        seqs=seqs, ns=ns, mi=mi, KW=KW, scal=scal, mo=mo, ls=ls,
        one=one, QONE=QONE, extR=extR, b0lo=b0lo, kernels=names,
        pq=[pq[k].contiguous() for k in sorted(pq)],
        inside_args=(mi, KW, scal, ns),
        outside_args=(mo, one, QONE, extR, b0lo, KW, scal, ns, 5),
    )


def turner_inputs(N, B, seed, device, lengths=None):
    """The inputs the Turner main path hands its inside and outside kernels
    (K4/K5 at N <= 256, K12/K13 past it) and K3: at ln_sigma = 0.5 (the
    Turner seed) for N <= 256, at a centred ln_sigma past it.  Random
    sequences of N/2 + 10 (at least 30) to N nt, or of ``lengths`` (then B
    is len(lengths))."""
    from rna_algos_tpu_torch.ops import pallas_fold as PF
    from rna_algos_tpu_torch.ops import pallas_fold_prob as PP
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8
    from rna_algos_tpu_torch.weights import turner_tables

    long = N > P8.MAX_N
    names = (("turner_inside_long", "turner_outside_long") if long
             else ("turner_inside", "turner_outside"))
    inside = wrappers(names[0])[0]
    batch = sized_batch(N, B, seed, lengths)
    B = len(batch)
    seqs, ns = padded(batch, N, device)
    tt = turner_tables(device)

    def prep(ls):
        pmats = PP.turner_prob_mats(seqs, ns, tt, ls, N)
        LENBp, LENIp = PP._turner_len_prob(tt, ls)
        KB, K2, KI = PP._turner_banded_kernels(LENBp, LENIp)
        KT = torch.stack([KI, KB, K2], dim=1).contiguous()
        scal = PP._turner_scal_rows(tt, ls, LENIp)
        mi = {k: v.contiguous()
              for k, v in P8._turner_merge_inside(pmats).items()}
        close, ext, one = inside(mi, KT, scal, ns)
        return pmats, KT, scal, mi, close, ext, one

    if long:
        ls = centred_ln_sigma(
            lambda l: PF.contra_outside_aux(ns, *prep(l)[5:], N)[3], ns,
            PP.LN_SIGMA0_TURNER)
    else:
        ls = torch.full((B,), PP.LN_SIGMA0_TURNER, device=device)
    pmats, KT, scal, mi, close, ext, one = prep(ls)
    QONE, extL, extR, glob = PF.contra_outside_aux(ns, ext, one, N)
    mo = {k: v.contiguous() for k, v in P8._turner_merge_outside(
        close, pmats, extL, glob, scal[:, 3]).items()}
    return dict(
        seqs=seqs, ns=ns, mi=mi, KT=KT, scal=scal, ls=ls, kernels=names,
        pq=[mi[k] for k in P8.TURNER_INSIDE_TABLES],   # 18 tables, one K3 call
        inside_args=(mi, KT, scal, ns),
        outside_args=(mo, one, QONE, extR, KT, scal, ns, 5),
    )


def check_skew(inp):
    """K3 vs plain, bitwise, both directions, all of ``inp["pq"]`` in one
    launch; returns max abs error (0)."""
    from rna_algos_tpu_torch.ops import pallas_skew as K3

    for inv in (False, True):
        got = K3.skew_pq_batch(inp["pq"], inv=inv)
        want = K3.skew_pq_batch_plain(inp["pq"], inv=inv)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(
                    f"K3 skew of {len(got)} tables inv={inv} differs from plain"
                )
    return 0.0


def block_threads(model, N, B, threads):
    """A model's inside and outside block sizes at N <= 256 (threads a
    sequence; K1/K2 or K4/K5) for a launch over B sequences, recorded in
    ``threads[kernel][shape]``; a note for the log."""
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8

    sizes = getattr(P8, f"{model}_block_threads")(B, N)
    kernels = (f"{model}_inside", f"{model}_outside")
    for k, c in zip(kernels, sizes):
        threads.setdefault(k, {})[f"N{N}_B{B}"] = c
    return (f"block size {LABELS[kernels[0]]} {sizes[0]}, "
            f"{LABELS[kernels[1]]} {sizes[1]} threads a sequence")


def check_prob_dead_cells(x, which):
    """The inside (``which`` = 0: K1, K4) or outside (1: K2, K5) kernel of
    ``x`` lets no dead cell through: with NaN in every dead cell
    (i + d >= n) of each (B, N, N) [d, i] table it is handed (the merged
    tables, and the outside's inside table ``one``) and in all of its
    scratch, it gives bitwise the outputs of the call on the untouched
    inputs, every dead cell 0.  Two kernel launches, no plain version (the
    plain versions compute the dead cells)."""
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8

    kernel = x["kernels"][which]
    kern = wrappers(kernel)[0]
    args = (x["inside_args"], x["outside_args"])[which]
    want = kern(*args)
    want = want if isinstance(want, tuple) else (want,)
    dead = ~log_live(x, want[0])
    nan = torch.full((), float("nan"), device=want[0].device)
    mats = {k: torch.where(dead, nan, v) for k, v in args[0].items()}
    rest = list(args[1:])
    if which == 1:
        rest[0] = torch.where(dead, nan, rest[0])
    scratch = P8._prob_scratch
    P8._prob_scratch = lambda *a: tuple(t.fill_(float("nan"))
                                        for t in scratch(*a))
    try:
        got = kern(mats, *rest)
    finally:
        P8._prob_scratch = scratch
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        if not (torch.equal(g.view(torch.int32), w.view(torch.int32))
                and bool((g[dead] == 0).all())):
            raise AssertionError(f"{LABELS[kernel]}: a dead cell or the "
                                 "scratch reached its outputs")
    print(f"  {LABELS[kernel]}: NaN in every dead table cell and the "
          "scratch, outputs bitwise unchanged, dead cells 0")


def cluster_sizes(model, N, B, clusters):
    """A model's long inside and outside kernels' cluster sizes (blocks per
    sequence; K8/K9 or K12/K13) for a launch over B sequences at N,
    recorded in ``clusters[kernel][shape]``; a note for the log."""
    from rna_algos_tpu_torch.ops import pallas_fold_long as PL

    sizes = getattr(PL, f"{model}_cluster_sizes")(B, N)
    kernels = (f"{model}_inside_long", f"{model}_outside_long")
    for k, c in zip(kernels, sizes):
        clusters.setdefault(k, {})[f"N{N}_B{B}"] = c
    return (f"cluster size {LABELS[kernels[0]]} {sizes[0]}, "
            f"{LABELS[kernels[1]]} {sizes[1]}")


def live_cells(kernel, inp, like):
    """The cells ``kernel`` is compared on: all, or for LIVE_ONLY kernels
    the live ones (i + d < n), after checking that each dead cell of
    ``like`` (the kernel's outputs) is exactly 0."""
    live = torch.ones_like(like[0], dtype=torch.bool)
    if kernel in LIVE_ONLY:
        N = live.shape[1]
        r = torch.arange(N, device=live.device)
        live = ((r[None, :, None] + r[None, None, :])
                < inp["ns"].view(-1, 1, 1))
        for g in like:
            if bool((g[~live] != 0).any()):
                raise AssertionError(
                    f"{LABELS[kernel]}: a dead cell is not 0")
    return live


def check_inside(inp, label="K1", kernel="contra_inside"):
    """An inside kernel (K1, K4, K8 or K12) vs its plain version on close,
    ext, one: |k - p| <= RTOL_INSIDE * |p| on the live cells, the dead ones
    0 (``live_cells``).  Returns (max abs error, max relative error); the
    scaled partition functions run up to ~1e8, so the relative error is the
    telling one."""
    kern, plain = wrappers(kernel)
    got = kern(*inp["inside_args"])
    want = plain(*inp["inside_args"])
    torch.cuda.synchronize()
    live = live_cells(kernel, inp, got)
    got = [g[live] for g in got]
    want = [w[live] for w in want]
    worst_abs = worst_rel = 0.0
    for name, g, w in zip(("close", "ext", "one"), got, want):
        err = (g - w).abs()
        rel = float((err / w.abs().clamp(min=1e-30)).max())
        worst_abs = max(worst_abs, float(err.max()))
        worst_rel = max(worst_rel, rel)
        bad = ~(err <= RTOL_INSIDE * w.abs() + ATOL_TINY)
        print(f"  {label} {name}: max rel err {rel:.3e} max abs "
              f"{float(err.max()):.3e}, {int(bad.sum())} outside tolerance")
        if bool(bad.any()):
            k = int(bad.nonzero()[0])
            raise AssertionError(
                f"{label} {name} differs from plain at live cell {k}: "
                f"kernel {float(g[k])!r} plain {float(w[k])!r}")
    if kernel in LIVE_ONLY:
        print(f"  {label}: dead cells (i + d >= n) all 0")
    return worst_abs, worst_rel


def check_outside(inp, label="K2", kernel="contra_outside"):
    """An outside kernel (K2, K5, K9 or K13) vs its plain version on bppo:
    max |k - p| <= ATOL_BPPO on the live cells, the dead ones 0
    (``live_cells``)."""
    kern, plain = wrappers(kernel)
    got = kern(*inp["outside_args"])
    want = plain(*inp["outside_args"])
    torch.cuda.synchronize()
    live = live_cells(kernel, inp, [got])
    got, want = got[live], want[live]
    err = float((got - want).abs().max())
    print(f"  {label} bppo: max abs err {err:.3e}, max bppo "
          f"{float(want.max()):.4f}")
    if not bool(torch.isfinite(got).all()) or not err <= ATOL_BPPO:
        raise AssertionError(f"{label} bppo differs from plain: {err}")
    if kernel in LIVE_ONLY:
        print(f"  {label}: dead cells (i + d >= n) all 0")
    return err


def _live_cells(ns):
    """Per sequence, the span d of each diagonal and its live lanes n - d."""
    for n in (int(x) for x in ns):
        d = np.arange(n, dtype=np.float64)
        yield n, d, n - d


def work(kernel, inp):
    """(bytes, FLOPs) one call of ``kernel`` must do on ``inp``: each
    input table read once (LIVE_ONLY kernels: on the live cells, i + d < n,
    the only ones they read) and each output written once (whole: the wrappers
    zero-fill them); the FLOPs of the recurrences on the live cells of
    this run's lengths, the 2-loop windows of K1/K2 and K4/K5 only at the
    cells that can close (``prob_window_terms``: elsewhere they are
    multiplied by 0), K4/K5's TM3 and small-loop cells at every live
    cell."""
    if kernel.endswith("_log"):
        return log_work(kernel, inp)
    key = kernel.replace("_long", "")
    B, N = inp["seqs"].shape
    nn = 4.0 * B * N * N
    if key == "skew":
        return 2 * len(inp["pq"]) * nn, 0.0
    model = key.split("_")[0]
    narrow = kernel in PROB
    if narrow:
        cell = CELL_FLOPS + (2 * TURNER_CELL_FMAS if model == "turner" else 0)
    else:
        cell = CELL_FLOPS + 2 * WINDOW_FMAS[model]
    flops = 2.0 * prob_window_terms(kernel, inp) if narrow else 0.0
    live = 0.0
    for n, d, lanes in _live_cells(inp["ns"].tolist()):
        live += 4.0 * float(lanes.sum())
        if key.endswith("inside"):
            # ext: d + 1 FMAs, s2: d - 1, per cell
            flops += float((lanes * (cell + 4.0 * d)).sum())
        else:
            # pm: n - 2 - d - i FMAs at lane i; sa, sbc: i terms at lane i
            flops += float((lanes * cell
                            + (lanes - 1) * np.maximum(lanes - 2, 0)
                            + 2.0 * lanes * (lanes - 1)).sum())
    ins, outs = {"contra_inside": (9, 3), "contra_outside": (11, 1),
                 "turner_inside": (18, 3), "turner_outside": (20, 1)}[key]
    return ins * (live if kernel in LIVE_ONLY else nn) + outs * nn, flops


def prob_window_terms(kernel, inp):
    """The 2-loop window terms K1 (``kernel`` = "contra_inside"), K2
    ("contra_outside"), K4 ("turner_inside") or K5 ("turner_outside")
    needs on this run's data: at a cell that can close (live; inside from
    span MIN_SPAN_HAIRPIN_CLOSE on where JS != 0 (K1) or AUGC != 0 (K4),
    outside where CLOSE is a positive normal float and the span reaches
    min_span), the window cells whose inner pair lies in the sequence:
    CONTRA inside the terms (a, b) with a + b <= min(d - 2, 30) (the inner
    pair at span d - 2 - a - b >= 0), outside sum_{a < min(i, 31)}
    min(31 - a, r), r = n - 1 - d - i (the outer pair inside the sequence);
    Turner the nonzero cells of its three window matrices
    (``turner_window_terms``)."""
    from rna_algos_tpu_torch.constants import MIN_SPAN_HAIRPIN_CLOSE
    from rna_algos_tpu_torch.ops import pallas_fold_prob as PP

    if kernel.startswith("turner"):
        return turner_window_terms(kernel, inp)
    if kernel == "contra_inside":
        can = (inp["inside_args"][0]["JS"] != 0).cpu().numpy()
    else:
        mo, min_span = inp["outside_args"][0], int(inp["outside_args"][-1])
        can = (mo["CLOSE"] >= PP.FLT_MIN).cpu().numpy()
    N = can.shape[1]
    D, I = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    total = 0
    for b, n in enumerate(inp["ns"].tolist()):
        live = D + I <= n - 1
        if kernel == "contra_inside":
            m = np.minimum(D - 2, 30)
            terms = np.where(m >= 0, (m + 1) * (m + 2) // 2, 0)
            full = live & can[b] & (D + 1 >= MIN_SPAN_HAIRPIN_CLOSE)
        else:
            r = n - 1 - D - I
            A = np.minimum(I, 31)
            terms = sum(np.where(a < A, np.minimum(31 - a, r), 0)
                        for a in range(31))
            full = live & can[b] & (D + 1 >= min_span)
        total += int(terms[full].sum())
    return total


def turner_window_terms(kernel, inp):
    """The window terms K4 (``kernel`` = "turner_inside") or K5
    ("turner_outside") needs on this run's data: at each cell that can
    close (live; inside AUGC != 0 from span MIN_SPAN_HAIRPIN_CLOSE on,
    outside CLOSE a positive normal float and the span reaching min_span),
    the cells (a, r) of KI, KB and K2 (``KT``) that are nonzero and whose
    inner pair lies in the sequence: inside r <= d - 1 (span d - 1 - r >=
    0), outside a < i and r - a <= n - 1 - d - i (the outer pair's lane
    i - 1 - a >= 0 and its span d + 1 + r live)."""
    from rna_algos_tpu_torch.constants import MIN_SPAN_HAIRPIN_CLOSE
    from rna_algos_tpu_torch.ops import pallas_fold_prob as PP

    inside = kernel == "turner_inside"
    if inside:
        mi, KT = inp["inside_args"][0], inp["inside_args"][1]
        can = (mi["AUGC"] != 0).cpu().numpy()
        min_span = MIN_SPAN_HAIRPIN_CLOSE
    else:
        mo, KT = inp["outside_args"][0], inp["outside_args"][4]
        min_span = int(inp["outside_args"][-1])
        can = (mo["CLOSE"] >= PP.FLT_MIN).cpu().numpy()
    nzc = (KT != 0).cpu().numpy().sum(axis=1)      # (B, 32, 32): a, r
    N = can.shape[1]
    D, I = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    total = 0
    for b, n in enumerate(inp["ns"].tolist()):
        full = (D + I <= n - 1) & can[b] & (D + 1 >= min_span)
        if inside:
            # terms(d): the cells with r <= d - 1
            upto = np.concatenate([[0], np.cumsum(nzc[b].sum(axis=0))])
            terms = upto[np.clip(D, 0, 32)]
        else:
            # C[a, s]: the cells of row a at s = r - a; cum[A, S]: a < A,
            # 1 <= s <= S
            C = np.zeros((32, 33))
            for a in range(32):
                for r in range(a + 1, 32):
                    C[a, r - a] += nzc[b, a, r]
            cum = np.zeros((33, 33))
            cum[1:, :] = np.cumsum(np.cumsum(C, axis=0), axis=1)
            terms = cum[np.minimum(I, 32),
                        np.clip(n - 1 - D - I, 0, 32)]
        total += int(terms[full].sum())
    return total


def log_work(kernel, inp):
    """(bytes, FLOPs) of one call of a log kernel (K16-K19) on ``inp``:
    what this run's data needs (``log_inside_terms``, ``log_inside_bytes``,
    ``log_outside_terms``, ``log_outside_bytes``)."""
    B, N = inp["seqs"].shape
    if kernel.endswith("outside_log"):
        win, per_s, per_t, cell, qmb = LOG_OPS["outside"]
        cells, wins, pms, ctxs = log_outside_terms(inp)
        return (log_outside_bytes(kernel, inp),
                float(qmb * B * N * N + cell * cells + win * wins
                      + per_s * pms + per_t * ctxs))
    win, full_op, ext_op, s12_op, cell = LOG_OPS["inside"]
    cells, full, wins, exts, s12 = log_inside_terms(inp)
    return (log_inside_bytes(kernel, inp),
            float(cell * cells + full_op * full + win * wins + ext_op * exts
                  + s12_op * s12))


def _inside_cells(inp):
    """Per sequence of an inside log call: (n, D, I, live, full), the
    [d, i] grids, the live cells (i + d < n) and the full ones (live, CANON
    finite, d + 1 >= MIN_SPAN_HAIRPIN_CLOSE: the only cells whose close is
    not -inf)."""
    from rna_algos_tpu_torch.constants import MIN_SPAN_HAIRPIN_CLOSE

    canon = torch.isfinite(inp["inside_args"][0]["CANON"]).cpu().numpy()
    N = canon.shape[1]
    D, I = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    for b, n in enumerate(inp["ns"].tolist()):
        live = D + I <= n - 1
        yield (n, D, I, live,
               live & canon[b] & (D + 1 >= MIN_SPAN_HAIRPIN_CLOSE))


def log_inside_terms(inp):
    """The terms an inside log call (K16, K18) needs on this run's data:
    (live cells, full cells, window leaves, ext terms, s1/s2 terms).  At a
    full cell of span d, the window leaves (a, b) with a + b <= min(d - 2,
    30) (the inner pair at span d - 2 - a - b >= 0); at every live cell d
    ext terms (t < d) and d - 1 s1/s2 terms (1 <= t < d)."""
    totals = np.zeros(5)
    for n, D, I, live, full in _inside_cells(inp):
        m = np.minimum(D - 2, 30)
        win = np.where(m >= 0, (m + 1) * (m + 2) // 2, 0)
        totals += (live.sum(), full.sum(), win[full].sum(), D[live].sum(),
                   np.maximum(D - 1, 0)[live].sum())
    return totals


def log_inside_bytes(kernel, inp):
    """The bytes an inside log call (K16, K18) must move on this run's
    data, each input cell read once where some term needs it and the
    outputs (close, ext, one) written once whole: CANON at every live cell;
    the other [d, i] tables at the full cells (elsewhere close is -inf
    whatever they hold), CONTRA's JB also at each full cell's (d - 2,
    i + 1) (the stack's inner pair); the length tables, scal and ns
    whole."""
    from rna_algos_tpu_torch.ops.pallas_fold import N_SCAL, W, W2

    others, shifted, lens = LOG_INSIDE_INPUTS[kernel]
    B, N = inp["seqs"].shape
    cells = 0.0
    for n, D, I, live, full in _inside_cells(inp):
        inner = np.zeros_like(full)
        inner[:-2, 1:] = full[2:, :-1]      # (d - 2, i + 1) of a full cell
        cells += (live.sum() + others * full.sum()
                  + shifted * (full | inner).sum())
    return 4.0 * (cells + lens * W2 * W + B * N_SCAL + B + 3 * B * N * N)


def _outside_cells(inp):
    """Per sequence of an outside log call: (n, D, I, live, full), the
    [d, i] grids, the live cells (i + d < n) and the full ones (live, CLOSE
    finite, d + 1 >= min_span: the only cells whose bppo is not -inf)."""
    args = inp["outside_args"]
    close = torch.isfinite(args[0]["CLOSE"]).cpu().numpy()
    min_span = int(args[-1])
    N = close.shape[1]
    D, I = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    for b, n in enumerate(inp["ns"].tolist()):
        live = D + I <= n - 1
        yield n, D, I, live, live & close[b] & (D + 1 >= min_span)


def log_outside_terms(inp):
    """The terms an outside log call (K17, K19) needs on this run's data:
    (live cells, window leaves, pm/pm2 terms, multibranch context terms).
    At live cell (d, i), with r = n - 1 - d - i and k = n - 1 - d: r pm
    terms (the g cells past the sequence's end are -inf); where CLOSE is
    finite and the span reaches min_span, also the window leaves
    sum_{a < min(i, 31)} min(31 - a, r) (outer pairs inside the sequence)
    and min(i, k) context terms."""
    totals = np.zeros(4)
    for n, D, I, live, full in _outside_cells(inp):
        r = n - 1 - D - I
        A = np.minimum(I, 31)
        win = sum(np.where(a < A, np.minimum(31 - a, r), 0)
                  for a in range(31))
        totals += (live.sum(), win[full].sum(), r[live].sum(),
                   np.minimum(I, n - 1 - D)[full].sum())
    return totals


def log_outside_bytes(kernel, inp):
    """The bytes an outside log call (K17, K19) must move on this run's
    data, each input cell read once where some term needs it and bppo
    written once whole: CLOSE at every live cell; the other [d, i] tables at
    the full cells (elsewhere bppo, g and the window rows are -inf whatever
    they hold); ONEP at the pm terms' cells (s, c = i + d + 1), s < n - c,
    of spans d + 1 >= min_span; QONE at the context terms' cells (t, i),
    1 <= t <= min(i, n - 1 - d), of the full cells; EXTL (and B0LO) at the
    full cells' lanes, EXTR at their pair ends j + 1; the length tables,
    scal and ns whole."""
    from rna_algos_tpu_torch.ops.pallas_fold import N_SCAL, W, W2

    others, vectors, lens = LOG_OUTSIDE_INPUTS[kernel]
    B, N = inp["seqs"].shape
    min_span = int(inp["outside_args"][-1])
    cells = 0.0
    for n, D, I, live, full in _outside_cells(inp):
        lanes = full.any(axis=0)
        kmax = n - 1 - np.where(lanes, full.argmax(axis=0), n - 1)
        c = np.arange(max(min_span, 1), n)
        cells += (live.sum() + others * full.sum() + (n - c).sum()
                  + np.minimum(np.arange(N), kmax)[lanes].sum()
                  + vectors * lanes.sum()
                  + len(np.unique((D + I + 1)[full])))
    return 4.0 * (cells + lens * W2 * W + B * N_SCAL + B + B * N * N)


def reread_ms(kernel, inp):
    """A long kernel's HBM re-read floor in ms: the bytes its O(d) sums
    load on this run's live cells, at the HBM rate, as if the L2 kept none
    of them.  Both models sum alike: inside (K8, K12) 16 B a bifurcation
    term t >= 1; outside (K9, K13) 8 B a pm term, 12 B an sa/sbc term."""
    inside = kernel.endswith("_inside_long")
    if not inside and not kernel.endswith("_outside_long"):
        raise ValueError(f"reread_ms: {kernel} is not a long kernel")
    nbytes = 0.0
    for n, d, lanes in _live_cells(inp["ns"].tolist()):
        if inside:
            nbytes += 16.0 * float((lanes * np.maximum(d - 1, 0)).sum())
        else:
            nbytes += float((4.0 * (lanes - 1) * np.maximum(lanes - 2, 0)
                             + 6.0 * lanes * (lanes - 1)).sum())
    return nbytes / PEAK_BYTES_PER_S * 1e3


def bound(kernel, inp):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    FLOPs over the FP32 rate."""
    nbytes, flops = work(kernel, inp)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def skew_library_call(tables):
    """One PyTorch call computing K3's forward skew of ``tables``: a
    torch.gather over the tables stacked and zero-padded to width 2N (the
    padding and the index are built once, outside the timed call)."""
    from rna_algos_tpu_torch.ops import pallas_skew as K3

    x = torch.stack(tables)
    T, B, N, _ = x.shape
    pad = torch.cat([x, torch.zeros_like(x)], dim=-1)
    p = torch.arange(N, device=x.device)
    idx = (p[:, None] + p[None, :]).expand(T, B, N, N).contiguous()

    def call():
        return torch.gather(pad, 3, idx)

    if not torch.equal(call(), torch.stack(K3.skew_pq_batch_plain(tables))):
        raise AssertionError("torch.gather skew differs from K3's plain version")
    return call


def log_inputs(model, N, B, seed, device, lengths=None):
    """The arguments the parity path hands its inside and outside kernels
    (K16/K17 for CONTRA, K18/K19 for Turner) on B random sequences of
    N/2 + 10 to N nt (or of the given ``lengths``), recorded from one run of
    the path's fold function (the outside's from the inside kernel's
    outputs)."""
    from rna_algos_tpu_torch.ops import pallas_fold as PF
    from rna_algos_tpu_torch.params import build_fold_score_sets
    from rna_algos_tpu_torch.weights import contra_tables, turner_tables

    if lengths is None:
        batch = random_batch(B, max(30, N // 2 + 10), N, seed)
    else:
        rng = np.random.default_rng(seed)
        batch = [list(rng.integers(0, 4, size=n)) for n in lengths]
    seqs, ns = padded(batch, N, device)
    kernels = (f"{model}_inside_log", f"{model}_outside_log")
    if model == "contra":
        fold = PF.mccaskill_contra_pallas
        tbl = contra_tables(build_fold_score_sets(), device)
    else:
        fold = PF.mccaskill_turner_pallas
        tbl = turner_tables(device)
    seen, saved = {}, {k: getattr(PF, k) for k in kernels}

    def recorder(k):
        def call(*args):
            seen[k] = args
            return saved[k](*args)
        return call

    for k in kernels:
        setattr(PF, k, recorder(k))
    try:
        fold(seqs, ns, tbl, N)
    finally:
        for k in kernels:
            setattr(PF, k, saved[k])
    return dict(seqs=seqs, ns=ns, kernels=kernels,
                inside_args=seen[kernels[0]], outside_args=seen[kernels[1]])


def log_live(x, like):
    """(B, N, N) [d, i] mask of x's live cells (i + d < n) on ``like``'s
    device."""
    N = like.shape[-1]
    r = torch.arange(N, device=like.device)
    return ((r[None, :, None] + r[None, None, :])
            < x["ns"].to(like.device).view(-1, 1, 1))


def check_log(x, kernel, args):
    """A log kernel (K16-K19) against its plain version on the card: the
    -inf pattern identical, no NaN, finite cells within RTOL_LOG *
    max(1, |x|), and bitwise equal; K16/K18 on the live cells, every dead
    one holding its fill (LOG_INSIDE_FILLS).  Returns (max abs error,
    max relative error, bitwise, the plain version's ms: CUDA events around
    its one call)."""
    kern, plain = wrappers(kernel)
    label = LABELS[kernel]
    got = kern(*args)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = plain(*args)
    t1.record()
    t1.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    names = ("close", "ext", "one") if len(got) == 3 else ("bppo",)
    if kernel.endswith("_inside_log"):
        live = log_live(x, got[0])
        for name, g, fill in zip(names, got, LOG_INSIDE_FILLS):
            if not bool((g[~live] == fill).all()):
                raise AssertionError(f"{label} {name}: a dead cell lost "
                                     "its fill")
        got = tuple(g[live] for g in got)
        want = tuple(w[live] for w in want)
        names = tuple(f"{nm} (live cells)" for nm in names)
    worst_abs = worst_rel = 0.0
    bitwise = True
    for name, g, w in zip(names, got, want):
        if not torch.equal(torch.isinf(g), torch.isinf(w)) or bool(
                torch.isnan(g).any()):
            raise AssertionError(f"{label} {name}: -inf pattern differs "
                                 "from plain")
        fin = torch.isfinite(w)
        err = (g[fin] - w[fin]).abs()
        rel = err / w[fin].abs().clamp(min=1.0)
        exact = torch.equal(g.view(torch.int32), w.view(torch.int32))
        bitwise &= exact
        a = float(err.max()) if err.numel() else 0.0
        r = float(rel.max()) if rel.numel() else 0.0
        print(f"  {label} {name}: max abs err {a:.3e} max rel err {r:.3e}, "
              f"-inf pattern identical, bitwise equal: {exact}")
        if not r <= RTOL_LOG:
            raise AssertionError(f"{label} {name} differs from plain: {r}")
        if not exact:
            raise AssertionError(f"{label} {name} is not bitwise equal to "
                                 "its plain version")
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    return worst_abs, worst_rel, bitwise, t0.elapsed_time(t1)


def check_log_dead_cells(x, which=1):
    """A log kernel lets no dead cell through: x's inside (``which`` = 0,
    K16 or K18) or outside kernel (1, K17 or K19), with NaN in every dead
    cell (i + d >= n) of each (B, N, N) [d, i] table it is handed and in
    all of its scratch, gives bitwise the outputs of the call on the
    untouched inputs, with the fills in every dead cell (bppo's -inf;
    LOG_INSIDE_FILLS).  Two kernel launches, no plain version (on CPU
    tensors, two calls of the plain version: the outside's only, whose dead
    cells hold -inf too)."""
    from rna_algos_tpu_torch.ops import pallas_fold as PF

    kernel = x["kernels"][which]
    kern = wrappers(kernel)[0]
    args = (x["inside_args"], x["outside_args"])[which]
    want = kern(*args)
    want = want if isinstance(want, tuple) else (want,)
    fills = LOG_INSIDE_FILLS if which == 0 else (float("-inf"),)
    dead = ~log_live(x, want[0])
    nan = torch.full((), float("nan"), device=want[0].device)
    mats = {k: torch.where(dead, nan, v) if v.shape == dead.shape else v
            for k, v in args[0].items()}
    name = ("_inside_log_scratch", "_outside_log_scratch")[which]
    scratch = getattr(PF, name)
    setattr(PF, name, lambda *a, **kw: tuple(
        t.fill_(float("nan")) for t in scratch(*a, **kw)))
    try:
        got = kern(mats, *args[1:])
    finally:
        setattr(PF, name, scratch)
    got = got if isinstance(got, tuple) else (got,)
    for g, w, fill in zip(got, want, fills):
        if not (torch.equal(g.view(torch.int32), w.view(torch.int32))
                and bool((g[dead] == fill).all())):
            raise AssertionError(f"{LABELS[kernel]}: a dead cell or the "
                                 "scratch reached its outputs")
    print(f"  {LABELS[kernel]}: NaN in every dead table cell and the "
          "scratch, outputs bitwise unchanged, dead cells their fills")


def log_groups(N):
    """K16-K19's launch layout at N, for the log."""
    from rna_algos_tpu_torch.ops import pallas_fold as PF

    g = PF.log_group(N)
    return (f"K17/K19 {g} threads a lane; K16/K18 a span's live lanes and "
            f"its cells that can close {g} to 32 threads each (the most that "
            f"fit); {N * g} threads a sequence, cluster size 1")


def log_checks(device, err, rel, times, smi):
    """Phase 2 for K16-K19: each against its plain version at the main
    paths' shapes, its ms per launch (3 after a warm-up) beside the plain
    version's and the bound, into ``err``, ``rel`` and
    ``times[kernel][shape]``; before that each alone, bitwise, on the edge
    batches of LOG_EDGE, and with their dead cells poisoned."""
    for N, lengths in LOG_EDGE.items():
        for model in ("contra", "turner"):
            x = log_inputs(model, N, len(lengths), seed=5 * N + len(model),
                           device=device, lengths=lengths)
            print(f"check {model} log edge N={N} n={lengths}, "
                  f"{log_groups(N)}")
            for which, args in enumerate((x["inside_args"],
                                          x["outside_args"])):
                kernel = x["kernels"][which]
                a, _r, _exact, _pms = check_log(x, kernel, args)
                err[kernel] = max(err[kernel], a)
                check_log_dead_cells(x, which)
    for N, B in SHAPES_MAIN:
        for model in ("contra", "turner"):
            x = log_inputs(model, N, B, seed=11 * N + len(model), device=device)
            print(f"check {model} log N={N} B={B}, {log_groups(N)}")
            for kernel, args in zip(x["kernels"],
                                    (x["inside_args"], x["outside_args"])):
                a, r, exact, pms = check_log(x, kernel, args)
                err[kernel] = max(err[kernel], a)
                rel[kernel] = max(rel.get(kernel, 0.0), r)
                ms = cuda_ms(lambda: wrappers(kernel)[0](*args), 3)
                bms, by = bound(kernel, x)
                times[kernel][f"N{N}_B{B}"] = (ms, pms, bms, by, None)
                print(f"time N={N} B={B} {kernel}: kernel {ms:.4f} ms, plain "
                      f"{pms:.4f} ms, bound {bms:.4f} ms ({by}), share "
                      f"{bms / ms:.4f}, bitwise {exact}, on {smi}")


def dot_bracket_pairs(db):
    """The (i, j) pairs of a dot-bracket string."""
    stack, pairs = [], []
    for k, ch in enumerate(db):
        if ch == "(":
            stack.append(k)
        elif ch == ")":
            pairs.append((stack.pop(), k))
    return pairs


def turner_centroid_verdict(ref_dir, out_dir):
    """The Turner centroid files against centroid_turner/: "identical" if
    all are byte-identical, "tie" if they are except that record 0 of
    centroid_threshold=1.fa leaves out the golden's pair (2, 80) and
    nothing else (TURNER_TIE); raises otherwise."""
    ref_dir, out_dir = pathlib.Path(ref_dir), pathlib.Path(out_dir)
    names = sorted(os.listdir(ref_dir))
    if names != sorted(os.listdir(out_dir)):
        raise AssertionError("centroid CLI wrote other files")
    tie_file, tie_rec, (p, q) = TURNER_TIE
    verdict = "identical"
    for nm in names:
        want = (ref_dir / nm).read_text()
        got = (out_dir / nm).read_text()
        if got == want:
            continue
        lines = want.split("\n")
        rec = lines[2 * tie_rec + 1]
        lines[2 * tie_rec + 1] = rec[:p] + "." + rec[p + 1:q] + "." + rec[q + 1:]
        if nm != tie_file or (p, q) not in dot_bracket_pairs(rec) or (
                got != "\n".join(lines)):
            raise AssertionError(f"Turner centroid output differs: {nm}")
        verdict = "tie"
    return verdict


def wrap(seqs):
    """The sequences with PSEUDO_BASE sentinels at both ends."""
    from rna_algos_tpu_torch.constants import PSEUDO_BASE

    return [np.concatenate([[PSEUDO_BASE], s, [PSEUDO_BASE]]).astype(
        np.int32) for s in seqs]


def durbin_sets(trnas):
    """name -> (sentinel-wrapped sequences, all (i < j) pairs)."""
    count, lo, hi, seed = DURBIN_RFAM
    out = {}
    for name, seqs in (("trna_N128_P630", trnas * 6),
                       ("rfam_N256_P2016", random_batch(count, lo, hi, seed))):
        w = wrap(seqs)
        out[name] = (w, [(a, b) for a in range(len(w))
                         for b in range(a + 1, len(w))])
    return out


def durbin_inputs(seqs, pairs, device):
    """A Durbin set as its main path hands it to K14 and K15: padded pairs
    at their bucket, the tables at each pair's settled ln_sigma (K14) and
    the log-space tables (K15)."""
    from rna_algos_tpu_torch.ops import pallas_align as PA
    from rna_algos_tpu_torch.ops import pallas_align_prob as PAP
    from rna_algos_tpu_torch.params import build_align_scores
    from rna_algos_tpu_torch.parallel.runner import align_bucket, pad_seqs
    from rna_algos_tpu_torch.weights import align_tables

    N = max(max(align_bucket(len(seqs[a]), len(seqs[b])))
            for a, b in pairs)

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)

    x1 = dev(pad_seqs([seqs[a] for a, _ in pairs], N))
    x2 = dev(pad_seqs([seqs[b] for _, b in pairs], N))
    n1 = dev([len(seqs[a]) for a, _ in pairs])
    n2 = dev([len(seqs[b]) for _, b in pairs])
    at = align_tables(build_align_scores(), device)
    with recorded_ln_sigma() as seen:
        PAP.durbin_match_probs_batch_pallas_prob(x1, n1, x2, n2, at, N)
    ls = seen[-1].to(device)
    P = len(pairs)
    zero = torch.zeros((), device=device)
    init = (at["init_match_score"], at["init_insert_score"])
    log_scal = (PA._scalars(at, *init), PA._scalars(at, zero, zero))
    log_tables = (at["match_scores"].expand(P, 5, 5).contiguous(),
                  at["insert_scores"].expand(P, 5).contiguous(), *log_scal)
    return dict(
        N=N, P=P, n1=n1, n2=n2, seq_args=(x1, x2, n1, n2),
        pairhmm_prob=(
            torch.exp(at["match_scores"][None] - 2.0 * ls[:, None, None]),
            torch.exp(at["insert_scores"][None] - ls[:, None]),
            *(torch.exp(s) for s in log_scal)),
        pairhmm_log=log_tables, pairhmm_log_fast=log_tables,
    )


def pairhmm_wrappers(kernel):
    """(wrapper, plain version) of K14, K15 or K15's fast instance."""
    import functools

    from rna_algos_tpu_torch.ops import pallas_align as PA
    from rna_algos_tpu_torch.ops import pallas_align_prob as PAP

    if kernel == "pairhmm_log_fast":
        return (functools.partial(PA.pairhmm_log, fast=True),
                functools.partial(PA.pairhmm_log_plain, fast=True))
    mod = PAP if kernel == "pairhmm_prob" else PA
    return getattr(mod, kernel), getattr(mod, kernel + "_plain")


def pairhmm_calls(kernel, x, fn):
    """The forward and the backward launch of ``kernel`` on ``x``."""
    ms, ins, scal_f, scal_b = x[kernel]
    return [lambda: fn(*x["seq_args"], ms, ins, scal_f, False),
            lambda: fn(*x["seq_args"], ms, ins, scal_b, True)]


@contextlib.contextmanager
def poisoned_planes():
    """The pair-HMM wrappers' (K14, K15, K22) output planes NaN-filled
    before each launch."""
    from rna_algos_tpu_torch.ops import pallas_align as PA

    plane = PA._plane
    PA._plane = lambda *a: plane(*a).fill_(float("nan"))
    try:
        yield
    finally:
        PA._plane = plane


def check_pairhmm(x, kernel):
    """K14 or K15 bitwise equal to its plain version on both passes,
    planes and corners, with the output planes as allocated and
    NaN-filled; K15's fast instance within RTOL_LOG_FAST.  Returns the
    worst error (0 where bitwise)."""
    kern, plain = pairhmm_wrappers(kernel)
    label = LABELS[kernel]
    fast = kernel == "pairhmm_log_fast"
    worst = 0.0
    for direction, k_call, p_call in zip(
            ("forward", "backward"), pairhmm_calls(kernel, x, kern),
            pairhmm_calls(kernel, x, plain)):
        want = p_call()
        with poisoned_planes():
            poisoned = k_call()
        for how, got in (("", k_call()), (", planes NaN-filled", poisoned)):
            torch.cuda.synchronize()
            for part, g, w in zip(("plane", "corner"), got, want):
                if fast:
                    ok, d = log_close(g, w, RTOL_LOG_FAST)
                    worst = max(worst, d)
                else:
                    ok = torch.equal(g.view(torch.int32), w.view(torch.int32))
                if not ok:
                    raise AssertionError(f"{label} {direction} {part}{how} "
                                         "differs from plain")
        print(f"  {label} {direction}: planes and corners "
              + (f"within {worst:.3e} (relative) of" if fast
                 else "bitwise equal to")
              + " plain, also with the planes NaN-filled")
    return worst


def durbin_edge_inputs(device):
    """DURBIN_EDGE: all pairs (a < b) of seeded random sequences of the
    listed wrapped lengths, one bucket each."""
    from rna_algos_tpu_torch.constants import PSEUDO_BASE

    out = {}
    for N, lengths in DURBIN_EDGE.items():
        rng = np.random.default_rng(N)
        seqs = [np.concatenate([[PSEUDO_BASE], rng.integers(0, 4, n - 2),
                                [PSEUDO_BASE]]).astype(np.int32)
                for n in lengths]
        pairs = [(a, b) for a in range(len(seqs))
                 for b in range(a + 1, len(seqs))]
        x = out[N] = durbin_inputs(seqs, pairs, device)
        assert x["N"] == N
    return out


def pairhmm_bound(kernel, x):
    """(bound_ms, bound_by) of one launch (the mean of the forward and the
    backward pass): per pair the two sequences, lengths and tables read
    once, the (N, N) plane and the 3 corner sums written once; the float
    operations of the live cells (n1 - 1)(n2 - 1) of this run's pairs."""
    P, N = x["P"], x["N"]
    nbytes = P * (2 * 4 * N + 2 * 4 + 4 * 30 + 4 * N * N + 4 * 3) + 4 * 5
    cells = float(((x["n1"] - 1).double() * (x["n2"] - 1).double()).sum())
    ops = cells * sum(PAIRHMM_CELL_OPS[kernel]) / 2.0
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


DURBIN_RUNS = (("durbin_exact", "exact", "trna_N128_P630"),
               ("durbin_exact", "exact", "rfam_N256_P2016"),
               ("durbin_parity", "parity", "trna_N128_P630"))


def durbin_checks(dsets, device, err):
    """K14 and K15 against their plain versions on each Durbin set and the
    edge batches (phase 2); records the worst error in ``err``, returns the
    inputs by set."""
    dinputs = {}
    for key, (seqs, pairs) in dsets.items():
        dinputs[key] = durbin_inputs(seqs, pairs, device)
    edges = {f"edge_N{N}": x for N, x in durbin_edge_inputs(device).items()}
    for key, x in {**dinputs, **edges}.items():
        print(f"check Durbin {key}: N={x['N']} P={x['P']} at each pair's "
              "settled ln_sigma")
        for k in PAIRHMM_CELL_OPS:
            err[k] = max(err[k], check_pairhmm(x, k))
    return dinputs


def durbin_times(dinputs, times):
    """K14's and K15's ms per launch (a forward and a backward launch per
    timed call), the plain versions' (one call, just after the check ran
    them), and the bound, into ``times[kernel][shape]``."""
    for x in dinputs.values():
        shape = f"N{x['N']}_P{x['P']}"
        for k in PAIRHMM_CELL_OPS:
            kern, plain = pairhmm_wrappers(k)
            kc, pc = pairhmm_calls(k, x, kern), pairhmm_calls(k, x, plain)
            ms = cuda_ms(lambda: [c() for c in kc], 10) / 2
            pms = cuda_ms(lambda: [c() for c in pc], 1, warmup=False) / 2
            bms, by = pairhmm_bound(k, x)
            times[k][shape] = (ms, pms, bms, by, None)
            print(f"time {shape} {k}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"bound {bms:.4f} ms ({by}), share {bms / ms:.4f}")


def durbin_paths(dsets, aligners, counted, counts, path_kernels, smi):
    """The Durbin main paths (phase 3): each set through
    ``AlignEngine.match_probs_pairs``, counted on its own (its kernel
    launched, the plain wavefront never called), timed on the host clock
    (the call ends in the copy to the host), its peak memory read (above
    what the script held before it), and held against the plain path on
    the card (exact: every pair's ln_sigma equal).  Returns the stats by
    run."""
    stats = {}
    for path, mode, key in DURBIN_RUNS:
        seqs, pairs = dsets[key]
        label = f"{path}_{key}"
        kernel = path_kernels[path][0]
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with recorded_ln_sigma() as ls_k, counted_plain_pairhmm() as n_plain:
            t0 = time.perf_counter()
            got = counted(label, path,
                          lambda: aligners[mode].match_probs_pairs(seqs, pairs))
            wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        counts.setdefault(path, {k: 0 for k in counts[label]})
        for k, v in counts[label].items():
            counts[path][k] += v
        if n_plain[0]:
            raise AssertionError(f"{label}: the plain wavefront ran "
                                 f"{n_plain[0]} times on the kernel path")
        runs = counts[label][kernel] // 2
        t0 = time.perf_counter()
        with plain_kernels(), recorded_ln_sigma() as ls_p:
            plain = aligners[mode].match_probs_pairs(seqs, pairs)
        pwall = time.perf_counter() - t0
        worst = 0.0
        if list(got) != pairs or list(plain) != pairs:
            raise AssertionError(f"{label}: the keys are not the pairs")
        for (a, b) in pairs:
            g, w = got[(a, b)], plain[(a, b)]
            if not (g.shape == (len(seqs[a]), len(seqs[b]))
                    and np.isfinite(g).all() and (g >= -1e-3).all()
                    and (g < 1.001).all()):
                raise AssertionError(f"{label}: bad probabilities for {a},{b}")
            worst = max(worst, float(np.abs(g - w).max()))
        same_ls = len(ls_k) == len(ls_p) and all(
            torch.equal(a, b) for a, b in zip(ls_k, ls_p))
        print(f"{label}: kernel vs plain path max |dp| {worst:.3e} "
              f"(ln_sigma of every pair equal: {same_ls}); "
              f"{len(pairs) / wall:.2f} pairs/s ({wall:.3f} s), plain path "
              f"{len(pairs) / pwall:.2f} pairs/s; {runs} runs of {kernel} "
              f"({runs - 1} retries), plain wavefront calls 0; peak memory "
              f"{peak:.3f} GiB above the {held / 2**30:.3f} GiB held before, "
              f"on {smi}")
        if not worst <= TOL_DURBIN[mode] or (mode == "exact" and not same_ls):
            raise AssertionError(f"{label}: main path disagrees with plain")
        stats[label] = dict(pairs_per_s_first_call=len(pairs) / wall,
                            retries=runs - 1, peak_gib=peak,
                            plain_pairs_per_s=len(pairs) / pwall)
    return stats


def durbin_clis(du_cli, fasta, golden):
    """cli.durbin (phase 4): parity (K15) against the C-baseline golden,
    exact (K14) on the card against the same CLI on the CPU."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        du_cli.main(["-i", fasta, "-o", str(tmp / "parity.txt"),
                     "--numerics", "parity"])
        du_cli.main(["-i", fasta, "-o", str(tmp / "exact.txt")])
        du_cli.main(["-i", fasta, "-o", str(tmp / "exact_cpu.txt"),
                     "--device", "cpu"])
        parity_text = (tmp / "parity.txt").read_text()
        exact, exact_cpu = (parse_triples((tmp / f).read_text())
                            for f in ("exact.txt", "exact_cpu.txt"))
    golden_text = (pathlib.Path(golden) / "durbin.txt").read_text()
    worst, _ = compare_triples(parse_triples(golden_text),
                               parse_triples(parity_text), TOL_GOLDEN,
                               "cli.durbin --numerics parity vs c_baseline")
    print(f"cli.durbin --numerics parity vs c_baseline/durbin.txt: same keys, "
          f"worst {worst:.3e}, byte-identical {parity_text == golden_text}")
    worst, n_edge = compare_triples(
        exact_cpu, exact, TOL_DURBIN_CLI, "cli.durbin on the card vs the CPU",
        floor=float(torch.finfo(torch.float32).tiny))
    print(f"cli.durbin exact on the card vs --device cpu: worst {worst:.3e}, "
          f"{n_edge} keys on one side only (all subnormal)")


def durbin_throughput(dsets, aligners, stats, smi):
    """pairs/s of each Durbin run (phase 5): CUDA events around 3 calls
    after a warm-up."""
    for path, mode, key in DURBIN_RUNS:
        seqs, pairs = dsets[key]
        ms = cuda_ms(lambda: aligners[mode].match_probs_pairs(seqs, pairs), 3)
        stats[f"{path}_{key}"]["pairs_per_s"] = len(pairs) / (ms / 1e3)
        print(f"throughput {path} {key} kernel: {len(pairs) / (ms / 1e3):.2f} "
              f"pairs/s ({ms:.2f} ms/call) on {smi}")


def tree_combines(n):
    """Combines of lax.associative_scan's tree over n elements: the pairs,
    the even outputs past the first, and the half's own tree."""
    return 0 if n < 2 else n // 2 + (n + 1) // 2 - 1 + tree_combines(n // 2)


def rows_sets(trnas):
    """name -> (sentinel-wrapped sequences, all (i < j) pairs) of K22's
    paths."""
    rnasep = random_batch(*ROWS_RNASEP[:3], seed=ROWS_RNASEP[3])
    ssu = random_batch(*ROWS_SSU[:3], seed=ROWS_SSU[3])
    out = {}
    for name, seqs in (("rnasep_P496", rnasep), ("ssu_P28", ssu),
                       ("mixed_P66", trnas + rnasep[:ROWS_MIXED])):
        w = wrap(seqs)
        out[name] = (w, [(a, b) for a in range(len(w))
                         for b in range(a + 1, len(w))])
    return out


def rows_buckets(seqs, pairs):
    """{(N1, N2): [pairs]} by the engine's rule."""
    from rna_algos_tpu_torch.parallel.runner import align_bucket

    out = {}
    for a, b in pairs:
        out.setdefault(align_bucket(len(seqs[a]), len(seqs[b])), []).append(
            (a, b))
    return out


def rows_inputs(seqs, pairs, key, device):
    """The pairs of one row-scan bucket as the main path hands them to
    K22: padded (P, N1) and (P, N2), lengths, the log-space tables and the
    forward and backward scalars."""
    from rna_algos_tpu_torch.ops import pallas_align as PA
    from rna_algos_tpu_torch.params import build_align_scores
    from rna_algos_tpu_torch.parallel.runner import pad_seqs
    from rna_algos_tpu_torch.weights import align_tables

    N1, N2 = key

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)

    P = len(pairs)
    at = align_tables(build_align_scores(), device)
    zero = torch.zeros((), device=device)
    return dict(
        N1=N1, N2=N2, P=P,
        x1=dev(pad_seqs([seqs[a] for a, _ in pairs], N1)),
        x2=dev(pad_seqs([seqs[b] for _, b in pairs], N2)),
        n1=dev([len(seqs[a]) for a, _ in pairs]),
        n2=dev([len(seqs[b]) for _, b in pairs]),
        ms=at["match_scores"].expand(P, 5, 5).contiguous(),
        ins=at["insert_scores"].expand(P, 5).contiguous(),
        scal=(PA._scalars(at, at["init_match_score"], at["init_insert_score"]),
              PA._scalars(at, zero, zero)))


def rows_edge_inputs(device):
    """ROWS_EDGE: seeded random pairs of the listed wrapped lengths."""
    from rna_algos_tpu_torch.constants import PSEUDO_BASE

    out = {}
    for key, lengths in ROWS_EDGE.items():
        rng = np.random.default_rng(sum(key))

        def one(n):
            return np.concatenate([[PSEUDO_BASE], rng.integers(0, 4, n - 2),
                                   [PSEUDO_BASE]]).astype(np.int32)

        seqs = [s for n1, n2 in lengths for s in (one(n1), one(n2))]
        pairs = [(2 * k, 2 * k + 1) for k in range(len(lengths))]
        out[key] = rows_inputs(seqs, pairs, key, device)
    return out


def rows_call(x, backward, mode, fn=None):
    from rna_algos_tpu_torch.ops import pairhmm_rows as PR

    fn = fn or PR.pairhmm_rows
    return fn(x["x1"], x["x2"], x["n1"], x["n2"], x["ms"], x["ins"],
              x["scal"][int(backward)], backward, mode)


def log_close(got, want, rtol):
    """(ok, worst relative error): the -inf pattern identical and finite
    cells within rtol * max(1, |x|)."""
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        return False, float("inf")
    fin = torch.isfinite(want)
    if not torch.isfinite(got[fin]).all():
        return False, float("inf")
    if not fin.any():
        return True, 0.0
    d = float(((got - want).abs()[fin] / want.abs()[fin].clamp(min=1)).max())
    return d <= rtol, d


def check_rows(x, label, modes, fast_err):
    """K22 against its plain version on both passes, planes and corners:
    bitwise under "exact" and "parity", also with the planes NaN-filled;
    within RTOL_LOG_FAST under "fast".  Returns the plain versions' ms per
    pass under the first mode (host clock, device synchronized)."""
    from rna_algos_tpu_torch.ops import pairhmm_rows as PR

    plain_ms = []
    for mode in modes:
        for backward in (False, True):
            direction = "backward" if backward else "forward"
            want, pms = host_ms(lambda: rows_call(x, backward, mode,
                                                  PR.pairhmm_rows_plain))
            if mode == modes[0]:
                plain_ms.append(pms)
            got = rows_call(x, backward, mode)
            with poisoned_planes():
                poisoned = rows_call(x, backward, mode)
            torch.cuda.synchronize()
            for how, out in (("", got), (", planes NaN-filled", poisoned)):
                for part, g, w in zip(("plane", "corner"), out, want):
                    if mode == "fast":
                        ok, d = log_close(g, w, RTOL_LOG_FAST)
                        fast_err["pairhmm_rows"] = max(
                            fast_err.get("pairhmm_rows", 0.0), d)
                    else:
                        ok = torch.equal(g.view(torch.int32),
                                         w.view(torch.int32))
                    if not ok:
                        raise AssertionError(f"K22 {label} {mode} {direction} "
                                             f"{part}{how} differs from plain")
            print(f"  K22 {label} {mode} {direction}: planes and corners "
                  + ("within RTOL_LOG_FAST of" if mode == "fast"
                     else "bitwise equal to")
                  + " plain, also with the planes NaN-filled")
    return plain_ms


def rows_bound(x):
    """(bound_ms, bound_by) of one K22 pass (the mean of the forward and the
    backward pass): per pair the two sequences, lengths and tables read
    once, the (N1, N2) plane and the 3 corner sums written once; the float
    operations of this run's live cells and trees (ROWS_CELL_OPS,
    ROWS_COMBINE_OPS)."""
    P, N1, N2 = x["P"], x["N1"], x["N2"]
    nbytes = P * (4 * (N1 + N2) + 2 * 4 + 4 * 30 + 4 * N1 * N2 + 4 * 3) + 4 * 5
    ops = 0.0
    for a, b in zip(x["n1"].tolist(), x["n2"].tolist()):
        rows, cols = a - 1, b - 1
        ops += rows * cols * sum(ROWS_CELL_OPS) / 2.0
        ops += (rows * ROWS_COMBINE_OPS + 1) * tree_combines(cols)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rows_checks(rsets, fast_err, times, device):
    """K22 against its plain version (phase 2): on ROWS_EDGE under exact,
    parity and fast; at the RNase P set's two rectangular buckets and the
    SSU set's commonest bucket (all their pairs) under exact, and fast at
    the first; each pass timed beside the plain one and its bound, into
    ``times["pairhmm_rows"]``.  Prints each bucket's launch
    (``pairhmm_rows.rows_plan``)."""
    from rna_algos_tpu_torch.ops.pairhmm_rows import rows_plan

    for key, x in rows_edge_inputs(device).items():
        print(f"check K22 edge N1={key[0]} N2={key[1]} P={x['P']}, "
              f"launch {rows_plan(key[1])}")
        check_rows(x, f"edge {key}", ("exact", "parity", "fast"), fast_err)
    for k, (name, key) in enumerate(ROWS_CHECK):
        seqs, pairs = rsets[name]
        groups = rows_buckets(seqs, pairs)
        if key is None:
            key = max(groups, key=lambda g: len(groups[g]))
        x = rows_inputs(seqs, groups[key], key, device)
        shape = f"{name.split('_')[0]}_N{key[0]}x{key[1]}_P{x['P']}"
        print(f"check K22 {shape}, launch {rows_plan(key[1])}")
        modes = ("exact", "fast") if k == 0 else ("exact",)
        pms = check_rows(x, shape, modes, fast_err)
        ms = cuda_ms(lambda: [rows_call(x, b, "exact") for b in (0, 1)],
                     5) / 2
        bms, by = rows_bound(x)
        times["pairhmm_rows"][shape] = (ms, sum(pms) / 2, bms, by, None)
        print(f"time {shape} pairhmm_rows: kernel {ms:.4f} ms, plain "
              f"{sum(pms) / 2:.4f} ms, bound {bms:.4f} ms ({by}), share "
              f"{bms / ms:.4f}")


ROWS_RUNS = (("durbin_rows_exact", "exact", "rnasep_P496"),
             ("durbin_rows_parity", "parity", "rnasep_P496"),
             ("durbin_rows_exact", "exact", "ssu_P28"),
             ("durbin_mixed", "exact", "mixed_P66"))


def rows_paths(rsets, aligners, counted, counts, path_kernels, smi):
    """K22's main paths (phase 3): each set through
    ``AlignEngine.match_probs_pairs``, counted on its own (K22 launched, and
    K14 on the mixed set; the plain row scan and wavefront never called),
    timed on the host clock (the call ends in the copy to the host), its
    peak memory read, and held against the plain path on the card on a
    subset (ROWS_SUBSET pairs of the K22 bucket with the fewest rows
    bitwise; the mixed set's K14 pairs within TOL_DURBIN).  Returns the
    stats by run."""
    stats = {}
    for path, mode, key in ROWS_RUNS:
        seqs, pairs = rsets[key]
        label = f"{path}_{key}"
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with counted_plain_pairhmm(rows=True) as n_rows, \
                counted_plain_pairhmm() as n_wave:
            t0 = time.perf_counter()
            got = counted(label, path,
                          lambda: aligners[mode].match_probs_pairs(seqs, pairs))
            wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        counts.setdefault(path, {k: 0 for k in counts[label]})
        for k, v in counts[label].items():
            counts[path][k] += v
        if n_rows[0] or n_wave[0]:
            raise AssertionError(f"{label}: a plain version ran on the "
                                 "kernel path")
        if list(got) != pairs:
            raise AssertionError(f"{label}: the keys are not the pairs")
        for (a, b) in pairs:
            g = got[(a, b)]
            if not (g.shape == (len(seqs[a]), len(seqs[b]))
                    and np.isfinite(g).all() and (g >= -1e-3).all()
                    and (g < 1.001).all() and g.max() > 0.0):
                raise AssertionError(f"{label}: bad probabilities for {a},{b}")
        groups = rows_buckets(seqs, pairs)
        rows = {k: ps for k, ps in groups.items()
                if not (k[0] == k[1] and k[0] <= 256)}
        subset = rows[min(rows)][:ROWS_SUBSET]
        wave = [p for k, ps in groups.items() if k not in rows for p in ps]
        t0 = time.perf_counter()
        with plain_kernels():
            plain = aligners[mode].match_probs_pairs(seqs, subset + wave)
        pwall = time.perf_counter() - t0
        for k in subset:
            if not np.array_equal(got[k].view(np.int32),
                                  plain[k].view(np.int32)):
                raise AssertionError(f"{label}: pair {k} differs from the "
                                     "plain path")
        worst = max([float(np.abs(got[k] - plain[k]).max()) for k in wave],
                    default=0.0)
        if not worst <= TOL_DURBIN[mode]:
            raise AssertionError(f"{label}: K14 pairs differ from plain")
        launches = {k: counts[label][k] for k in path_kernels[path]}
        print(f"{label}: {len(pairs)} pairs in buckets "
              f"{sorted((k, len(v)) for k, v in groups.items())}; "
              f"{len(pairs) / wall:.2f} pairs/s ({wall:.3f} s, first call); "
              f"{len(subset)} K22 pairs bitwise equal to the plain path"
              + (f", {len(wave)} K14 pairs within {worst:.3e}" if wave else "")
              + f" (plain path {pwall:.3f} s); launches {launches}, plain "
              f"versions called 0 times; peak memory {peak:.3f} GiB above "
              f"the {held / 2**30:.3f} GiB held before, on {smi}")
        stats[label] = dict(pairs_per_s_first_call=len(pairs) / wall,
                            peak_gib=peak, buckets=len(groups),
                            plain_subset_s=pwall)
    return stats


def rows_throughput(rsets, aligners, stats, smi):
    """pairs/s of each K22 run (phase 5): CUDA events around 3 calls after
    a warm-up."""
    for path, mode, key in ROWS_RUNS:
        seqs, pairs = rsets[key]
        ms = cuda_ms(lambda: aligners[mode].match_probs_pairs(seqs, pairs), 3)
        stats[f"{path}_{key}"]["pairs_per_s"] = len(pairs) / (ms / 1e3)
        print(f"throughput {path} {key} kernel: {len(pairs) / (ms / 1e3):.2f} "
              f"pairs/s ({ms:.2f} ms/call) on {smi}")


def rows_cli(du_cli, rsets):
    """cli.durbin on a FASTA of a tRNA and three RNase P records (pairs in
    row-scan buckets), and on one of a tRNA and a ROWS_LONG_RECORD-nt
    record (the bucket (96, 4224), past the 4,096 columns K22 took before
    its redesign): the card's output byte-identical to --device cpu's,
    under exact and parity."""
    seqs, _ = rsets["mixed_P66"]
    long_rec = wrap(random_batch(1, ROWS_LONG_RECORD, ROWS_LONG_RECORD,
                                 seed=ROWS_LONG_RECORD))[0]
    for recs in ([seqs[0]] + seqs[-3:], [seqs[0], long_rec]):
        rows_cli_run(du_cli, recs)


def rows_cli_run(du_cli, recs):
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "long.fa").write_text("".join(
            f">r{k}\n" + "".join("ACGU"[b] for b in s[1:-1]) + "\n"
            for k, s in enumerate(recs)))
        for mode in ("exact", "parity"):
            texts = []
            for device in ("cuda", "cpu"):
                out = tmp / f"{mode}_{device}.txt"
                du_cli.main(["-i", str(tmp / "long.fa"), "-o", str(out),
                             "--numerics", mode, "--device", device])
                texts.append(out.read_text())
            n_keys = sum(len(v) for v in parse_triples(texts[0]).values())
            if texts[0] != texts[1]:
                raise AssertionError(f"cli.durbin --numerics {mode}: the "
                                     "card's output differs from the CPU's")
            print(f"cli.durbin --numerics {mode} on records of "
                  f"{[len(s) - 2 for s in recs]} nt: the card's output "
                  f"byte-identical to --device cpu's ({n_keys} triples)")


def k15_fast_path(args, counted, counts, smi):
    """K15's fast instance through ``durbin_match_probs_batch_pallas``
    (numerics="fast") on the tRNA pairs (phase 3), counted on its own,
    against the plain path on the card within TOL_DURBIN_FAST."""
    from rna_algos_tpu_torch.ops import pallas_align as PA
    from rna_algos_tpu_torch.params import build_align_scores
    from rna_algos_tpu_torch.weights import align_tables

    at = align_tables(build_align_scores(), torch.device("cuda"))
    x1, x2, n1, n2 = args
    N = x1.shape[1]

    def run():
        return PA.durbin_match_probs_batch_pallas(x1, n1, x2, n2, at, N,
                                                  numerics="fast")

    with counted_plain_pairhmm() as n_plain:
        got, ms = host_ms(lambda: counted("durbin_log_fast", "durbin_log_fast",
                                          run))
    with plain_kernels():
        plain = run()
    worst = float((got - plain).abs().max())
    print(f"durbin_log_fast (K15 fast, {x1.shape[0]} pairs at N={N}): vs "
          f"plain path max |dp| {worst:.3e}, {ms:.2f} ms, plain wavefront "
          f"calls {n_plain[0]}, on {smi}")
    if n_plain[0] or not worst <= TOL_DURBIN_FAST:
        raise AssertionError("durbin_log_fast: main path disagrees with plain")
    return worst


def parse_triples(text):
    """{record id: {(i, j): p}} of a triples file (mccaskill / durbin)."""
    out, cur = {}, None
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith(">"):
            cur = out.setdefault(line[1:], {})
            continue
        for tok in line.split():
            i, j, p = tok.split(",")
            cur[(int(i), int(j))] = float(p)
    return out


def compare_triples(ref, got, tol, label, floor=0.0):
    """Worst |difference| of two triples files on their keys; raises unless
    the records and keys are equal (keys whose value is below ``floor`` on
    the one side that has them excepted) and the worst is within ``tol``."""
    if list(ref) != list(got):
        raise AssertionError(f"{label}: records differ")
    worst, n_edge = 0.0, 0
    for rid in ref:
        r, g = ref[rid], got[rid]
        for key in set(r) ^ set(g):
            if max(r.get(key, 0.0), g.get(key, 0.0)) >= floor:
                raise AssertionError(f"{label}: record {rid} key {key} "
                                     "on one side only")
            n_edge += 1
        for key in set(r) & set(g):
            worst = max(worst, abs(r[key] - g[key]))
    if not worst <= tol:
        raise AssertionError(f"{label}: worst difference {worst} > {tol}")
    return worst, n_edge


def cuda_ms(fn, reps, warmup=True):
    """Mean milliseconds per call from CUDA events, after one warm-up
    (``warmup=False``: the caller has just run ``fn``'s work)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


@contextlib.contextmanager
def plain_kernels():
    """Route the main paths through the plain versions on the card."""
    from rna_algos_tpu_torch.models import mccaskill as M
    from rna_algos_tpu_torch.ops import pallas_align as PA
    from rna_algos_tpu_torch.ops import fold_scan as FS
    from rna_algos_tpu_torch.ops import pairhmm_rows as PR
    from rna_algos_tpu_torch.ops import pallas_align_prob as PAP
    from rna_algos_tpu_torch.ops import pallas_fold as PF
    from rna_algos_tpu_torch.ops import pallas_fold_long as PL
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8
    from rna_algos_tpu_torch.ops import pallas_skew as K3

    swaps = [(P8, k, getattr(P8, k + "_plain")) for k in KERNELS_P8]
    swaps += [(PL, k, getattr(PL, k + "_plain")) for k in KERNELS_LONG]
    swaps += [(mod, "skew_pq_batch", K3.skew_pq_batch_plain)
              for mod in (P8, PF, M)]
    swaps += [(PAP, "pairhmm_prob", PAP.pairhmm_prob_plain),
              (PA, "pairhmm_log", PA.pairhmm_log_plain),
              (PR, "pairhmm_rows", PR.pairhmm_rows_plain)]
    swaps += [(PF, k, getattr(PF, k + "_plain")) for k in LOG_KERNELS]
    swaps += [(FS, k, getattr(FS, k + "_plain"))
              for k in ("scan_inside", "scan_outside")]
    saved = [(mod, k, getattr(mod, k)) for mod, k, _ in swaps]
    for mod, k, fn in swaps:
        setattr(mod, k, fn)
    try:
        yield
    finally:
        for mod, k, fn in saved:
            setattr(mod, k, fn)


@contextlib.contextmanager
def counted_plain_pairhmm(rows=False):
    """Count the calls of the pair-HMM plain wavefront (K14's and K15's
    plain versions), or with ``rows`` of the plain row scan (K22's), while
    the block runs: a one-item list."""
    from rna_algos_tpu_torch.ops import pairhmm_rows as PR
    from rna_algos_tpu_torch.ops import pallas_align as PA

    mod, name = (PR, "_rows_pass") if rows else (PA, "_pairhmm_plain")
    calls, orig = [0], getattr(mod, name)

    def plain(*args):
        calls[0] += 1
        return orig(*args)

    setattr(mod, name, plain)
    try:
        yield calls
    finally:
        setattr(mod, name, orig)


@contextlib.contextmanager
def counted_plain_log():
    """Count the calls of the log-space plain wavefronts (the plain versions
    of K16-K19) while the block runs: a one-item list."""
    from rna_algos_tpu_torch.ops import pallas_fold as PF

    calls = [0]
    saved = {k: getattr(PF, k) for k in ("_inside_log_plain",
                                         "_outside_log_plain")}

    def counting(fn):
        def call(*args, **kw):
            calls[0] += 1
            return fn(*args, **kw)
        return call

    for k, fn in saved.items():
        setattr(PF, k, counting(fn))
    try:
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(PF, k, fn)


def parity_paths(engines, batches, counted, counts, path_kernels, smi):
    """The parity main paths (phase 3): FoldEngine(numerics="parity") for
    each model on each batch, counted on its own (one inside and one
    outside launch a bucket, K3 for the skews, the plain log wavefronts
    never called), its peak memory read (above what the script held
    before), held against the plain path on the card (the same presence,
    BPP within TOL_PARITY_MAIN), and its seqs/s (CUDA events around 3 calls
    after a warm-up).  Returns the stats by run and the kernel path's
    results."""
    stats, results = {}, {}
    for model, engine in engines.items():
        path = f"{model}_parity"
        ik, ok = path_kernels[path][1:]
        for key, seqs in batches.items():
            label = f"{path}_{key}"
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            with counted_plain_log() as n_plain:
                got = counted(label, path, lambda: engine.fold_batch(seqs))
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            counts.setdefault(path, {k: 0 for k in counts[label]})
            for k, v in counts[label].items():
                counts[path][k] += v
            if n_plain[0] or counts[label][ik] != 1 or counts[label][ok] != 1:
                raise AssertionError(
                    f"{label}: {counts[label]}, plain log wavefront calls "
                    f"{n_plain[0]} (want 1 inside, 1 outside, 0 plain)")
            with plain_kernels():
                plain = engine.fold_batch(seqs)
            worst = 0.0
            for (bk, pk), (bp, pp), s in zip(got, plain, seqs):
                if not (bk.shape == (len(s), len(s)) and np.isfinite(bk).all()
                        and np.array_equal(pk, pp)):
                    raise AssertionError(f"{label}: presence or shape differs "
                                         "from the plain path")
                worst = max(worst, float(np.abs(bk - bp).max()))
            if not worst <= TOL_PARITY_MAIN:
                raise AssertionError(f"{label}: main path disagrees with plain")
            ms = cuda_ms(lambda: engine.fold_batch(seqs), 3)
            stats[label] = dict(seqs_per_s=len(seqs) / (ms / 1e3),
                                peak_gib=peak)
            results[label] = got
            print(f"{label}: kernel vs plain path max |dBPP| {worst:.3e}, "
                  f"presence identical; {len(seqs) / (ms / 1e3):.2f} seqs/s "
                  f"({ms:.2f} ms/batch); launches {ik} 1, {ok} 1, plain log "
                  f"wavefront calls 0; peak memory {peak:.3f} GiB above the "
                  f"{held / 2**30:.3f} GiB held before, on {smi}")
    return stats, results


def parity_clis(mc_cli, cf_cli, fasta, golden):
    """The fold CLIs under --numerics parity (phase 4): cli.mccaskill with
    and without -c against the C-baseline triples (identical key sets, BPP
    within TOL_GOLDEN), cli.centroid_fold -c byte for byte against
    centroid_contra/ and without -c against centroid_turner/ under the tie
    rule.  Returns the Turner verdict and the BPP of the tie pair."""
    tie_file, tie_rec, tie_pair = TURNER_TIE
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for flag, gold in (("-c", "mccaskill_contra.txt"),
                           (None, "mccaskill_turner.txt")):
            out = tmp / gold
            mc_cli.main(["-i", fasta, "-o", str(out), "--numerics", "parity"]
                        + ([flag] if flag else []))
            got = parse_triples(out.read_text())
            worst, _ = compare_triples(
                parse_triples((golden / gold).read_text()), got, TOL_GOLDEN,
                f"cli.mccaskill --numerics parity vs {gold}")
            print(f"cli.mccaskill --numerics parity {flag or ''} vs "
                  f"c_baseline/{gold}: identical key sets, worst {worst:.3e}")
        tie_bpp = got[str(tie_rec)][tie_pair]
        cf_cli.main(["-i", fasta, "-o", str(tmp / "cc"), "-c", "--numerics",
                     "parity"])
        ref_dir = golden / "centroid_contra"
        names = sorted(os.listdir(ref_dir))
        if names != sorted(os.listdir(tmp / "cc")) or any(
                (ref_dir / nm).read_bytes() != (tmp / "cc" / nm).read_bytes()
                for nm in names):
            raise AssertionError("centroid CLI -c --numerics parity differs "
                                 "from centroid_contra/")
        cf_cli.main(["-i", fasta, "-o", str(tmp / "ct"), "--numerics",
                     "parity"])
        verdict = turner_centroid_verdict(golden / "centroid_turner",
                                          tmp / "ct")
    print(f"centroid CLI --numerics parity: -c {len(names)} files "
          f"byte-identical; Turner verdict {verdict}; Turner record "
          f"{tie_rec} BPP at {tie_pair}: {tie_bpp!r} (golden 1.0000076)")
    return verdict, tie_bpp


@contextlib.contextmanager
def recorded_ln_sigma():
    """Record the ln_sigma each retry loop settles on (one (B,) tensor per
    fold, in the engine's sorted order, or per Durbin bucket)."""
    from rna_algos_tpu_torch.ops import pallas_fold_prob as PP

    seen, orig = [], PP._retrying

    def retrying(run, ns, **kw):
        bppo, ls = orig(run, ns, **kw)
        seen.append(ls.cpu())
        return bppo, ls

    PP._retrying = retrying
    try:
        yield seen
    finally:
        PP._retrying = orig


def scan_inputs(model, N, B, seed, device, lengths=None):
    """A generic-scan batch: seqs (B, N) int64, ns (B,) int32, the model's
    tables and its (B, N, N) score tables, on ``device``; random lengths in
    [N / 2, N] (sequence 0 fills the bucket) unless ``lengths`` is given."""
    from rna_algos_tpu_torch.models import mccaskill as M
    from rna_algos_tpu_torch.params import build_fold_score_sets
    from rna_algos_tpu_torch.weights import contra_tables, turner_tables

    if lengths is None:
        rng = np.random.default_rng(seed)
        lengths = [N] + [int(rng.integers(N // 2, N + 1))
                         for _ in range(B - 1)]
    rng = np.random.default_rng(seed + 1)
    seqs = np.full((len(lengths), N), 4, dtype=np.int64)
    for k, n in enumerate(lengths):
        seqs[k, :n] = rng.integers(0, 4, size=n)
    seqs = torch.as_tensor(seqs, device=device)
    ns = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    contra = model == "contra"
    tbl = (contra_tables(build_fold_score_sets(), device) if contra
           else turner_tables(device))
    return dict(model=model, contra=contra, seqs=seqs, ns=ns, tbl=tbl,
                pre=M._precompute(seqs, ns, tbl, N, contra))


def scan_live(ns, N, right):
    """(B, N, N) mask of a scan table's live cells: [b, i, d] with
    i + d < n (left layout) or [b, j, e] with e <= j < n (right)."""
    r = torch.arange(N, device=ns.device)
    n = ns.view(-1, 1, 1)
    if right:
        return (r[:, None] >= r[None, :])[None] & (r[None, :, None] < n)
    return (r[:, None] + r[None, :])[None] < n


def scan_poisoned(x):
    """The score tables with NaN in every dead cell (i + d >= n), and
    CANON true there: what K20/K21 must never read."""
    N = x["seqs"].shape[1]
    dead = ~scan_live(x["ns"], N, False)
    return {k: (v | dead if v.dtype == torch.bool
                else torch.where(dead, float("nan"), v))
            for k, v in x["pre"].items()}


def scan_compare(kernel, got, want, x, mode, label):
    """Max |difference| of a pass's state tables on the live cells, after
    the check: bitwise under exact and parity, under fast the -inf pattern
    identical and finite cells within RTOL_SCAN_FAST * max(1, |x|)."""
    N = x["seqs"].shape[1]
    worst = 0.0
    for k in SCAN_STATE[kernel]:
        if k == "qrmmb" and not x["contra"]:
            continue
        live = scan_live(x["ns"], N, k.startswith("q"))
        a, b = got[k][live], want[k][live]
        if torch.isnan(a).any() or not torch.equal(torch.isfinite(a),
                                                   torch.isfinite(b)):
            raise AssertionError(f"{label} {kernel} {k}: NaN or -inf pattern")
        fin = torch.isfinite(b)
        diff = (a[fin] - b[fin]).abs()
        if diff.numel():
            worst = max(worst, float(diff.max()))
        if mode == "fast":
            ok = bool((diff <= RTOL_SCAN_FAST
                       * b[fin].abs().clamp(min=1.0)).all())
        else:
            ok = torch.equal(a, b)
        if not ok:
            raise AssertionError(f"{label} {kernel} {k}: kernel differs from "
                                 f"plain (max {worst:.3e}, {mode})")
    return worst


def host_ms(fn):
    """(fn(), milliseconds) on the host clock, the device synchronized
    before and after: for the plain passes, host-driven spans of small
    torch operations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def poisoned_state():
    """The scan wrappers' state tables NaN-filled before each pass."""
    from rna_algos_tpu_torch.ops import fold_scan as FS

    state = FS._state
    FS._state = lambda *a: {k: v.fill_(float("nan"))
                            for k, v in state(*a).items()}
    try:
        yield
    finally:
        FS._state = state


@contextlib.contextmanager
def narrow_groups(cap, blocks):
    """The scan wrappers' groups held at most ``cap`` threads wide and
    their grid at ``blocks`` blocks, so that each span takes the narrowest
    groups its trees allow (the most tree leaves a thread) and its lanes
    in many rounds."""
    from rna_algos_tpu_torch.ops import fold_scan as FS

    saved = FS.GROUP_CAP, FS.GRID_CAP
    FS.GROUP_CAP, FS.GRID_CAP = cap, blocks
    try:
        yield
    finally:
        FS.GROUP_CAP, FS.GRID_CAP = saved


def scan_plain(x, mode):
    """The plain inside and outside passes on ``x`` in ``mode`` and their
    times on the host clock: (inside, outside, {kernel: ms})."""
    from rna_algos_tpu_torch.ops import fold_scan as FS

    a = (x["seqs"], x["ns"], x["tbl"], x["pre"])
    ins, ms_in = host_ms(
        lambda: FS.scan_inside_plain(*a, x["contra"], False, mode))
    out, ms_out = host_ms(
        lambda: FS.scan_outside_plain(*a, ins, x["contra"], False, mode))
    return ins, out, {"scan_inside": ms_in, "scan_outside": ms_out}


def check_scan(x, mode, err, fast_err, plain, poison=False):
    """K20 and K21 against ``plain`` = scan_plain(x, mode), each on the
    same inputs (K21 on the plain inside pass's tables); with ``poison``
    the kernels get NaN-filled state tables (poisoned_state) and score
    tables with NaN in every dead cell, and K21 K20's tables."""
    from rna_algos_tpu_torch.ops import fold_scan as FS

    a = (x["seqs"], x["ns"], x["tbl"])
    c, label = x["contra"], f"{x['model']} N={x['seqs'].shape[1]}"
    ins_p, out_p, _ = plain
    pre = scan_poisoned(x) if poison else x["pre"]
    with poisoned_state() if poison else contextlib.nullcontext():
        ins_k = FS.scan_inside(*a, pre, c, False, mode)
        e_in = scan_compare("scan_inside", ins_k, ins_p, x, mode, label)
        out_k = FS.scan_outside(*a, pre, ins_k if poison else ins_p, c,
                                False, mode)
    e_out = scan_compare("scan_outside", out_k, out_p, x, mode, label)
    into = fast_err if mode == "fast" else err
    for kernel, e in (("scan_inside", e_in), ("scan_outside", e_out)):
        into[kernel] = max(into.get(kernel, 0.0), e)
    return e_in, e_out


def scan_work(kernel, x):
    """(bytes, FLOPs) of one pass (one launch) of K20 or K21 on ``x``: the
    terms this run's data needs (SCAN_OPS) and each table cell once at the
    live cells (SCAN_TABLES), counted on the host."""
    from rna_algos_tpu_torch.ops import fold_scan as FS

    inside = kernel == "scan_inside"
    N = x["seqs"].shape[1]
    span_min = FS.min_span(x["contra"], False)
    reads, writes = SCAN_TABLES[(kernel, x["model"])]
    canon = x["pre"]["canon"].cpu().numpy()
    I, D = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    ab = np.add.outer(np.arange(31), np.arange(31))
    win_in = np.array([(ab <= d - 2).sum() for d in range(N)])
    flops, cells = 0.0, 0.0
    for b, n in enumerate(x["ns"].tolist()):
        live = I + D < n
        cells += live.sum()
        if inside:
            win, full, ext, s12, cell = SCAN_OPS["inside"]
            closes = live & canon[b] & (D + 1 >= span_min)
            flops += (cell * live.sum() + ext * D[live].sum()
                      + s12 * np.maximum(D - 1, 0)[live].sum()
                      + full * closes.sum() + win * win_in[D[closes]].sum())
        else:
            win, ctx, cell, pm = SCAN_OPS["outside"]
            close = x.get("close")
            pair = live & (D + 1 >= span_min)
            if close is not None:
                pair &= np.isfinite(close[b])
            r = n - 1 - I - D
            flops += (pm * r[live & (D + 1 >= span_min)].sum()
                      + cell * pair.sum() + ctx * I[pair].sum()
                      + win * (np.minimum(I, 31)
                               * np.minimum(np.maximum(r, 0), 31))[pair].sum())
    return 4.0 * cells * (reads + writes) + cells, flops


def scan_reread_ms(kernel, x):
    """K20's or K21's HBM re-read floor in ms: the bytes its O(d) sums
    load on this run's live cells, at the HBM rate, as if the L2 kept none
    of them (reread_ms's rule).  Inside: 12 B a term t >= 1 (rm, ext, one;
    CONTRA 16 B with rmmb); outside: 4 B a pm term (G) and 4 B one's for
    k >= 2, and at the pair cells 8 B a context term (pm, pm2) and 4 B
    qone's for t >= 2."""
    N = x["seqs"].shape[1]
    I, D = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    nbytes = 0.0
    for b, n in enumerate(x["ns"].tolist()):
        live = I + D < n
        if kernel == "scan_inside":
            per = 16.0 if x["contra"] else 12.0
            nbytes += per * float(np.maximum(D - 1, 0)[live].sum())
        else:
            r = (n - 1 - I - D)[live]
            nbytes += float((4.0 * r + 4.0 * np.maximum(r - 1, 0)).sum())
            pair = live & np.isfinite(x["close"][b])
            nbytes += float((8.0 * I + 4.0 * np.maximum(I - 1, 0))[pair]
                            .sum())
    return nbytes / PEAK_BYTES_PER_S * 1e3


def scan_bound(kernel, x):
    nbytes, flops = scan_work(kernel, x)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_checks(device, err, fast_err, times, smi):
    """Phase 2 for K20/K21: both models against the plain versions at
    SCAN_CHECK under exact and fast, and under exact also with NaN-poisoned
    inputs and with the narrowest groups (SCAN_NARROW); on SCAN_EDGE under
    exact, fast and parity and poisoned.  Each pass timed (CUDA events, two
    passes after a warm-up) beside its plain version's exact pass (host
    clock, one pass) and its bound at SCAN_CHECK."""
    from rna_algos_tpu_torch.ops import fold_scan as FS

    for model in ("contra", "turner"):
        for N, B in SCAN_CHECK:
            x = scan_inputs(model, N, B, seed=N + B, device=device)
            for mode in ("exact", "fast"):
                t0 = time.perf_counter()
                plain = scan_plain(x, mode)
                if mode == "exact":
                    plain_ms = plain[2]
                e = check_scan(x, mode, err, fast_err, plain)
                print(f"check scan {model} N={N} B={B} {mode}: K20 "
                      f"{e[0]:.3e}, K21 {e[1]:.3e} "
                      f"({'bitwise' if mode != 'fast' else 'tolerance'}; "
                      f"{time.perf_counter() - t0:.1f} s)")
                if mode != "exact":
                    continue
                check_scan(x, mode, err, fast_err, plain, poison=True)
                with narrow_groups(*SCAN_NARROW):
                    check_scan(x, mode, err, fast_err, plain)
                print(f"check scan {model} N={N} B={B}: NaN-poisoned state "
                      f"and dead cells, and the narrowest groups on "
                      f"{SCAN_NARROW[1]} blocks, bitwise")
            del plain
            a = (x["seqs"], x["ns"], x["tbl"], x["pre"])
            ins = FS.scan_inside(*a, x["contra"])
            x["close"] = ins["close"].cpu().numpy()
            for kernel, kern, args in (
                    ("scan_inside", FS.scan_inside, a + (x["contra"],)),
                    ("scan_outside", FS.scan_outside,
                     a + (ins, x["contra"]))):
                ms = cuda_ms(lambda: kern(*args), 2)
                pms = plain_ms[kernel]
                bms, by = scan_bound(kernel, x)
                times[kernel][f"N{N}_B{B}_{model}"] = (ms, pms, bms, by, None)
                print(f"time N={N} B={B} {model} {kernel} (one pass, one "
                      f"launch on {FS.grid_blocks(kernel == 'scan_inside', x['contra'], 'exact')} "
                      f"blocks): kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                      f"bound {bms:.4f} ms ({by}), HBM re-read floor "
                      f"{scan_reread_ms(kernel, x):.4f} ms on {smi}")
        for N, lengths in SCAN_EDGE.items():
            x = scan_inputs(model, N, len(lengths), seed=3 * N,
                            device=device, lengths=lengths)
            for mode in ("exact", "fast", "parity"):
                plain = scan_plain(x, mode)
                e = check_scan(x, mode, err, fast_err, plain)
                print(f"check scan {model} edge N={N} n={lengths} {mode}: "
                      f"K20 {e[0]:.3e}, K21 {e[1]:.3e}")
                if mode == "exact":
                    check_scan(x, mode, err, fast_err, plain, poison=True)
                    print(f"check scan {model} edge N={N}: NaN-poisoned, "
                          "bitwise")


@contextlib.contextmanager
def counted_plain_scan():
    """Count the calls of the scan's plain passes while the block runs: a
    one-item list."""
    from rna_algos_tpu_torch.ops import fold_scan as FS

    calls = [0]
    saved = {k: getattr(FS, k) for k in ("scan_inside_plain",
                                         "scan_outside_plain")}

    def counting(fn):
        def call(*args, **kw):
            calls[0] += 1
            return fn(*args, **kw)
        return call

    for k, fn in saved.items():
        setattr(FS, k, counting(fn))
    try:
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(FS, k, fn)


def scan_paths(counted, counts, path_kernels, smi):
    """The generic main paths (phase 3), each counted on its own: K20 and
    K21 launched once a pass (one pass each a bucket), the plain scan
    never called; held against the plain path on the card (the same
    presence, BPP within TOL_SCAN_MAIN), seqs/s (host clock around one
    call that ends in a copy to the host) and peak memory above what the
    script held.  The Turner batch also against the float64 golden of
    seq_1536 (TOL_GOLDEN_SCAN).  Returns the stats by run."""
    from rna_algos_tpu_torch.parallel.runner import FoldEngine, kernel_bucket

    g = np.load(ROOT / "tests" / "golden" / "longn_f64_1536.npz")
    seq_1536 = [int(b) for b in g["seq_1536"]]
    runs = [
        ("turner_scan", "exact",
         [seq_1536] + random_batch(*SCAN_TURNER[:3], seed=SCAN_TURNER[3])),
        ("contra_scan", "exact", random_batch(*SCAN_CONTRA[:3],
                                              seed=SCAN_CONTRA[3])),
    ]
    for model in ("contra", "turner"):
        runs.append((f"{model}_parity_scan", "parity",
                     random_batch(*SCAN_PARITY[:3], seed=SCAN_PARITY[3])))
    stats = {}
    for path, mode, seqs in runs:
        contra = path.startswith("contra")
        engine = FoldEngine(uses_contra_model=contra, device="cuda",
                            numerics=mode)
        Ns = {kernel_bucket(len(s), contra, mode) for s in seqs}
        if len(Ns) != 1:
            raise AssertionError(f"{path}: buckets {Ns}")
        (N,) = Ns
        label = f"{path}_N{N}_B{len(seqs)}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with counted_plain_scan() as n_plain:
            t0 = time.perf_counter()
            got = counted(label, path, lambda: engine.fold_batch(seqs))
            wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        c = counts[label]
        counts.setdefault(path, {k: 0 for k in c})
        for k, v in c.items():
            counts[path][k] += v
        if n_plain[0] or c["scan_inside"] != 1 or c["scan_outside"] != 1:
            raise AssertionError(f"{label}: {c}, plain scan calls "
                                 f"{n_plain[0]} (want 1 + 1, 0 plain)")
        held_against = seqs[:1] if path == "contra_scan" else seqs
        t0 = time.perf_counter()
        with plain_kernels():
            plain = engine.fold_batch(held_against)
        pwall = time.perf_counter() - t0
        worst = 0.0
        for (bk, pk), (bp, pp), s in zip(got, plain, held_against):
            if not (bk.shape == (len(s), len(s)) and np.isfinite(bk).all()
                    and np.array_equal(pk, pp)):
                raise AssertionError(f"{label}: presence or shape differs "
                                     "from the plain path")
            worst = max(worst, float(np.abs(bk - bp).max()))
        if not worst <= TOL_SCAN_MAIN:
            raise AssertionError(f"{label}: main path disagrees with plain")
        note = ""
        if path == "turner_scan":
            drift = float(np.abs(got[0][0] - g["bpp_1536_turner"]).max())
            note = (f"; seq_1536 vs float64 golden max |dBPP| {drift:.3e} "
                    f"(gate {TOL_GOLDEN_SCAN:g})")
            if not drift <= TOL_GOLDEN_SCAN:
                raise AssertionError(f"{label}: outside the golden gate")
            stats[label + "_golden_drift"] = drift
        nh = len(held_against)
        stats[label] = dict(seqs_per_s=len(seqs) / wall, seconds=wall,
                            plain_seqs_per_s=nh / pwall, held_against=nh,
                            peak_gib=peak, max_abs_vs_plain=worst)
        print(f"{label}: kernel vs plain path max |dBPP| {worst:.3e} on "
              f"{nh} of {len(seqs)} sequences, presence identical{note}; "
              f"{len(seqs) / wall:.4f} seqs/s ({wall:.3f} s/batch), plain "
              f"path {nh / pwall:.4f} seqs/s; launches scan_inside 1, scan_outside 1, plain "
              f"scan calls 0; peak memory {peak:.3f} GiB above the "
              f"{held / 2**30:.3f} GiB held before, on {smi}")
    return stats


def scan_long(counted, counts, smi):
    """Past 5,461 nt (phase 3), where K21's context trees pass 16,384
    terms: Turner exact on a seeded SCAN_LONG-nt
    sequence and seq_1536, padded to one bucket, through
    mccaskill_bpp_batch_auto (the engine's call), counted on its own: K20
    and K21 one launch each, the plain scan never called.  seq_1536's BPPs
    within TOL_GOLDEN_SCAN of its float64 golden; the long sequence's
    finite, in [0, 1 + TOL_GOLDEN_SCAN], upper triangular (i < j), each
    base paired with probability at most 1 + TOL_GOLDEN_SCAN.  Returns seqs/s, peak memory and the drift."""
    from rna_algos_tpu_torch.models import mccaskill as M
    from rna_algos_tpu_torch.parallel.runner import kernel_bucket, pad_seqs
    from rna_algos_tpu_torch.weights import turner_tables

    g = np.load(ROOT / "tests" / "golden" / "longn_f64_1536.npz")
    seqs = random_batch(1, SCAN_LONG, SCAN_LONG, seed=SCAN_LONG) + [
        [int(b) for b in g["seq_1536"]]]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # past 2048 nt
        N = kernel_bucket(SCAN_LONG, False)
    arr = torch.as_tensor(pad_seqs(seqs, N), dtype=torch.int64,
                          device="cuda")
    ns = torch.as_tensor([len(s) for s in seqs], dtype=torch.int32,
                         device="cuda")
    tbl = turner_tables("cuda")
    label = f"turner_scan_long_N{N}_B2"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with counted_plain_scan() as n_plain:
        t0 = time.perf_counter()
        bpp, _ = counted(label, "turner_scan_long",
                         lambda: M.mccaskill_bpp_batch_auto(arr, ns, tbl, N))
        bpp = bpp.cpu().numpy()
        wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    c = counts[label]
    counts["turner_scan_long"] = c
    if n_plain[0] or c["scan_inside"] != 1 or c["scan_outside"] != 1:
        raise AssertionError(f"{label}: {c}, plain scan calls {n_plain[0]} "
                             f"(want 1 + 1, 0 plain)")
    long = bpp[0, :SCAN_LONG, :SCAN_LONG]
    paired = float((long + long.T).sum(axis=1).max())
    drift = float(np.abs(bpp[1, :1536, :1536]
                         - g["bpp_1536_turner"]).max())
    print(f"{label}: finite {np.isfinite(long).all()}, BPP in "
          f"[{long.min():.6f}, {long.max():.6f}], below the diagonal "
          f"{np.abs(np.tril(long)).max():g}, max P(paired) {paired:.6f}; "
          f"seq_1536 vs its float64 golden {drift:.3e}")
    if not (np.isfinite(long).all() and long.min() >= 0.0
            and long.max() <= 1.0 + TOL_GOLDEN_SCAN
            and not np.tril(long).any()
            and paired <= 1.0 + TOL_GOLDEN_SCAN):
        raise AssertionError(f"{label}: the {SCAN_LONG}-nt BPPs are not a "
                             "pair-probability matrix")
    if not drift <= TOL_GOLDEN_SCAN:
        raise AssertionError(f"{label}: seq_1536 outside the golden gate")
    print(f"{label}: {SCAN_LONG}-nt BPPs finite, within the gates, i < j, "
          f"max P(paired) {paired:.6f}; seq_1536 in the same bucket vs its "
          f"float64 golden max |dBPP| {drift:.3e} (gate "
          f"{TOL_GOLDEN_SCAN:g}); {2 / wall:.4f} seqs/s ({wall:.3f} "
          f"s/batch); launches scan_inside 1, scan_outside 1, plain scan "
          f"calls 0; peak memory {peak:.3f} GiB above the "
          f"{held / 2**30:.3f} GiB held before, on {smi}")
    return {label: dict(seqs_per_s=2 / wall, seconds=wall, peak_gib=peak,
                        golden_drift_seq_1536=drift, max_paired=paired)}


def scan_cli(mc_cli, cf_cli):
    """cli.mccaskill and cli.centroid_fold, --numerics parity -c, on a
    400-nt record (bucket 512: the generic scan under parity) on the card
    against --device cpu: the same key set and BPP within TOL_SCAN_MAIN,
    the centroid files byte for byte."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (seq,) = random_batch(1, 400, 400, seed=401)
        fa = tmp / "r.fa"
        fa.write_text(">r400\n" + "".join("ACGU"[b] for b in seq) + "\n")
        outs = {}
        for device in ("cuda", "cpu"):
            flags = ["-c", "--numerics", "parity", "--device", device]
            out = tmp / f"{device}.txt"
            mc_cli.main(["-i", str(fa), "-o", str(out)] + flags)
            outs[device] = parse_triples(out.read_text())
            cf_cli.main(["-i", str(fa), "-o", str(tmp / device)] + flags)
        names = sorted(os.listdir(tmp / "cpu"))
        if names != sorted(os.listdir(tmp / "cuda")) or any(
                (tmp / "cpu" / nm).read_bytes()
                != (tmp / "cuda" / nm).read_bytes() for nm in names):
            raise AssertionError("cli.centroid_fold --numerics parity, 400 "
                                 "nt: the card's files differ from the CPU's")
    worst, _ = compare_triples(outs["cpu"], outs["cuda"], TOL_SCAN_MAIN,
                               "cli.mccaskill --numerics parity -c, 400 nt")
    print(f"cli.mccaskill --numerics parity -c, 400-nt record: card vs "
          f"--device cpu, identical key sets, worst {worst:.3e}; "
          f"cli.centroid_fold: {len(names)} files byte-identical")
    return worst

# K23, the gamma-centroid MEA fill, against its plain version with the 18
# gammas: (bucket N, records R), the records of different n in the bucket;
# up to 332 the shared form, past it the cluster form.  (128, 192) and
# (256, 96) are the main paths' shapes, launched as centroid_structures
# launches them (fill_chunks); 332 / 333 straddle the form switch and
# 511 / 512 of one record a cluster-size switch (rna_mea_fill_plan).
MEA_CHECK = ((96, 6), (256, 4), (384, 2), (128, 192), (256, 96), (512, 8),
             (1536, 1), (332, 2), (333, 2), (511, 1), (512, 1))
# the shapes whose centroid_structures run is split into fill, copy and
# traceback (mea_split)
MEA_SPLIT = ((128, 192), (256, 96))
# share of the BPP cells i < j < n that are nonzero in mea_inputs
MEA_NONZERO = 0.5


def mea_inputs(N, R, seed, device):
    """(R, N, N) float32 BPP-like matrices padded to bucket N, record r of
    length N - (r % 16) * N // 16: symmetric, MEA_NONZERO of the cells
    i < j < n nonzero, each a uniform variate to the sixth power (mostly
    small, as a fold's BPPs are)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((R, N, N), np.float32)
    for r in range(R):
        n = N - (r % 16) * (N // 16)
        v = rng.random((n, n)) ** 6 * (rng.random((n, n)) < MEA_NONZERO)
        up = np.triu(v, 1).astype(np.float32)
        out[r, :n, :n] = up + up.T
    return torch.as_tensor(out, device=device)


def mea_bound(R, G, N):
    """(bound_ms, bound_by) of R x G fills at bucket N: each live cell
    (i < j) of the BPPs, the gammas and the square fills moved once, and
    two operations (an add and a max) a bifurcation term, (N - d)(d - 1)
    terms at span d."""
    terms = sum((N - d) * (d - 1) for d in range(2, N))
    nbytes = 4 * (R * N * (N - 1) // 2 + G + R * G * N * N)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * terms * R * G / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def nan_filled_fills():
    """K23's output allocated NaN-filled (the kernel must write every
    cell)."""
    from rna_algos_tpu_torch.ops import mea_fill as MF

    orig = MF._fills
    MF._fills = lambda *a: orig(*a).fill_(float("nan"))
    try:
        yield
    finally:
        MF._fills = orig


def mea_bitwise(got, want, label):
    """Raise unless ``got`` is ``want`` bit for bit, NaN at the same cells;
    the number of NaN cells."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    gn, wn = np.isnan(g), np.isnan(w)
    if g.shape != w.shape or not (gn == wn).all() or not np.array_equal(
            g[~gn].view(np.int32), w[~wn].view(np.int32)):
        raise AssertionError(f"K23 {label}: not bitwise its plain version")
    return int(gn.sum())


def check_mea(x, label, chunks=None):
    """K23 on ``x`` against its plain version, bitwise: as allocated, with
    its output NaN-filled, and with one NaN BPP cell (NaN at the same cells
    of both).  ``chunks``: the (start, stop) record ranges of its launches
    (one launch by default).  Returns the plain version's output on ``x``
    and that first plain call's time (CUDA events, ms)."""
    from rna_algos_tpu_torch.models.centroid import DEFAULT_GAMMAS
    from rna_algos_tpu_torch.ops import mea_fill as MF

    chunks = chunks or [(0, x.shape[0])]

    def fill(y):
        return torch.cat([MF.mea_fill_batch(y[c0:c1], DEFAULT_GAMMAS)
                          for c0, c1 in chunks])

    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    want = MF.mea_fill_batch_plain(x, DEFAULT_GAMMAS)
    t1.record()
    t1.synchronize()
    mea_bitwise(fill(x), want, label)
    with nan_filled_fills():
        mea_bitwise(fill(x), want, f"{label}, NaN-filled output")
    y = x.clone()
    y[0, 1, x.shape[1] // 2] = float("nan")
    nans = mea_bitwise(fill(y), MF.mea_fill_batch_plain(y, DEFAULT_GAMMAS),
                       f"{label}, one NaN BPP cell")
    print(f"check K23 {label}: bitwise, also NaN-filled and with one NaN "
          f"BPP cell ({nans} NaN fill cells in both)")
    return want, t0.elapsed_time(t1)


def mea_checks(device, err, times, smi):
    """Phase 2 for K23: at each MEA_CHECK shape, ``check_mea`` in the
    launches ``centroid_structures`` makes (``fill_chunks``), then the
    kernel's time (CUDA events, the mean of 5 calls of those launches
    after a warm-up; 2 past N = 1,024) beside the plain loop's (its first
    call in the check) and the bound, into ``times["mea_fill"]``."""
    from rna_algos_tpu_torch.models.centroid import (DEFAULT_GAMMAS,
                                                     fill_chunks)
    from rna_algos_tpu_torch.ops import mea_fill as MF

    G = len(DEFAULT_GAMMAS)
    for N, R in MEA_CHECK:
        x = mea_inputs(N, R, seed=N + R, device=device)
        shape = f"N{N}_R{R}"
        chunks = fill_chunks(R, G, N)
        plans = sorted({MF.plan(c1 - c0, G, N) for c0, c1 in chunks})
        form = "shared" if MF.state_in_shared(N) else "cluster"
        nl = f"{len(chunks)} launch{'es' if len(chunks) > 1 else ''}"
        label = f"{shape} G={G} ({form} form, plan {plans}, {nl})"
        _, pms = check_mea(x, label, chunks)
        err["mea_fill"] = 0.0
        ms = cuda_ms(lambda: [MF.mea_fill_batch(x[c0:c1], DEFAULT_GAMMAS)
                              for c0, c1 in chunks], 5 if N <= 1024 else 2)
        bms, by = mea_bound(R, G, N)
        times["mea_fill"][shape] = (ms, pms, bms, by, None)
        print(f"time {shape} G={G} mea_fill: kernel {ms:.4f} ms "
              f"({ms / R:.4f} ms a record, {nl}), plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms ({by}), share "
              f"{bms / ms:.4f}, on {smi}")
        del x
        torch.cuda.empty_cache()


def split_records(N, R):
    """(bpp, None, n) results of R records of n in (the bucket below, N]:
    ``mea_inputs``' matrices cut to n."""
    from rna_algos_tpu_torch.parallel.runner import pick_bucket

    x = mea_inputs(N, R, seed=N + R, device="cpu").numpy()
    results = []
    for r in range(R):
        n = N - (r % 8) * (N // 32)
        results.append((x[r, :n, :n], None, n))
    assert {pick_bucket(n) for _, _, n in results} == {N}
    return results


def mea_split(device, smi):
    """``centroid_structures`` on the card at each MEA_SPLIT shape
    (``split_records``), its PhaseTimer phases apart: the K23 launches
    (CUDA events), the copy of the fills to the host and the native
    traceback (host clock); the plain traceback must run 0 times and the
    native batch traceback once a chunk.  Returns {shape: {phase: ms}}."""
    from rna_algos_tpu_torch import _native
    from rna_algos_tpu_torch.models.centroid import (DEFAULT_GAMMAS,
                                                     centroid_structures,
                                                     fill_chunks)
    from rna_algos_tpu_torch.utils.trace import PhaseTimer

    out = {}
    for N, R in MEA_SPLIT:
        results = split_records(N, R)
        centroid_structures(results[:2], DEFAULT_GAMMAS, device)  # warm-up
        timer = PhaseTimer()
        _native.traceback_calls.reset()
        with counted_plain_traceback() as n_plain:
            centroid_structures(results, DEFAULT_GAMMAS, device, timer=timer)
        chunks = len(fill_chunks(R, len(DEFAULT_GAMMAS), N))
        if n_plain[0] or _native.traceback_calls.count != chunks:
            raise AssertionError(
                f"centroid_structures N{N}_R{R}: the plain traceback ran "
                f"{n_plain[0]} times, the native one "
                f"{_native.traceback_calls.count} times for {chunks} chunks")
        ph = timer.summary()
        parts = ", ".join(f"{k} {ph[k]['seconds'] * 1e3:.3f} ms "
                          f"({ph[k]['calls']} calls)"
                          for k in ("mea_fill", "fill_copy", "traceback"))
        print(f"centroid_structures N{N}_R{R} G={len(DEFAULT_GAMMAS)}: "
              f"{parts}; native traceback calls {chunks}, plain 0; on {smi}")
        out[f"N{N}_R{R}"] = {k: ph[k]["seconds"] * 1e3
                             for k in ("mea_fill", "fill_copy", "traceback")}
    return out


@contextlib.contextmanager
def counted_plain_traceback():
    """Count the calls of the plain traceback (``models.centroid.traceback``)
    while the block runs: a one-item list."""
    from rna_algos_tpu_torch.models import centroid as TC

    calls, orig = [0], TC.traceback

    def plain(*args):
        calls[0] += 1
        return orig(*args)

    TC.traceback = plain
    try:
        yield calls
    finally:
        TC.traceback = orig


# The native host runtime (_native, csrc/native_host.c): its batch
# traceback against the plain traceback at every (record, gamma) of
# MEA_SPLIT's shapes and one 1,536-nt record, on K23's fills; its formatter
# against probs2str on that record's triples (the nonzero cells i < j of
# its BPP-like matrix).
NATIVE_SHAPES = MEA_SPLIT + ((1536, 1),)
NATIVE_FORMAT_REPS = 3


def native_phase(device, smi):
    """The native host runtime on the card's path.  At each NATIVE_SHAPES
    shape: K23's fills of ``split_records``, in the launches
    ``centroid_structures`` makes, copied to the host; the native batch
    traceback (one call a launch) and the plain traceback at every
    (record, gamma), fatal unless their pairs are equal; each one's time
    (host clock).  Then ``mea_split``, and the formatter against
    ``probs2str`` on one record's triples: fatal unless the bytes are
    equal; the plain version's time (one call) beside the native one's
    (the mean of NATIVE_FORMAT_REPS).  Returns the phase's record."""
    from rna_algos_tpu_torch import _native
    from rna_algos_tpu_torch.models.centroid import (DEFAULT_GAMMAS,
                                                     fill_chunks, traceback)
    from rna_algos_tpu_torch.ops import mea_fill as MF
    from rna_algos_tpu_torch.utils.output import probs2str

    t0 = time.perf_counter()
    _native.library()
    rec = {"build_s": time.perf_counter() - t0,
           "library": _native.build().name, "traceback": {}}
    print(f"native: {rec['library']} built and loaded in "
          f"{rec['build_s']:.2f} s (cc {' '.join(_native.CC_FLAGS)})")
    G = len(DEFAULT_GAMMAS)
    for N, R in NATIVE_SHAPES:
        results = split_records(N, R)
        ns = [n for _, _, n in results]
        padded = np.zeros((R, N, N), np.float32)
        for r, (bpp, _, n) in enumerate(results):
            padded[r, :n, :n] = bpp
        t_native = t_plain = 0.0
        n_pairs = 0
        chunks = fill_chunks(R, G, N)
        for c0, c1 in chunks:
            fills = MF.mea_fill_batch(torch.as_tensor(padded[c0:c1],
                                                      device=device),
                                      DEFAULT_GAMMAS).cpu().numpy()
            t0 = time.perf_counter()
            pairs, counts = _native.traceback_batch(
                fills, padded[c0:c1], ns[c0:c1], DEFAULT_GAMMAS)
            t_native += time.perf_counter() - t0
            t0 = time.perf_counter()
            want = [[traceback(M, padded[r], g, ns[r])[0]
                     for g, M in zip(DEFAULT_GAMMAS, fills[r - c0])]
                    for r in range(c0, c1)]
            t_plain += time.perf_counter() - t0
            for r in range(c0, c1):
                for g in range(G):
                    got = [tuple(map(int, p))
                           for p in pairs[r - c0, g, :counts[r - c0, g]]]
                    if got != want[r - c0][g]:
                        raise AssertionError(
                            f"native traceback N{N}_R{R}: record {r} gamma "
                            f"{DEFAULT_GAMMAS[g]}: pairs differ from the "
                            "plain traceback's")
            n_pairs += int(counts.sum())
            del fills
        shape = f"N{N}_R{R}"
        rec["traceback"][shape] = {
            "structures": R * G, "pairs": n_pairs, "calls": len(chunks),
            "native_ms": t_native * 1e3, "plain_ms": t_plain * 1e3}
        print(f"native traceback {shape} G={G}: {R * G} structures, "
              f"{n_pairs} pairs, equal to the plain traceback's at every "
              f"(record, gamma); native {t_native * 1e3:.3f} ms in "
              f"{len(chunks)} calls, plain {t_plain * 1e3:.3f} ms, on {smi}")
    rec["centroid_structures"] = mea_split(device, smi)
    bpp, _, n = split_records(1536, 1)[0]
    iv, jv = np.nonzero(np.triu(bpp, 1))
    pv = bpp[iv, jv]
    t0 = time.perf_counter()
    want = probs2str(zip(iv, jv, pv))
    t_plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(NATIVE_FORMAT_REPS):
        got = _native.probs2str_arrays(iv, jv, pv)
    t_native = (time.perf_counter() - t0) / NATIVE_FORMAT_REPS
    if got != want:
        raise AssertionError("native probs2str: bytes differ from probs2str")
    rec["probs2str"] = {"triples": len(pv), "bytes": len(got),
                        "native_ms": t_native * 1e3,
                        "plain_ms": t_plain * 1e3}
    print(f"native probs2str, the {n}-nt record's {len(pv)} triples: "
          f"{len(got)} bytes identical to probs2str; native "
          f"{t_native * 1e3:.3f} ms, plain {t_plain * 1e3:.3f} ms, on {smi}")
    return rec


@contextlib.contextmanager
def formatter_checked(modules):
    """While the block runs, each CLI module's ``probs2str_arrays`` on the
    card also formats its triples with the plain ``probs2str`` and raises
    unless the bytes are equal: yields {"calls", "triples", "native_s",
    "plain_s"}."""
    from rna_algos_tpu_torch import _native
    from rna_algos_tpu_torch.utils.output import probs2str, probs2str_arrays

    seen = {"calls": 0, "triples": 0, "native_s": 0.0, "plain_s": 0.0}
    saved = {m: m.probs2str_arrays for m in modules}

    def checked(iv, jv, pv, device="cpu"):
        if not _native.on_card(device):
            raise AssertionError(f"a CLI formatted for {device} on the card")
        t0 = time.perf_counter()
        got = probs2str_arrays(iv, jv, pv, device=device)
        t1 = time.perf_counter()
        want = probs2str(zip(iv, jv, pv))
        seen["native_s"] += t1 - t0
        seen["plain_s"] += time.perf_counter() - t1
        if got != want:
            raise AssertionError("a CLI's native text differs from probs2str")
        seen["calls"] += 1
        seen["triples"] += len(pv)
        return got

    for m in modules:
        m.probs2str_arrays = checked
    try:
        yield seen
    finally:
        for m, fn in saved.items():
            m.probs2str_arrays = fn


def native_clis(mc_cli, du_cli, fasta):
    """cli.mccaskill -c and cli.durbin on the card on the tRNAs, each
    record's text through ``formatter_checked``: the native formatter's
    bytes are the plain version's on the CLIs' own triples."""
    with tempfile.TemporaryDirectory() as tmp, \
            formatter_checked((mc_cli, du_cli)) as seen:
        mc_cli.main(["-i", fasta, "-o", os.path.join(tmp, "m.txt"), "-c"])
        du_cli.main(["-i", fasta, "-o", os.path.join(tmp, "d.txt")])
    if not seen["calls"]:
        raise AssertionError("the CLIs formatted nothing")
    print(f"cli.mccaskill -c and cli.durbin on the card: {seen['calls']} "
          f"records, {seen['triples']} triples, the native text identical "
          f"to probs2str's; native {seen['native_s'] * 1e3:.3f} ms, plain "
          f"{seen['plain_s'] * 1e3:.3f} ms")
    return seen


@contextlib.contextmanager
def counted_plain_mea():
    """Count the calls of K23's plain version while the block runs: a
    one-item list."""
    from rna_algos_tpu_torch.ops import mea_fill as MF

    calls, orig = [0], MF.mea_fill_batch_plain

    def plain(*args):
        calls[0] += 1
        return orig(*args)

    MF.mea_fill_batch_plain = plain
    try:
        yield calls
    finally:
        MF.mea_fill_batch_plain = orig


KERNELS_P8 = ("contra_inside", "contra_outside", "turner_inside",
              "turner_outside")
# The eval phase: the committed seed set through eval.pipeline.run_all on
# the card, each column's best F1 at the floors of
# tests/test_eval_synth.py::test_committed_eval_artifact_sanity, best MCC
# above EVAL_MCC, and the per-gamma gaps to the committed JAX report printed
# (a gap above EVAL_GAP_NOTE is traced to its families in PERF.md).
EVAL_SEED_SET = "assets/synth_rfam_seed.sth"
EVAL_REPORT = "eval_artifacts/eval_report.json"
EVAL_F1_FLOORS = {"centroid_estimator_turner": 0.68,
                  "centroid_estimator_contra": 0.66,
                  "threshold_estimator_turner": 0.68,
                  "threshold_estimator_contra": 0.66}
EVAL_MCC = 0.3
EVAL_GAP_NOTE = 0.01
EVAL_METRICS = ("ppv", "sens", "f1", "mcc")
# The mesh phase: each engine over a mesh of one entry on the card (bitwise
# the engine without a mesh) and of two entries on the one card (bitwise
# where a sequence or pair settles on the same ln_sigma with the same launch
# shape, else within TOL_MAIN_VS_PLAIN).
MESHES = (("mesh1", ("cuda:0",)), ("mesh2", ("cuda:0", "cuda:0")))


@contextlib.contextmanager
def counted_plain_prob():
    """Count the calls of the probability wavefronts' plain versions (K1,
    K2, K4 and K5's) while the block runs: a one-item list."""
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8

    calls = [0]
    saved = {k: getattr(P8, k + "_plain") for k in KERNELS_P8}

    def counting(fn):
        def call(*args, **kw):
            calls[0] += 1
            return fn(*args, **kw)
        return call

    for k, fn in saved.items():
        setattr(P8, k + "_plain", counting(fn))
    try:
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(P8, k + "_plain", fn)


def strict_json(text):
    """Parse JSON that must hold no NaN or Infinity literal."""
    def refuse(name):
        raise AssertionError(f"eval report: non-strict JSON literal {name}")
    return json.loads(text, parse_constant=refuse)


def eval_phase(counted, counts, smi):
    """The accuracy-evaluation pipeline on the card: ``run_all`` on the
    committed seed set, both models, both programs, the 18 gammas; its
    fold and MEA fill counted (K1/K2, K4/K5 and K23 launched, their plain
    versions never called).  Fatal: 18 rows a column, strict JSON, the F1 floors, best
    MCC.  Printed: the largest per-gamma gap of PPV, sensitivity, F1 and
    MCC to the committed JAX report, the PhaseTimer split, the wall time.
    Returns the phase's record."""
    from rna_algos_tpu_torch.eval.pipeline import best, run_all

    with tempfile.TemporaryDirectory() as work, \
            counted_plain_prob() as n_plain, counted_plain_mea() as n_mea, \
            counted_plain_traceback() as n_tb:
        t0 = time.perf_counter()
        report = counted("eval", "eval", lambda: run_all(
            str(ROOT / EVAL_SEED_SET), work, device="cuda",
            numerics="exact"))
        wall = time.perf_counter() - t0
        saved = strict_json(
            (pathlib.Path(work) / "eval_report.json").read_text())
    if n_plain[0] or n_mea[0] or n_tb[0]:
        raise AssertionError(f"eval: the plain wavefronts ran {n_plain[0]} "
                             f"times, the plain MEA fill {n_mea[0]} times "
                             f"and the plain traceback {n_tb[0]} times on "
                             "the card")
    ref = strict_json((ROOT / EVAL_REPORT).read_text())
    rec = {"num_families": saved["num_families"], "wall_s": wall,
           "phases": saved["phases"], "columns": {}}
    for col, floor in EVAL_F1_FLOORS.items():
        rows, want = saved["curves"][col], ref["curves"][col]
        if len(rows) != 18:
            raise AssertionError(f"eval {col}: {len(rows)} rows, not 18")
        f1, mcc = best(rows, "f1"), best(rows, "mcc")
        def gap(k, m):
            a, b = rows[k][m], want[k][m]
            return 0.0 if a is None or b is None else abs(a - b)

        gaps = {m: max(gap(k, m) for k in range(18)) for m in EVAL_METRICS}
        g_at = max(range(18), key=lambda k: max(gap(k, m)
                                                for m in EVAL_METRICS))
        # a cell with no value (0 / 0) in one report only: at gamma = 1 the
        # MEA pairs only where a BPP exceeds 1 in float32 (a tie)
        undefined = [rows[k]["gamma"] for k in range(18) if any(
            (rows[k][m] is None) != (want[k][m] is None)
            for m in EVAL_METRICS)]
        worst = max(gaps.values())
        print(f"eval {col}: best F1 {f1:.4f} (floor {floor}), best MCC "
              f"{mcc:.4f}; gap to {EVAL_REPORT}: " + ", ".join(
                  f"{m} {gaps[m]:.4e}" for m in EVAL_METRICS)
              + f" (largest at gamma {rows[g_at]['gamma']:g})"
              + (f" > {EVAL_GAP_NOTE}" if worst > EVAL_GAP_NOTE else "")
              + f"; a metric undefined in one report only at gammas "
              f"{undefined}")
        if not (f1 >= floor and mcc > EVAL_MCC):
            raise AssertionError(f"eval {col}: best F1 {f1} or MCC {mcc} "
                                 "under the floor")
        rec["columns"][col] = {"best_f1": f1, "best_mcc": mcc,
                               "max_gap": gaps, "undefined_in_one": undefined,
                               "timing_s": saved["timings_s"][col]}
    for name, ph in saved["phases"].items():
        print(f"eval phase {name}: {ph['seconds']:.4f} s over {ph['calls']} "
              f"calls, {ph['items']} items")
    print(f"eval: {saved['num_families']} families, run_all "
          f"{saved['wall_s']:.3f} s inside, {wall:.3f} s around it; fold "
          f"launches {counts['eval']}; plain wavefront, MEA fill and "
          f"traceback calls 0; on {smi}")
    return rec


@contextlib.contextmanager
def retry_records():
    """Record each retry loop's (ns, settled ln_sigma), from whatever host
    thread runs it, while the block runs: a list of (tuple, tuple)."""
    from rna_algos_tpu_torch.ops import pallas_fold_prob as PP

    seen, orig = [], PP._retrying

    def retrying(run, ns, **kw):
        bppo, ls = orig(run, ns, **kw)
        seen.append((tuple(ns.cpu().tolist()), tuple(ls.cpu().tolist())))
        return bppo, ls

    PP._retrying = retrying
    try:
        yield seen
    finally:
        PP._retrying = orig


def settled(records, groups):
    """Each item's settled ln_sigma, where a retry record names it: groups
    is a list of (items, their ns tuple) as the engine hands them to one
    retry loop; an item whose ns tuple matches records that disagree, or
    none, maps to None."""
    by_ns = {}
    for ns, ls in records:
        by_ns.setdefault(ns, set()).add(ls)
    out = {}
    for items, ns in groups:
        found = by_ns.get(ns, set())
        ls = next(iter(found)) if len(found) == 1 else None
        for k, item in enumerate(items):
            out[item] = None if ls is None else ls[k]
    return out


def fold_groups(engine, seqs, entries):
    """(sequence indices, their lengths) of each retry loop a fold over
    ``entries`` shards runs: the engine's buckets in sorted order, each
    split into contiguous shards; and each shard's launch shape (N, B)."""
    from rna_algos_tpu_torch.parallel.mesh import shard_bounds
    from rna_algos_tpu_torch.parallel.runner import kernel_bucket

    order = sorted(range(len(seqs)), key=lambda k: len(seqs[k]))
    buckets = {}
    for k in order:
        buckets.setdefault(kernel_bucket(len(seqs[k]), engine.contra,
                                         engine.numerics), []).append(k)
    groups, shapes = [], {}
    for N, idxs in buckets.items():
        for lo, hi in shard_bounds(len(idxs), entries):
            part = idxs[lo:hi]
            if part:
                groups.append((part, tuple(len(seqs[k]) for k in part)))
                for k in part:
                    shapes[k] = (N, len(part))
    return groups, shapes


def launch_shape(model, N, B):
    """The launch parameters that set a fold's summation order at (N, B):
    K1/K2's or K4/K5's threads a sequence, or the long kernels' cluster
    sizes."""
    from rna_algos_tpu_torch.ops import pallas_fold_long as PL
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8

    if N <= P8.MAX_N:
        return getattr(P8, f"{model}_block_threads")(B, N)
    return getattr(PL, f"{model}_cluster_sizes")(B, N)


def mesh_compare(label, items, want, got, ls_w, ls_g, shape_same, diff):
    """Bitwise where an item settled on the same ln_sigma with the same
    launch shape, else within TOL_MAIN_VS_PLAIN; the counts printed."""
    n_bitwise, n_ls, n_shape, worst, bad = 0, 0, 0, 0.0, []
    for item in items:
        w, g = want[item], got[item]
        same_ls = ls_w.get(item) is not None and ls_w.get(item) == ls_g.get(
            item)
        n_ls += not same_ls
        n_shape += same_ls and not shape_same(item)
        if same_ls and shape_same(item):
            n_bitwise += 1
            if not all(a.tobytes() == b.tobytes() for a, b in zip(w, g)):
                bad.append(item)
        else:
            worst = max(worst, diff(w, g))
    print(f"  {label}: {n_bitwise} of {len(items)} bitwise (same ln_sigma, "
          f"same launch shape), {len(bad)} of them not; {n_ls} settled on "
          f"another ln_sigma, {n_shape} on the same one under another launch "
          f"shape: max |d| {worst:.3e} over those")
    if bad or not worst <= TOL_MAIN_VS_PLAIN:
        raise AssertionError(f"{label}: the mesh run disagrees with the "
                             f"engine (items {bad[:5]}, max |d| {worst})")
    return {"bitwise": n_bitwise, "settled_differently": n_ls,
            "other_launch_shape": n_shape, "max_abs_diff": worst}


def mesh_times(label, calls, reps=3):
    """Host-clock seconds of each engine's call (it ends in the copy to the
    host), ``reps`` a call after the comparison runs, in turns: the
    engine without a mesh first and last."""
    names = list(calls)
    order = names + names[::-1]
    spent = dict.fromkeys(names, 0.0)
    for name in order:
        t0 = time.perf_counter()
        for _ in range(reps):
            calls[name]()
        spent[name] += time.perf_counter() - t0
    out = {n: spent[n] / (2 * reps) for n in names}
    print(f"  {label} seconds a call: " + ", ".join(
        f"{n} {v:.6f}" for n, v in out.items()))
    return out


def mesh_phase(trnas, dsets, rsets, counted, counts, smi):
    """Both engines over a mesh of one card and of two shards on the one
    card, against the same engines without a mesh: CONTRA on the tRNA tile
    (K1/K2) and 32 sequences of 300-500 nt (bucket 512, K8/K9), Turner on
    the tRNA tile (K4/K5), AlignEngine on the 630 tRNA pairs (K14) and on
    the mixed set (K14 + K22).  Each mesh run is counted.  Returns the
    phase's record."""
    from rna_algos_tpu_torch.ops import pallas_align as PA
    from rna_algos_tpu_torch.parallel.mesh import data_mesh, shard_bounds
    from rna_algos_tpu_torch.parallel.runner import (AlignEngine, FoldEngine,
                                                     align_bucket)

    rec = {}
    fold_sets = (("contra", "trna_N128_B192", trnas * 32),
                 ("contra_long", "N512_B32",
                  random_batch(*LONG_BATCHES[512], seed=512)),
                 ("turner", "trna_N128_B192", trnas * 32))
    for path, key, seqs in fold_sets:
        model = path.split("_")[0]
        base = FoldEngine(uses_contra_model=model == "contra", device="cuda")
        with retry_records() as records:
            want = base.fold_batch(seqs)
        groups, shapes_w = fold_groups(base, seqs, 1)
        ls_w = settled(records, groups)
        engines = {"no_mesh": base}
        for name, devs in MESHES:
            engine = FoldEngine(uses_contra_model=model == "contra",
                                mesh=data_mesh(list(devs)))
            label = f"{name}_{path}_{key}"
            with retry_records() as records:
                got = counted(label, path, lambda: engine.fold_batch(seqs))
            groups, shapes_g = fold_groups(engine, seqs, len(devs))
            ls_g = settled(records, groups)
            print(f"mesh {label}: {len(devs)} entries {devs}, launches "
                  f"{counts[label]}")

            def shape_same(k):
                return (launch_shape(model, *shapes_w[k])
                        == launch_shape(model, *shapes_g[k]))

            rec[label] = mesh_compare(
                label, range(len(seqs)), dict(enumerate(want)),
                dict(enumerate(got)), ls_w, ls_g,
                shape_same if len(devs) > 1 else (lambda k: True),
                lambda w, g: float(np.abs(w[0] - g[0]).max()))
            engines[name] = engine
        rec[f"{path}_{key}_seconds"] = mesh_times(f"{path}_{key}", {
            n: (lambda e=e: e.fold_batch(seqs)) for n, e in engines.items()})
    align_sets = (("durbin_exact", "trna_N128_P630", dsets["trna_N128_P630"]),
                  ("durbin_mixed", "mixed_P66", rsets["mixed_P66"]))
    base = AlignEngine(device="cuda")
    for path, key, (seqs, pairs) in align_sets:
        def align_groups(entries):
            """The retry loops' groups (K14's buckets, split into shards),
            and the pairs of the row scan K22, which has no retry loop
            (log space): those map to one common mark."""
            by_bucket = {}
            for a, b in pairs:
                by_bucket.setdefault(align_bucket(len(seqs[a]),
                                                  len(seqs[b])), []).append(
                    (a, b))
            groups, log_space = [], {}
            for (N1, N2), plist in by_bucket.items():
                if not PA.pallas_available(N1, N2):
                    log_space.update(dict.fromkeys(plist, "log space"))
                    continue
                for lo, hi in shard_bounds(len(plist), entries):
                    part = plist[lo:hi]
                    if part:
                        groups.append((part, tuple(len(seqs[a])
                                                   for a, _ in part)))
            return groups, log_space

        with retry_records() as records:
            want = base.match_probs_pairs(seqs, pairs)
        groups, log_space = align_groups(1)
        ls_w = {**settled(records, groups), **log_space}
        engines = {"no_mesh": base}
        for name, devs in MESHES:
            engine = AlignEngine(mesh=data_mesh(list(devs)))
            label = f"{name}_{path}_{key}"
            with retry_records() as records:
                got = counted(label, path,
                              lambda: engine.match_probs_pairs(seqs, pairs))
            if list(got) != list(want):
                raise AssertionError(f"{label}: other keys than the engine's")
            groups, log_space = align_groups(len(devs))
            ls_g = {**settled(records, groups), **log_space}
            print(f"mesh {label}: {len(devs)} entries {devs}, launches "
                  f"{counts[label]}")
            rec[label] = mesh_compare(
                label, pairs, {k: (v,) for k, v in want.items()},
                {k: (v,) for k, v in got.items()}, ls_w, ls_g,
                lambda k: True,
                lambda w, g: float(np.abs(w[0] - g[0]).max()))
            engines[name] = engine
        rec[f"{path}_{key}_seconds"] = mesh_times(f"{path}_{key}", {
            n: (lambda e=e: e.match_probs_pairs(seqs, pairs))
            for n, e in engines.items()})
    print(f"mesh: one H100 shows no NCCL and no speed-up across cards; "
          f"on {smi}")
    return rec


KERNELS_LONG = ("contra_inside_long", "contra_outside_long",
                "turner_inside_long", "turner_outside_long")
# kernel -> (its source, the TPU kernel it replaces)
REPLACES = {
    "skew": ("rna_algos_tpu_torch/csrc/skew.cu",
             "rna_algos_tpu/ops/pallas_skew.py:36"),
    "contra_inside": ("rna_algos_tpu_torch/csrc/contra_inside.cu",
                      "rna_algos_tpu/ops/pallas_fold_prob8.py:562"),
    "contra_outside": ("rna_algos_tpu_torch/csrc/contra_outside.cu",
                       "rna_algos_tpu/ops/pallas_fold_prob8.py:1054"),
    "turner_inside": ("rna_algos_tpu_torch/csrc/turner_inside.cu",
                      "rna_algos_tpu/ops/pallas_fold_prob8.py:2016"),
    "turner_outside": ("rna_algos_tpu_torch/csrc/turner_outside.cu",
                       "rna_algos_tpu/ops/pallas_fold_prob8.py:2537"),
    # the long tier: the same sources, launched at N = 512-2048
    "contra_inside_long": ("rna_algos_tpu_torch/csrc/contra_inside.cu",
                           "rna_algos_tpu/ops/pallas_fold_prob.py:706"),
    "contra_outside_long": ("rna_algos_tpu_torch/csrc/contra_outside.cu",
                            "rna_algos_tpu/ops/pallas_fold_prob.py:841"),
    "turner_inside_long": ("rna_algos_tpu_torch/csrc/turner_inside.cu",
                           "rna_algos_tpu/ops/pallas_fold_prob.py:1832"),
    "turner_outside_long": ("rna_algos_tpu_torch/csrc/turner_outside.cu",
                            "rna_algos_tpu/ops/pallas_fold_prob.py:1985"),
    # the Durbin pair-HMM: one source, two semirings
    "pairhmm_prob": ("rna_algos_tpu_torch/csrc/pairhmm.cu",
                     "rna_algos_tpu/ops/pallas_align_prob.py:52"),
    "pairhmm_log": ("rna_algos_tpu_torch/csrc/pairhmm.cu",
                    "rna_algos_tpu/ops/pallas_align.py:66"),
    # K15's fast instance: the JAX kernel traced under "fast"
    "pairhmm_log_fast": ("rna_algos_tpu_torch/csrc/pairhmm.cu",
                         "rna_algos_tpu/ops/pallas_align.py:66"),
    # the Durbin row scan: no TPU kernel, the JAX package's XLA row scan
    "pairhmm_rows": ("rna_algos_tpu_torch/csrc/pairhmm_rows.cu",
                     "rna_algos_tpu/models/durbin.py:52"),
    # the parity tier's log-space fold kernels
    "contra_inside_log": ("rna_algos_tpu_torch/csrc/contra_inside_log.cu",
                          "rna_algos_tpu/ops/pallas_fold.py:167"),
    "contra_outside_log": ("rna_algos_tpu_torch/csrc/contra_outside_log.cu",
                           "rna_algos_tpu/ops/pallas_fold.py:309"),
    "turner_inside_log": ("rna_algos_tpu_torch/csrc/turner_inside_log.cu",
                          "rna_algos_tpu/ops/pallas_fold.py:931"),
    "turner_outside_log": ("rna_algos_tpu_torch/csrc/turner_outside_log.cu",
                           "rna_algos_tpu/ops/pallas_fold.py:1028"),
    # the generic-N scan: no TPU kernel, the JAX package's XLA scan steps
    "scan_inside": ("rna_algos_tpu_torch/csrc/fold_scan.cu",
                    "rna_algos_tpu/models/mccaskill.py:72"),
    "scan_outside": ("rna_algos_tpu_torch/csrc/fold_scan.cu",
                     "rna_algos_tpu/models/mccaskill.py:179"),
    # the gamma-centroid MEA fill: no TPU kernel, the JAX package's XLA loop
    "mea_fill": ("rna_algos_tpu_torch/csrc/mea_fill.cu",
                 "rna_algos_tpu/models/centroid.py:58"),
}
LABELS = {"contra_inside": "K1", "contra_outside": "K2",
          "turner_inside": "K4", "turner_outside": "K5",
          "contra_inside_long": "K8", "contra_outside_long": "K9",
          "turner_inside_long": "K12", "turner_outside_long": "K13",
          "pairhmm_prob": "K14", "pairhmm_log": "K15",
          "pairhmm_log_fast": "K15 fast", "pairhmm_rows": "K22",
          "contra_inside_log": "K16", "contra_outside_log": "K17",
          "turner_inside_log": "K18", "turner_outside_log": "K19",
          "scan_inside": "K20", "scan_outside": "K21", "mea_fill": "K23"}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rna_algos_tpu_torch import _native
    from rna_algos_tpu_torch.ops import _build
    from rna_algos_tpu_torch.ops import pallas_align as PA
    from rna_algos_tpu_torch.ops import pallas_align_prob as PAP
    from rna_algos_tpu_torch.ops import fold_scan as FS
    from rna_algos_tpu_torch.ops import mea_fill as MF
    from rna_algos_tpu_torch.ops import pairhmm_rows as PR
    from rna_algos_tpu_torch.ops import pallas_fold as PF
    from rna_algos_tpu_torch.ops import pallas_fold_long as PL
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8
    from rna_algos_tpu_torch.ops import pallas_skew as K3
    from rna_algos_tpu_torch.parallel.runner import AlignEngine, FoldEngine
    from rna_algos_tpu_torch.cli import centroid_fold as cf_cli
    from rna_algos_tpu_torch.cli import durbin as du_cli
    from rna_algos_tpu_torch.cli import mccaskill as mc_cli
    from rna_algos_tpu_torch.cli.centroid_fold import read_fasta

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {name}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    laps = [time.perf_counter()]

    def lap(phase):
        """Print the seconds since the last phase ended."""
        laps.append(time.perf_counter())
        print(f"phase {phase}: {laps[-1] - laps[-2]:.1f} s")

    # phase 1: build
    lib = _build.library()
    print(f"build: {lib.build_seconds:.1f} s -> {lib.path.name}")
    for line in lib.compiler_output.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    lap("build")
    # phase 2: kernels vs plain
    err = {k: 0.0 for k in REPLACES}
    rel = {k: 0.0 for k in REPLACES
           if k.endswith(("inside", "inside_long")) and not k.startswith("scan")}

    def check_model(x):
        ik, ok = x["kernels"]
        err["skew"] = max(err["skew"], check_skew(x))
        a, r = check_inside(x, LABELS[ik], ik)
        err[ik] = max(err[ik], a)
        rel[ik] = max(rel[ik], r)
        err[ok] = max(err[ok], check_outside(x, LABELS[ok], ok))

    threads = {}    # K1/K2, K4/K5 -> shape -> threads a sequence
    builders = {"contra": kernel_inputs, "turner": turner_inputs}
    seeds = {"contra": 0, "turner": 1}
    for N, B in SHAPES_CHECK:
        for model, build in builders.items():
            print(f"check {model} N={N} B={B}, "
                  f"{block_threads(model, N, B, threads)}")
            x = build(N, B, seed=N + B + seeds[model], device=dev)
            check_model(x)
            for which in (0, 1):
                check_prob_dead_cells(x, which)
    for N, lengths in PROB_EDGE.items():
        B = len(lengths)
        for model, build in builders.items():
            print(f"check {model} edge N={N} n={lengths}, "
                  f"{block_threads(model, N, B, threads)}")
            x = build(N, B, seed=3 * N + seeds[model], device=dev,
                      lengths=lengths)
            check_model(x)
            for which in (0, 1):
                check_prob_dead_cells(x, which)
    clusters = {}   # K8/K9/K12/K13 -> shape -> blocks per sequence
    for model, shapes in LONG_CHECK.items():
        for N, B in shapes:
            print(f"check {model} N={N} B={B}, "
                  f"{cluster_sizes(model, N, B, clusters)}")
            check_model(builders[model](N, B, seed=N + B, device=dev))
    trnas = [r.seq for r in read_fasta(ROOT / "assets" / "sampled_trnas.fa")]
    dsets = durbin_sets(trnas)
    dinputs = durbin_checks(dsets, dev, err)

    # kernel -> shape -> (ms, plain ms, bound ms, bound by, library ms)
    times = {k: {} for k in REPLACES}
    times["skew18"] = {}

    def timed(kernel, x, args, reps, preps, key=None):
        kern, plain = wrappers(kernel)
        B, N = x["seqs"].shape
        ms = cuda_ms(lambda: kern(*args), reps)
        pms = cuda_ms(lambda: plain(*args), preps)
        bms, by = bound(kernel, x)
        times[key or kernel][f"N{N}_B{B}"] = (ms, pms, bms, by, None)
        note = ""
        if kernel.endswith("_long"):
            note = (f", HBM re-read floor {reread_ms(kernel, x):.4f} ms, "
                    f"{cluster_sizes(kernel.split('_')[0], N, B, clusters)}")
        elif kernel in threads:
            note = f", {block_threads(kernel.split('_')[0], N, B, threads)}"
        print(f"time N={N} B={B} {kernel}: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms ({by}){note}")

    for N, B in SHAPES_MAIN:
        inp = kernel_inputs(N, B, seed=7 * N, device=dev)
        tinp = turner_inputs(N, B, seed=7 * N + 1, device=dev)
        for key, x in (("skew", inp), ("skew18", tinp)):
            tables = ([x["mi"][k] for k in sorted(x["mi"])] if key == "skew"
                      else x["pq"])    # the 9 CONTRA tables; the Turner 18
            ms = cuda_ms(lambda: K3.skew_pq_batch(tables), 20)
            pms = cuda_ms(lambda: K3.skew_pq_batch_plain(tables), 20)
            lms = cuda_ms(skew_library_call(tables), 20)
            bms, by = bound("skew", dict(x, pq=tables))
            times[key][f"N{N}_B{B}"] = (ms, pms, bms, by, lms)
            print(f"time N={N} B={B} {key}: kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms, torch.gather {lms:.4f} ms, bound "
                  f"{bms:.4f} ms ({by})")
        for x in (inp, tinp):
            timed(x["kernels"][0], x, x["inside_args"], 5, 2)
            timed(x["kernels"][1], x, x["outside_args"], 5, 2)
    for model, shapes in LONG_MAIN.items():
        for N, B in shapes:
            x = builders[model](N, B, seed=7 * N, device=dev)
            timed(x["kernels"][0], x, x["inside_args"], LONG_REPS, 1)
            timed(x["kernels"][1], x, x["outside_args"], LONG_REPS, 1)
    durbin_times(dinputs, times)
    k15_args = dinputs["trna_N128_P630"]["seq_args"]
    del dinputs
    rsets = rows_sets(trnas)
    fast_err = {}
    rows_checks(rsets, fast_err, times, dev)
    log_checks(dev, err, rel, times, smi)
    scan_checks(dev, err, fast_err, times, smi)
    mea_checks(dev, err, times, smi)
    lap("kernels")
    native_stats = native_phase(dev, smi)

    lap("native")
    # phase 3: the main paths, each counted on its own
    batches = {
        "trna_N128_B192": trnas * 32,
        "rfam_N256_B96": random_batch(96, 150, 200, seed=2024),
    }
    engines = {
        "contra": FoldEngine(uses_contra_model=True, device="cuda"),
        "turner": FoldEngine(uses_contra_model=False, device="cuda"),
    }
    counters = (K3.launches, P8.inside_launches, P8.outside_launches,
                P8.turner_inside_launches, P8.turner_outside_launches,
                PL.contra_inside_long_launches,
                PL.contra_outside_long_launches,
                PL.turner_inside_long_launches,
                PL.turner_outside_long_launches,
                PAP.prob_launches, PA.log_launches, PA.log_fast_launches,
                PR.launches,
                PF.contra_inside_log_launches, PF.contra_outside_log_launches,
                PF.turner_inside_log_launches, PF.turner_outside_log_launches,
                FS.inside_launches, FS.outside_launches, MF.launches,
                _native.traceback_calls)
    path_kernels = {
        "contra": ("skew", "contra_inside", "contra_outside"),
        "turner": ("skew", "turner_inside", "turner_outside"),
        "contra_long": ("skew", "contra_inside_long", "contra_outside_long"),
        "turner_long": ("skew", "turner_inside_long", "turner_outside_long"),
        "durbin_exact": ("pairhmm_prob",),
        "durbin_parity": ("pairhmm_log",),
        "durbin_log_fast": ("pairhmm_log_fast",),
        "durbin_rows_exact": ("pairhmm_rows",),
        "durbin_rows_parity": ("pairhmm_rows",),
        "durbin_mixed": ("pairhmm_prob", "pairhmm_rows"),
        "contra_parity": ("skew", "contra_inside_log", "contra_outside_log"),
        "turner_parity": ("skew", "turner_inside_log", "turner_outside_log"),
        "turner_scan": ("skew", "scan_inside", "scan_outside"),
        "contra_scan": ("skew", "scan_inside", "scan_outside"),
        "contra_parity_scan": ("skew", "scan_inside", "scan_outside"),
        "turner_parity_scan": ("skew", "scan_inside", "scan_outside"),
        "turner_scan_long": ("skew", "scan_inside", "scan_outside"),
        "eval": ("skew", "contra_inside", "contra_outside", "turner_inside",
                 "turner_outside", "mea_fill", "native_traceback"),
        "centroid_contra": ("skew", "contra_inside", "contra_outside",
                            "mea_fill", "native_traceback"),
        "centroid_turner": ("skew", "turner_inside", "turner_outside",
                            "mea_fill", "native_traceback"),
    }
    results, counts = {}, {}

    def counted(label, path, fn):
        """Run fn with every launch count set to 0 just before it; the
        counts are read just after, and each kernel of ``path`` must have
        launched."""
        for c in counters:
            c.reset()
        out = fn()
        torch.cuda.synchronize()
        counts[label] = {c.name: c.count for c in counters}
        print(f"main path {label} launches: {counts[label]}")
        if min(counts[label][k] for k in path_kernels[path]) < 1:
            raise AssertionError(
                f"a kernel of the {path} path never launched: {counts[label]}")
        return out

    for model, engine in engines.items():
        results[model] = counted(
            model, model,
            lambda: {k: engine.fold_batch(v) for k, v in batches.items()})
    gold = np.load(ROOT / "tests" / "golden" / "trna_bpps.npz")
    for model, engine in engines.items():
        with plain_kernels():
            plain = {k: engine.fold_batch(v) for k, v in batches.items()}
        for key in batches:
            got = results[model][key]
            worst = max(float(np.abs(a[0] - b[0]).max())
                        for a, b in zip(got, plain[key]))
            shapes_ok = all(
                a[0].shape == (len(s), len(s)) and np.isfinite(a[0]).all()
                for a, s in zip(got, batches[key]))
            print(f"{model} {key}: kernel vs plain path max |dBPP| {worst:.3e}")
            if not worst <= TOL_MAIN_VS_PLAIN or not shapes_ok:
                raise AssertionError(
                    f"{model} {key}: main path disagrees with plain path")
        worst = max(float(np.abs(results[model]["trna_N128_B192"][k][0]
                                 - gold[f"rec{k}_{model}"]).max())
                    for k in range(len(trnas)))
        print(f"{model} tRNA vs trna_bpps.npz: max |dBPP| {worst:.3e}")
        if not worst <= TOL_GOLDEN:
            raise AssertionError(
                f"{model} tRNA BPPs outside the 5e-4 golden budget")
    tie_file, tie_rec, (tp, tq) = TURNER_TIE
    tie_bpp = float(results["turner"]["trna_N128_B192"][tie_rec][0][tp, tq])
    print(f"turner record {tie_rec} BPP at {(tp, tq)}: {tie_bpp!r} "
          f"(golden {float(gold[f'rec{tie_rec}_turner'][tp, tq])!r})")

    # the long main paths: each bucket's batch counted, timed (host clock
    # around a call that ends in a device sync) and held against the plain
    # path on the card
    long_batches = {N: random_batch(*LONG_BATCHES[N], seed=N)
                    for N in LONG_BATCHES}
    long_stats = {}
    for model, engine in engines.items():
        path = f"{model}_long"
        ik = path_kernels[path][1]
        for N, _ in LONG_MAIN[model]:
            seqs = long_batches[N]
            key = f"{path}_N{N}_B{len(seqs)}"
            torch.cuda.reset_peak_memory_stats()
            with recorded_ln_sigma() as ls_k:
                t0 = time.perf_counter()
                got = counted(key, path, lambda: engine.fold_batch(seqs))
                wall = time.perf_counter() - t0
            counts.setdefault(path, {k: 0 for k in counts[key]})
            for k, v in counts[key].items():
                counts[path][k] += v
            peak = torch.cuda.max_memory_allocated() / 2**30
            runs = counts[key][ik]
            retries = runs - 1 - (N > 512)
            # the run's shape, and past 512 the prefix seed's (N / 2)
            shapes = [(N, len(seqs))] + ([(N // 2, len(seqs))]
                                         if N > 512 else [])
            print(f"  {key}: " + "; ".join(
                f"N={n_} B={b_} {cluster_sizes(model, n_, b_, clusters)}"
                for n_, b_ in shapes))
            t0 = time.perf_counter()
            with plain_kernels(), recorded_ln_sigma() as ls_p:
                plain = engine.fold_batch(seqs)
            pwall = time.perf_counter() - t0
            order = sorted(range(len(seqs)), key=lambda k: len(seqs[k]))
            worst_same, n_diff = 0.0, 0
            for row, k in enumerate(order):
                if not (got[k][0].shape == (len(seqs[k]),) * 2
                        and np.isfinite(got[k][0]).all()):
                    raise AssertionError(f"{key}: bad BPP for sequence {k}")
                d = float(np.abs(got[k][0] - plain[k][0]).max())
                lk, lp = float(ls_k[-1][row]), float(ls_p[-1][row])
                if lk == lp:
                    worst_same = max(worst_same, d)
                else:
                    n_diff += 1
                    print(f"  {key} sequence {k} (n={len(seqs[k])}): "
                          f"ln_sigma kernel {lk!r} plain {lp!r}, "
                          f"max |dBPP| {d:.3e}")
            n_same = len(seqs) - n_diff
            print(f"{key}: kernel vs plain path max |dBPP| {worst_same:.3e} "
                  f"on {n_same} of {len(seqs)} sequences at equal ln_sigma; "
                  f"{len(seqs) / wall:.4f} seqs/s ({wall:.3f} s/batch), "
                  f"plain path {len(seqs) / pwall:.4f} seqs/s; {runs} runs "
                  f"of {ik} ({retries} retries); peak memory {peak:.3f} GiB "
                  f"on {smi}")
            if not worst_same <= TOL_MAIN_VS_PLAIN:
                raise AssertionError(f"{key}: main path disagrees with plain")
            if n_same < MIN_SAME_LS_SHARE * len(seqs):
                raise AssertionError(
                    f"{key}: only {n_same} of {len(seqs)} sequences settled "
                    "on the plain path's ln_sigma")
            long_stats[key] = (len(seqs) / wall, retries, peak)

    aligners = {m: AlignEngine(device="cuda", numerics=m)
                for m in ("exact", "parity")}
    durbin_stats = durbin_paths(dsets, aligners, counted, counts,
                                path_kernels, smi)
    durbin_stats["log_fast_vs_plain"] = k15_fast_path(k15_args, counted,
                                                      counts, smi)
    rows_stats = rows_paths(rsets, aligners, counted, counts, path_kernels,
                            smi)
    parity_engines = {
        model: FoldEngine(uses_contra_model=model == "contra", device="cuda",
                          numerics="parity")
        for model in ("contra", "turner")}
    parity_stats, _ = parity_paths(parity_engines, batches, counted, counts,
                                   path_kernels, smi)
    scan_stats = scan_paths(counted, counts, path_kernels, smi)
    scan_stats.update(scan_long(counted, counts, smi))

    # the float64 goldens of the long-n anchors
    gdir = ROOT / "tests" / "golden"
    g = dict(np.load(gdir / "longn_f64.npz"))
    g.update(np.load(gdir / "longn_f64_1536.npz"))
    for model, engine in engines.items():
        for n, tol in ((245, TOL_GOLDEN_245), (768, TOL_GOLDEN),
                       (1536, TOL_GOLDEN)):
            seq = [int(b) for b in g[f"seq_{n}"]]
            if model == "turner" and n == 1536:
                tol = TOL_GOLDEN_SCAN   # the generic scan (K20/K21)
            bpp = engine.fold_batch([seq])[0][0]
            worst = float(np.abs(bpp - g[f"bpp_{n}_{model}"]).max())
            print(f"{model} n={n} vs float64 golden: max |dBPP| {worst:.3e} "
                  f"(budget {tol:g})")
            if not worst <= tol:  # NaN fails too
                raise AssertionError(f"{model} n={n} outside the golden budget")

    lap("main paths")
    # phase 4: the centroid CLI, both models
    golden = ROOT / "tests" / "golden" / "c_baseline"
    fasta = str(ROOT / "assets" / "sampled_trnas.fa")
    with tempfile.TemporaryDirectory() as tmp, \
            counted_plain_mea() as n_mea, counted_plain_traceback() as n_tb:
        counted("centroid_contra", "centroid_contra",
                lambda: cf_cli.main(["-i", fasta, "-o", tmp, "-c"]))
        ref_dir = golden / "centroid_contra"
        names = sorted(os.listdir(ref_dir))
        if names != sorted(os.listdir(tmp)):
            raise AssertionError("centroid CLI wrote other files")
        for nm in names:
            if (ref_dir / nm).read_bytes() != (pathlib.Path(tmp) / nm).read_bytes():
                raise AssertionError(f"centroid CLI output differs: {nm}")
    print(f"centroid CLI -c: {len(names)} files byte-identical")
    with tempfile.TemporaryDirectory() as tmp, \
            counted_plain_mea() as n_mea_t, \
            counted_plain_traceback() as n_tb_t:
        counted("centroid_turner", "centroid_turner",
                lambda: cf_cli.main(["-i", fasta, "-o", tmp]))
        verdict = turner_centroid_verdict(golden / "centroid_turner", tmp)
    print(f"centroid CLI Turner: {len(names)} files, verdict {verdict} "
          f"({tie_file} record {tie_rec})")
    if n_mea[0] or n_mea_t[0]:
        raise AssertionError("centroid CLI: the plain MEA fill ran on the "
                             "card")
    if n_tb[0] or n_tb_t[0]:
        raise AssertionError("centroid CLI: the plain traceback ran on the "
                             "card")
    native_stats["plain_traceback_calls"] = {
        "centroid_contra": n_tb[0], "centroid_turner": n_tb_t[0]}

    # cli.mccaskill -c on the tRNAs mixed with a 400-nt and a 900-nt record
    longs = (random_batch(1, 400, 400, seed=400)
             + random_batch(1, 900, 900, seed=900))
    mixed = [trnas[0], longs[0], *trnas[1:4], longs[1], *trnas[4:]]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        text = "".join(f">r{k}\n" + "".join("ACGU"[b] for b in s) + "\n"
                       for k, s in enumerate(mixed))
        (tmp / "mixed.fa").write_text(text)
        mc_cli.main(["-i", str(tmp / "mixed.fa"), "-o", str(tmp / "m.txt"),
                     "-c"])
        mc_cli.main(["-i", fasta, "-o", str(tmp / "t.txt"), "-c"])
        blocks = (tmp / "m.txt").read_text().split("\n\n>")[1:]
        ref = (tmp / "t.txt").read_text().split("\n\n>")[1:]
    if [b.split("\n", 1)[0] for b in blocks] != [str(k) for k in range(8)]:
        raise AssertionError("mixed FASTA: records out of order")
    bodies = [b.split("\n", 1)[1] for b in blocks]
    short = [bodies[k] for k in (0, 2, 3, 4, 6, 7)]
    if short != [b.split("\n", 1)[1] for b in ref]:
        raise AssertionError("mixed FASTA: tRNA records differ from a "
                             "tRNA-only run")
    for k, lo, s in ((1, max(map(len, trnas)), longs[0]),
                     (5, len(longs[0]), longs[1])):
        top = max(int(t.split(",")[1]) for t in bodies[k].split())
        if not lo < top < len(s):
            raise AssertionError(f"mixed FASTA: record {k} is not the "
                                 f"{len(s)}-nt one")
    print("cli.mccaskill -c, mixed FASTA: 8 records in order, the 6 tRNA "
          "records byte-identical to the tRNA-only run")

    durbin_clis(du_cli, fasta, golden)
    native_stats["clis"] = native_clis(mc_cli, du_cli, fasta)
    rows_cli(du_cli, rsets)
    scan_stats["cli_parity_400_worst"] = scan_cli(mc_cli, cf_cli)
    verdict, tie_bpp = parity_clis(mc_cli, cf_cli, fasta, golden)
    parity_stats["turner_centroid_verdict"] = verdict
    parity_stats["turner_tie_bpp"] = tie_bpp

    lap("CLIs")
    # phase 5: main-path throughput, kernel path and plain path
    for model, engine in engines.items():
        for key, seqs in batches.items():
            for label, ctx in (("kernel", contextlib.nullcontext),
                               ("plain", plain_kernels)):
                with ctx():
                    ms = cuda_ms(lambda: engine.fold_batch(seqs),
                                 3 if label == "kernel" else 1)
                print(f"throughput {model} {key} {label}: "
                      f"{len(seqs) / (ms / 1e3):.2f} seqs/s ({ms:.2f} ms/batch) "
                      f"on {smi}")

    durbin_throughput(dsets, aligners, durbin_stats, smi)
    rows_throughput(rsets, aligners, rows_stats, smi)

    lap("throughput")
    # phase 6: the eval pipeline on the card
    eval_stats = eval_phase(counted, counts, smi)
    native_stats["plain_traceback_calls"]["eval"] = 0
    lap("eval")
    # phase 7: both engines over a data mesh on the card
    mesh_stats = mesh_phase(trnas, dsets, rsets, counted, counts, smi)
    lap("mesh")

    kernels = []
    for k, (src, rep) in REPLACES.items():
        by_shape = times[k]
        head = ("N1024_B16" if k.endswith("_long") else
                next(iter(by_shape)) if k in ("pairhmm_rows", "mea_fill") else
                "N128_P630" if k.startswith("pairhmm") else
                "N1536_B2_turner" if k.startswith("scan") else "N128_B192")
        paths = [m for m, ks in path_kernels.items() if k in ks]
        ms, pms, bms, by, lms = by_shape[head]
        entry = {
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(counts[m][k] for m in paths),
            "max_abs_err": err[k],
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": lms,
            "shape": head,
            "ms_by_shape": {s: v[0] for s, v in by_shape.items()},
            "plain_ms_by_shape": {s: v[1] for s, v in by_shape.items()},
            "bound_ms_by_shape": {s: v[2] for s, v in by_shape.items()},
            "launches_by_path": {m: counts[m][k] for m in paths},
        }
        if k in rel:
            entry["max_rel_err"] = rel[k]
        if k in fast_err:
            entry["max_abs_err_fast"] = fast_err[k]
        if k in clusters:
            entry["cluster_by_shape"] = clusters[k]
        if k in threads:
            entry["threads_by_shape"] = threads[k]
        if k == "skew":
            entry["library_ms_by_shape"] = {s: v[4]
                                            for s, v in by_shape.items()}
            entry["ms_by_shape_18_tables"] = {
                s: v[0] for s, v in times["skew18"].items()}
            entry["library_ms_by_shape_18_tables"] = {
                s: v[4] for s, v in times["skew18"].items()}
        kernels.append(entry)
    print(json.dumps({"long_paths": {
        k: {"seqs_per_s": v[0], "retries": v[1], "peak_gib": v[2]}
        for k, v in long_stats.items()}}))
    print(json.dumps({"durbin_paths": durbin_stats}))
    print(json.dumps({"rows_paths": rows_stats}))
    print(json.dumps({"parity_paths": parity_stats}))
    print(json.dumps({"scan_paths": scan_stats}))
    print(json.dumps({"eval": eval_stats}))
    print(json.dumps({"mesh": mesh_stats}))
    print(json.dumps({"native": native_stats}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    t_start = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    sys.exit(rc)
