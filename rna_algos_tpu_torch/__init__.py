"""rna_algos_tpu_torch: the PyTorch / CUDA port of rna_algos_tpu.

The centroid-fold main path, both models, held against the JAX package:

  FASTA -> parallel.runner.FoldEngine.fold_batch         (length buckets)
        -> models.mccaskill.mccaskill_bpp_batch_auto
        -> N <= 256: ops.pallas_fold_prob8.mccaskill_turner_prob
                     (kernels K4, K5, K3), or mccaskill_contra_prob with -c
                     (kernels K1, K2, K3)
           N = 512, 1024 (and 2048 for CONTRA):
                     ops.pallas_fold_long.mccaskill_turner_pallas_prob
                     (kernels K12, K13, K3), or mccaskill_contra_pallas_prob
                     with -c (kernels K8, K9, K3)
           any other bucket (and parity past 256): the generic-N scan,
                     models.mccaskill.mccaskill_bpp_batch (kernels K20,
                     K21 in ops.fold_scan, K3)
        -> models.mccaskill._prob_finish                 (kernel K3, inverse)
        -> models.centroid.centroid_structures: ops.mea_fill.mea_fill_batch
           (kernel K23, a bucket's records and gammas at once) + the
           traceback on the host (_native, C, on the card's path)
           -> dot-bracket files

and the Durbin pair-HMM:

  FASTA -> cli.durbin -> parallel.runner.AlignEngine.match_probs_pairs
        -> models.durbin.durbin_match_probs_batch_auto
        -> square buckets 64-256: ops.pallas_align_prob (kernel K14,
           exact and fast) or ops.pallas_align (kernel K15, parity)
           any other bucket (rectangular, or past 256): the row scan,
           models.durbin.durbin_match_probs_batch (kernel K22 in
           ops.pairhmm_rows, every mode) -> triples file

Module names mirror the JAX package so each counterpart is easy to find.
Every hand-written kernel (CUDA C++ under ``csrc/``) has a plain PyTorch
version beside its wrapper; the wrapper takes the plain version only for
tensors on the CPU and launches the kernel for CUDA tensors.  Kernels are
built with ``nvcc`` at first use (``ops/_build.py``), never on import.
The host runtime's C (``csrc/native_host.c``: the centroid traceback and
the probability text) is built with ``cc`` at first use (``_native.py``)
and runs on the card's paths; the CPU's run its plain Python versions.

This package imports ``torch`` and never ``jax`` nor anything of the JAX
package: it keeps its own copies of the framework-free modules it needs
(``constants``, ``params``, ``numerics``, ``utils.io``, ``utils.output``,
``utils.checkpoint``).
"""

__version__ = "0.1.0"
