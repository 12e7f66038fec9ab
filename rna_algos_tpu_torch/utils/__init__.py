"""FASTA input, dot-bracket and probability text output, BPP checkpoints:
the port's own copies of ``rna_algos_tpu.utils.io``, ``output`` and
``checkpoint``."""
