"""The benchmark's own code: the cell's files, the traffic generator, the
closed loop, the trace reduction, the work counts and the comparison that
decides ``correct``.  It drives the program (``rna_algos_tpu_torch``) and
imports nothing else of the repository."""
