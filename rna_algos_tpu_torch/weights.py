"""CONTRAfold weights carried across: numpy FoldScoreSets -> torch tensors.

Counterpart of ``rna_algos_tpu.ops.scores.contra_table_pytree``.  JAX
silently downcasts float64 input to float32 (x64 off); torch keeps float64,
so the cast is explicit here.
"""

import numpy as np
import torch


def contra_tables(fss, device):
    """FoldScoreSets (dict of numpy arrays or scalars) -> dict of float32
    tensors on ``device``."""
    return {
        k: torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)
        for k, v in fss.items()
    }
