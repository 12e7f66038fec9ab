"""Position-separable table lookups (``rna_algos_tpu.ops.lut``).

The JAX package contracts one-hot matrices on the TPU's matrix unit; on the
CPU it gathers.  Here it is always a plain gather with int64 indices, which
is bitwise equal to the JAX CPU gather.
"""


def sep_lookup(table, i_parts, j_parts, perm=None):
    """M[..., p, q] = table[*i_parts[..., p], *j_parts[..., q]].

    ``i_parts``: tuple of (..., P) int64 tensors that depend on the row
    position only; ``j_parts``: tuple of (..., Q) tensors for the column.
    ``perm`` permutes ``table`` so its dims line up as [*i_dims, *j_dims]."""
    if perm is not None:
        table = table.permute(*perm)
    if table.dim() != len(i_parts) + len(j_parts):
        raise ValueError(
            f"table of rank {table.dim()} for {len(i_parts)}+{len(j_parts)} "
            "index parts"
        )
    idx = tuple(x.unsqueeze(-1) for x in i_parts) + tuple(
        x.unsqueeze(-2) for x in j_parts
    )
    return table[idx]
