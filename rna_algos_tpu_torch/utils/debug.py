"""Debug configuration: NaN/+inf detection in the engines' outputs
(``rna_algos_tpu.utils.debug``).

The numeric hazard of the DP is NaN or +inf leaking into a state table (the
``lse_pair`` contract requires finite-or--inf operands,
``numerics/logsumexp.py``).  The JAX package turns on ``jax_debug_nans``;
torch has no such switch for forward passes
(``torch.autograd.set_detect_anomaly`` covers backward passes only), so here
the switch is a module flag:

* ``RNA_ALGOS_DEBUG=nans`` (read by ``maybe_enable_from_env``, which both
  engines call in ``__init__``) or ``enable_nan_checks()`` turns it on.
  While it is on, ``FoldEngine.fold_batch`` and
  ``AlignEngine.match_probs_pairs`` run ``check_finite_states`` on each
  batch's outputs and raise on the first NaN or +inf, with the output's
  name and index.  While it is off, no check and no sync is added.
* ``check_finite_states(tree)`` is also the in-test assertion helper.
"""

import os

import numpy as np
import torch

_nan_checks = False


def enable_nan_checks():
    global _nan_checks
    _nan_checks = True


def disable_nan_checks():
    global _nan_checks
    _nan_checks = False


def nan_checks_enabled():
    return _nan_checks


def maybe_enable_from_env():
    """Activate debug modes named in RNA_ALGOS_DEBUG (comma-separated)."""
    modes = os.environ.get("RNA_ALGOS_DEBUG", "")
    active = {m.strip() for m in modes.split(",") if m.strip()}
    if "nans" in active:
        enable_nan_checks()
    return active


def tree_leaves_with_path(tree, path=""):
    """(path, leaf) for the leaves of nested dicts, lists and tuples, in the
    order of ``jax.tree_util.tree_flatten_with_path`` (dict keys sorted, None
    no leaf); the path in the notation of ``jax.tree_util.keystr``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for k, v in enumerate(tree):
            yield from tree_leaves_with_path(v, f"{path}[{k}]")
    elif tree is not None:
        yield path, tree


def check_finite_states(tree, name="state"):
    """Assert the lse_pair operand contract: finite or -inf, no NaN/+inf.

    ``tree``: nested dicts, lists and tuples of numpy arrays or tensors
    (a CUDA tensor is copied to the host); non-float leaves are skipped."""
    for path, leaf in tree_leaves_with_path(tree):
        if torch.is_tensor(leaf):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        bad = np.isnan(arr) | (np.isposinf(arr))
        if bad.any():
            idx = tuple(int(i) for i in np.argwhere(bad)[0])
            raise AssertionError(
                f"{name}{path}: NaN/+inf at {idx} "
                f"(value {arr[idx]!r}) — violates the lse_pair operand "
                "contract (numerics/logsumexp.py)"
            )
