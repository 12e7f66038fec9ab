"""The port imports torch and never jax nor anything of the JAX package
(``rna_algos_tpu``), and importing it builds nothing."""

import ast
import json
import subprocess
import sys

from .conftest import REPO_ROOT

PROBE = r"""
import importlib, json, os, pkgutil, sys
import rna_algos_tpu_torch as pkg
from rna_algos_tpu_torch import _native
from rna_algos_tpu_torch.ops import _build
before = sorted(os.listdir(_build.BUILD_DIR)) if _build.BUILD_DIR.exists() else None
mods = []
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    mods.append(info.name)
after = sorted(os.listdir(_build.BUILD_DIR)) if _build.BUILD_DIR.exists() else None
print(json.dumps({
    "mods": mods,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "jax_package": sorted(m for m in sys.modules
                          if m == "rna_algos_tpu" or m.startswith("rna_algos_tpu.")),
    "torch": "torch" in sys.modules,
    "built": _build.library.cache_info().currsize,
    "native_built": _native.library.cache_info().currsize,
    "build_dir_same": before == after,
}))
"""


def _probe():
    res = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=str(REPO_ROOT),
        capture_output=True, text=True, check=True,
    )
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_builds_nothing():
    got = _probe()
    expected = {
        "rna_algos_tpu_torch.constants",
        "rna_algos_tpu_torch.params.contrafold",
        "rna_algos_tpu_torch.params.turner",
        "rna_algos_tpu_torch.params.vienna",
        "rna_algos_tpu_torch.utils.io",
        "rna_algos_tpu_torch.utils.output",
        "rna_algos_tpu_torch.utils.checkpoint",
        "rna_algos_tpu_torch.weights",
        "rna_algos_tpu_torch.ops.scores",
        "rna_algos_tpu_torch.ops.pallas_fold",
        "rna_algos_tpu_torch.ops.pallas_fold_prob",
        "rna_algos_tpu_torch.ops.pallas_fold_prob8",
        "rna_algos_tpu_torch.ops.pallas_fold_long",
        "rna_algos_tpu_torch.ops.pallas_skew",
        "rna_algos_tpu_torch.models.mccaskill",
        "rna_algos_tpu_torch.models.centroid",
        "rna_algos_tpu_torch.parallel.runner",
        "rna_algos_tpu_torch.cli.centroid_fold",
        "rna_algos_tpu_torch.cli.mccaskill",
        "rna_algos_tpu_torch.params.contralign",
        "rna_algos_tpu_torch.numerics.logsumexp",
        "rna_algos_tpu_torch.ops.pallas_align",
        "rna_algos_tpu_torch.ops.pallas_align_prob",
        "rna_algos_tpu_torch.models.durbin",
        "rna_algos_tpu_torch.cli.durbin",
        "rna_algos_tpu_torch.cli.generate_align_scores",
        "rna_algos_tpu_torch.utils.platform",
        "rna_algos_tpu_torch.utils.debug",
        "rna_algos_tpu_torch.utils.trace",
        "rna_algos_tpu_torch.eval.stats",
        "rna_algos_tpu_torch.eval.rfam",
        "rna_algos_tpu_torch.eval.synth",
        "rna_algos_tpu_torch.eval.baseline",
        "rna_algos_tpu_torch.eval.plots",
        "rna_algos_tpu_torch.eval.pipeline",
        "rna_algos_tpu_torch.parallel.mesh",
        "rna_algos_tpu_torch._native",
    }
    assert expected <= set(got["mods"]), got["mods"]
    assert got["jax"] == []
    assert got["jax_package"] == []
    assert got["torch"]
    assert got["built"] == 0
    assert got["native_built"] == 0
    assert got["build_dir_same"]


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the JAX package only through the port's own
    modules: no import of jax or rna_algos_tpu in its source."""
    tree = ast.parse((REPO_ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    tops = {n.split(".")[0] for n in names}
    assert "rna_algos_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "rna_algos_tpu"}, sorted(names)
