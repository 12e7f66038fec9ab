"""The cell's files, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration (``configs``:
its ``file``, a JSON object, names its parameter file beside it) and a
traffic mix (``workloads/<traffic>.json``); its comparison limits are in
``checks/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``.
"""

import hashlib
import json
import pathlib

import numpy as np

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _json(path):
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics, cell):
    """The metrics a cell reports: those without ``workloads`` and those
    that list it."""
    return [m for m in metrics if cell in m.get("workloads", (cell,))]


def load(name, root=ROOT):
    """Everything one run of cell ``name`` reads: the cell, its
    configuration (with the parsed config file and its parameter arrays),
    its traffic, its limits, and its end-to-end and per-layer metrics."""
    root = pathlib.Path(root)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfile = _json(root / config["file"])
    return {
        "cell": cell,
        "config": dict(config, **cfile),
        "params": load_params(cfile, root),
        "traffic": _json(BENCH_DIR / "workloads" / f"{cell['traffic']}.json"),
        "limits": _json(BENCH_DIR / "checks" / f"{name}.json"),
        "end_to_end": _for_cell(bench["end_to_end"], name),
        "per_layer": _for_cell(bench["per_layer"], name),
    }


def load_params(cfile, root=ROOT):
    """The configuration's parameter arrays, after checking the file
    against the hash its config records."""
    path = pathlib.Path(root) / cfile["params_file"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != cfile["params_sha256"]:
        raise ValueError(f"{path}: sha256 {digest}, the config records "
                         f"{cfile['params_sha256']}")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
