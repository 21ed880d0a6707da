"""Everything a run needs, found by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic file, its limits file, the reader of
each metric (``metrics/<name>.py``) and the reference of each model type
(``reference/<model_type>.py``).  A later cell, configuration, traffic
mix or metric is a new file and a new entry; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _entry(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    return load_json(root / _entry(bench["configs"], name, "config")["file"])


def traffic(name: str, pkg: Path = PKG) -> dict:
    return load_json(pkg / "traffic" / f"{name}.json")


def limits(workload_name: str, pkg: Path = PKG) -> Dict[str, float]:
    return load_json(pkg / "limits" / f"{workload_name}.json")


def cell_metrics(bench: dict, workload_name: str, traced: bool) -> List[dict]:
    """The metrics a run of the cell prints: its end-to-end metrics, or
    with the trace its per-layer ones (those whose ``workloads`` name it,
    or that have no such key)."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload_name in m["workloads"]]


def metric_reader(name: str, pkg: Path = PKG) -> ModuleType:
    """``metrics/<name>.py``, loaded by its path (a name may hold dots);
    it defines ``read(run) -> float | None``."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"),
        pkg / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(model_type: str) -> ModuleType:
    """The plain reference of a model type: ``reference/<model_type>.py``
    with ``forward`` and ``PAGED_KINDS``."""
    return importlib.import_module(f"portbench.reference.{model_type}")
