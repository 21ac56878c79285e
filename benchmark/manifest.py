"""``BENCHMARK.json`` and the files it names, found by name.

A cell (one entry of ``workloads``) resolves to its configuration file
``configs/<config>.json``, its traffic file ``traffic/<traffic>.json``, its
limits ``limits/<workload>.json`` and the readers of its per-layer metrics
``metrics/<metric>.py``. Adding a configuration, a mix, a cell or a metric
adds files and entries; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
# modules the process that prints a result may not hold, by top-level name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "deepsensornz_tpu")


def valid_name(s: str) -> bool:
    return isinstance(s, str) and NAME.fullmatch(s) is not None


def valid_unit(s: str) -> bool:
    return isinstance(s, str) and UNIT.fullmatch(s) is not None


def forbidden_loaded(names) -> list[str]:
    """The module names whose top-level name (before the first dot) is a
    forbidden one, compared whole: ``deepsensornz_tpu_torch`` passes."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def load_manifest(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: run from the root of a checkout")
    return json.loads(path.read_text())


def _json(kind: str, name: str, bench_dir: Path) -> dict:
    if not valid_name(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    path = Path(bench_dir) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def load_config(name: str, bench_dir: Path = HERE) -> dict:
    return _json("configs", name, bench_dir)


def load_traffic(name: str, bench_dir: Path = HERE) -> dict:
    return _json("traffic", name, bench_dir)


def load_limits(workload: str, bench_dir: Path = HERE) -> dict:
    return _json("limits", workload, bench_dir)


def load_metric(name: str, bench_dir: Path = HERE) -> ModuleType:
    """The reader of a per-layer metric: ``metrics/<name>.py``, a module
    with ``read(ctx) -> float | None``."""
    if not valid_name(name):
        raise ValueError(f"metric name {name!r} is not a valid name")
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no metric reader {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise TypeError(f"{path} defines no read(ctx)")
    return module


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # the manifest's end-to-end metrics this cell reports
    per_layer: list    # the manifest's per-layer metrics this cell reports


def _reports(metric: dict, workload: str, per_layer: bool) -> bool:
    """Whether a cell reports ``metric``: listed in its ``workloads``. A
    per-layer metric must list them; an end-to-end metric without the key
    is reported by every cell."""
    if "workloads" not in metric:
        if per_layer:
            raise KeyError(f"per-layer metric {metric['name']!r} lists no workloads")
        return True
    return workload in metric["workloads"]


def resolve(workload: str, manifest: dict, bench_dir: Path = HERE) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; the manifest has {sorted(cells)}")
    w = cells[workload]
    e2e = [m for m in manifest["end_to_end"] if _reports(m, workload, False)]
    per_layer = [m for m in manifest["per_layer"] if _reports(m, workload, True)]
    return Cell(name=workload, chips=int(w["chips"]), config=load_config(w["config"], bench_dir),
                traffic=load_traffic(w["traffic"], bench_dir),
                limits=load_limits(workload, bench_dir), end_to_end=e2e, per_layer=per_layer)
