"""A run of one cell: the entry its traffic names, then the result line.

``run_cell`` runs the cell on ``device`` (the card; the tests pass the
CPU at a tiny size) and returns the result object and the check's lines.
It looks for no card itself: ``run.py`` does, before anything else.
"""

from __future__ import annotations

import importlib

from benchmark import check, manifest
from benchmark.entries import common


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, bench_dir=manifest.HERE) -> tuple[dict, list]:
    """(result, lines): the result object the run prints last, and the
    lines it prints on standard error before it."""
    entry = importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")
    out: common.Outcome = entry.run(cell, seed, seconds, trace, device, t0)
    ok, table = check.verdict(out.numbers, cell.limits)
    lines = [f"{k}: {v}" for k, v in out.notes.items()]
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = manifest.load_metric(m["name"], bench_dir).read(out.readings)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_name(device), "count": cell.chips,
           "memory_peak_bytes": int(out.peak_bytes)}
    result = {"correct": ok, "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": dev}
    if trace and out.readings.trace is not None:
        summary = out.readings.trace
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    result["check"] = table
    lines.append(f"correct: {ok}")
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in table.items()]
    return result, lines


def _device_name(device) -> str:
    if device.type != "cuda":
        return device.type
    import torch

    return torch.cuda.get_device_name(device)
