"""Tiny cells for the CPU tests: each real cell's configuration and traffic
with the widths, grids, batches and windows cut to what a CPU test holds.
The real files are untouched; these are copies with smaller numbers."""

from __future__ import annotations

import copy

import torch

from benchmark import manifest

SHRINK_MODEL = {"unet_channels": [8, 8], "internal_density": 24, "rank": 4,
                "decoder_channels": 8, "mlp_hidden": 8}
SHRINK_TRAFFIC = {"target_hw": [20, 18], "base_hw": [10, 9], "aux_hw": [20, 18],
                  "highres_hw": [40, 36], "tasks_per_request": 3, "pool": 2,
                  "warmup_requests": 1, "trace_requests": 2, "keep_share": 1.0,
                  "check_requests": 2, "pool_tasks": 6, "batch_size": 2,
                  "context_stations": 40, "target_stations": 16, "check_steps": 3,
                  "trace_epochs": 1}


def tiny_cell(workload: str, dtype: str = "float32", limits: dict | None = None) -> manifest.Cell:
    """The manifest's cell ``workload`` at a tiny size, its U-Net in
    ``dtype``, with its own limits or ``limits``."""
    cell = manifest.resolve(workload, manifest.load_manifest())
    cell = copy.deepcopy(cell)
    cell.config["model"].update(SHRINK_MODEL, compute_dtype=dtype)
    cell.traffic.update({k: v for k, v in SHRINK_TRAFFIC.items() if k in cell.traffic})
    if limits is not None:
        cell.limits = dict(limits)
    return cell


CPU = torch.device("cpu")
