"""Gridded prediction: ConvNP → physical-units mean/std fields.

Counterpart of ``Predictor.predict_grid`` in
``deepsensornz_tpu/infer/predict.py``: takes a batch of tasks and a target
DEM ``Field`` (raw latitude/longitude coordinates, NaN = sea), runs the
forward on the model's device, rescales the predictive spread by
``std_scale``, takes the head's mean/std, gathers the land cells on the
device, and returns them unnormalised as ``Field``s with NaN sea cells.

The whole batch runs under ``torch.inference_mode()``. Joint samples
(``n_samples > 0``), the compressed transfer modes and batch chunking are
not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deepsensornz_tpu_torch.data.grid import Dataset, Field
from deepsensornz_tpu_torch.data.processor import DataProcessor
from deepsensornz_tpu_torch.task.task import TaskBatch


class Prediction(Dataset):
    """Dataset of mean/std fields for one target variable."""


def _affine_for(dp: DataProcessor, var: str) -> tuple[float, float]:
    """(scale, offset): physical = normalised·scale + offset, for each of the
    three (affine) normalisation methods."""
    cfg = dp.config[var]
    p = cfg["params"]
    m = cfg["method"]
    if m == "mean_std":
        return p["std"], p["mean"]
    if m == "min_max":
        span = p["max"] - p["min"]
        return span / 2.0, p["min"] + span / 2.0
    if m == "positive_semidefinite":
        return p["std"], 0.0
    raise ValueError(m)


class Predictor:
    """Bind (model, data_processor, target variable) into a predict callable.
    The model's parameters decide the device every request runs on."""

    def __init__(self, model, data_processor: DataProcessor, target_var,
                 std_scale: float = 1.0, transfer_dtype: Optional[str] = None,
                 batch_chunk: Optional[int] = None, upload_dtype: Optional[str] = None):
        for name, v in (("transfer_dtype", transfer_dtype), ("batch_chunk", batch_chunk),
                        ("upload_dtype", upload_dtype)):
            if v is not None:
                raise NotImplementedError(f"Predictor({name}=...) is not ported yet")
        self.model = model
        self.dp = data_processor
        self.target_vars = [target_var] if isinstance(target_var, str) else list(target_var)
        self.target_var = self.target_vars[0]
        dy = model.cfg.dim_yt
        if dy != 1 and len(self.target_vars) != dy:
            raise ValueError(f"model has dim_yt={dy}; pass {dy} target_var names "
                             f"(got {self.target_vars})")
        self.likelihood = model.cfg.make_likelihood()
        self.std_scale = float(std_scale)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def predict_grid(
        self,
        task: TaskBatch,
        target_elev: Field,
        aux_at_targets=None,
        times: Optional[np.ndarray] = None,
        n_samples: int = 0,
        seed: int = 0,
        sea_mask: bool = True,
        unnormalise: bool = True,
        post_transform=None,
        resolution_factor: float = 1.0,
        outputs: tuple = ("mean", "std"),
    ) -> Prediction:
        """Predict on the grid of ``target_elev``.

        ``aux_at_targets`` is the normalised x-space aux Field/Dataset the
        model was trained with; its channels are resampled onto the
        prediction grid. ``post_transform(mean, std) -> (mean, std)`` maps
        the normalised moments before unnormalisation. ``seed`` only
        matters for samples.
        """
        if n_samples > 0:
            raise NotImplementedError("joint samples (n_samples > 0) are not ported yet")
        if "mean" not in outputs or not set(outputs) <= {"mean", "std"}:
            raise ValueError(f"outputs must be ('mean','std') or ('mean',); got {outputs}")
        lat = target_elev.coords[target_elev.dims[-2]]
        lon = target_elev.coords[target_elev.dims[-1]]
        if resolution_factor != 1.0:
            # densify/thin the prediction grid relative to the DEM grid
            n_lat = max(int(round(len(lat) * resolution_factor)), 2)
            n_lon = max(int(round(len(lon) * resolution_factor)), 2)
            lat = np.linspace(float(lat[0]), float(lat[-1]), n_lat)
            lon = np.linspace(float(lon[0]), float(lon[-1]), n_lon)
            target_elev = target_elev._interp_one(
                target_elev.dims[-2], lat, "nearest"
            )._interp_one(target_elev.dims[-1], lon, "nearest")
        xt1 = self.dp.map_x1(lat).astype(np.float32)
        xt2 = self.dp.map_x2(lon).astype(np.float32)

        aux = None
        if task.yt_aux is not None:
            if aux_at_targets is None:
                raise ValueError("model was trained with aux_at_targets; pass the same "
                                 "normalised aux Dataset/Field to predict_grid")
            chans = (list(aux_at_targets.values()) if isinstance(aux_at_targets, Dataset)
                     else [aux_at_targets])
            cols = []
            for f in chans:
                g = f._interp_one(f.dims[-2], xt1, "linear")
                g = g._interp_one(g.dims[-1], xt2, "linear")
                cols.append(np.nan_to_num(g.data.astype(np.float32)))
            aux = np.stack(cols, -1)  # (Ht, Wt, A)
            if aux.shape[-1] != task.yt_aux.shape[-1]:
                raise ValueError(f"aux channel mismatch: task has {task.yt_aux.shape[-1]}, "
                                 f"grid aux has {aux.shape[-1]}")

        # sea cells come back NaN: only land cells leave the device
        land = None
        if sea_mask:
            sea2d = np.isnan(target_elev.data)
            if sea2d.any():
                land = np.flatnonzero(~sea2d.ravel())

        mean, std = self._forward(task, xt1, xt2, aux, outputs, land)
        if post_transform is not None:
            mean, std = post_transform(mean, std)
        if unnormalise:
            scale, offset = self._affines()
            mean = mean * scale + offset
            if std is not None:
                std = std * np.abs(scale)

        if times is None:
            times = np.arange(task.batch_size)
        dims = ("time", "latitude", "longitude")
        coords = {"time": np.asarray(times), "latitude": lat, "longitude": lon}
        fields = {}
        for c, var in enumerate(self.target_vars):
            suffix = "" if len(self.target_vars) == 1 else f"_{var}"
            fields[f"mean{suffix}"] = Field(mean[..., c].astype(np.float32), dims, coords,
                                            f"mean{suffix}", {"variable": var})
            if std is not None:
                fields[f"std{suffix}"] = Field(std[..., c].astype(np.float32), dims, coords,
                                               f"std{suffix}", {"variable": var})
        return Prediction(fields)

    def _forward(self, task, xt1, xt2, aux, outputs, land):
        """Forward + moments on the device; host arrays (B, Ht, Wt, dy),
        NaN outside ``land`` when given."""
        dev = self.device
        B, Ht, Wt = task.batch_size, len(xt1), len(xt2)
        with torch.inference_mode():
            # target-side leaves are unused on the grid path: not uploaded
            task = TaskBatch(
                grids=tuple(g.to(dev) for g in task.grids),
                points=tuple(p.to(dev) for p in task.points),
                xt=task.xt[:, :1], yt=None, yt_mask=task.yt_mask[:, :1], yt_aux=None,
                x1g=task.x1g.to(dev), x2g=task.x2g.to(dev))
            aux_d = (None if aux is None else
                     torch.from_numpy(aux).to(dev).expand(B, *aux.shape))
            raw = self.model(task, target_grid=(torch.from_numpy(xt1).to(dev),
                                                torch.from_numpy(xt2).to(dev), aux_d))
            raw = self.likelihood.rescale_raw(raw, self.std_scale)
            mean, std = self.likelihood.mean_std(raw)
            out = {"mean": mean, "std": std}
            out = {k: v for k, v in out.items() if k in outputs}
            if land is not None:
                idx = torch.from_numpy(land).to(dev)
                out = {k: v.reshape(B, Ht * Wt, -1).index_select(1, idx)
                       for k, v in out.items()}
            host = {k: v.float().cpu().numpy() for k, v in out.items()}

        def expand(a):
            if a is None or land is None:
                return a
            full = np.full((B, Ht * Wt, a.shape[-1]), np.nan, np.float32)
            full[:, land, :] = a
            return full.reshape(B, Ht, Wt, a.shape[-1])

        return expand(host["mean"]), expand(host.get("std"))

    def _target_stat_name(self, var: Optional[str] = None) -> str:
        """Resolve the DataProcessor stats entry for a target variable."""
        var = self.target_var if var is None else var
        if var in self.dp.config:
            return var
        hits = [k for k in self.dp.config if k.startswith(var)]
        if len(hits) == 1:
            return hits[0]
        if hits:
            raise KeyError(f"target {var!r} matches multiple stats entries {hits}; "
                           "use the exact name")
        raise KeyError(f"no normalisation stats for target {var!r}; have {list(self.dp.config)}")

    def _affines(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-channel (scale, offset) vectors, shape (dim_yt,)."""
        pairs = [_affine_for(self.dp, self._target_stat_name(v)) for v in self.target_vars]
        return (np.asarray([p[0] for p in pairs], np.float64),
                np.asarray([p[1] for p in pairs], np.float64))
