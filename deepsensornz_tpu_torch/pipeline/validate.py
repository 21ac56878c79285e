"""Reconstruct a trained run from its directory.

Counterpart of ``load_run`` and ``_first_time`` in
``deepsensornz_tpu/pipeline/validate.py``. A run directory, as the JAX
package's ``Train.train_model`` or the port writes it, holds
``task_loader.pkl``, ``data_processor.json``, ``metadata.json`` and the
parameters (``params.pt``, or the JAX package's ``params.msgpack``).

The JAX package pickles its own ``TaskLoader`` (station sets as pandas
DataFrames, grids as its ``Field``/``Dataset``); :func:`load_task_loader`
reads such a pickle, or the port's own, into the port's classes.
DataFrames need pandas to unpickle: without pandas that pickle raises an
error that says so. :func:`save_task_loader` writes the JAX layout where
pandas is installed, so the JAX package serves a run the port trained,
and the port's own pickle (no pandas object in it) elsewhere.
``Validate``, ``ValidateERA`` and ``ValidateWRF`` are not ported yet.
"""

from __future__ import annotations

import copyreg
import json
import os
import pickle

import torch

from deepsensornz_tpu_torch import config as cfg
from deepsensornz_tpu_torch.data.frame import StationFrame
from deepsensornz_tpu_torch.data.grid import Dataset, Field
from deepsensornz_tpu_torch.data.processor import DataProcessor
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.task.loader import TaskLoader
from deepsensornz_tpu_torch.train.checkpoint import load_checkpoint

# the JAX package's pickled classes and the port's counterparts
_JAX_CLASSES = {
    ("deepsensornz_tpu.task.loader", "TaskLoader"): TaskLoader,
    ("deepsensornz_tpu.data.grid", "Field"): Field,
    ("deepsensornz_tpu.data.grid", "Dataset"): Dataset,
}
_JAX_NAMES = {cls: name for name, cls in _JAX_CLASSES.items()}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises rather
    than falling back to the CPU (pass ``device="cpu"`` for that)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


class _RunUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        cls = _JAX_CLASSES.get((module, name))
        if cls is not None:
            return cls
        if module.split(".")[0] == "pandas":
            try:
                import pandas  # noqa: F401
            except ImportError as e:
                raise RuntimeError(
                    "this task_loader.pkl holds pandas DataFrames (a loader pickled by "
                    "the JAX package) and pandas is not installed; load it once where "
                    "pandas is installed and pickle the port's TaskLoader again") from e
        return super().find_class(module, name)


def load_task_loader(path: str) -> TaskLoader:
    """A pickled ``TaskLoader`` of the port or of the JAX package."""
    with open(path, "rb") as f:
        tl = _RunUnpickler(f).load()
    if not isinstance(tl, TaskLoader):
        raise TypeError(f"{path} holds a {type(tl).__name__}, not a TaskLoader")
    return tl


class _JaxLayoutPickler(pickle._Pickler):
    """Pickles the port's loader as the JAX package's: its three classes
    are written by name as the JAX classes (the standard pickler would
    import the JAX package to check each name, and that pulls in jax), and
    the loader's state is the JAX ``__dict__``, whose class has no
    ``__setstate__``: station sets as DataFrames, ``_flat_cache`` empty."""

    def __init__(self, file, frames: dict):
        super().__init__(file, protocol=pickle.DEFAULT_PROTOCOL)
        self.frames = frames

    def save_global(self, obj, name=None):
        where = _JAX_NAMES.get(obj)
        if where is None:
            return super().save_global(obj, name)
        self.write(pickle.GLOBAL + f"{where[0]}\n{where[1]}\n".encode("utf-8"))
        self.memoize(obj)

    def reducer_override(self, obj):
        if isinstance(obj, TaskLoader):
            state = dict(obj.__getstate__())
            state["context"] = [self.frames.get(id(c), c) for c in state["context"]]
            state["target"] = self.frames.get(id(state["target"]), state["target"])
            state["_flat_cache"] = {}
            return copyreg.__newobj__, (TaskLoader,), state
        return NotImplemented


def save_task_loader(tl: TaskLoader, path: str) -> None:
    """Pickle a loader for a run directory. Where pandas is installed the
    file holds the JAX package's ``TaskLoader`` (its class paths, station
    sets as the DataFrames its preprocessing makes), which both packages
    read; elsewhere it holds the port's loader, as ``pickle.dump`` writes
    it, and a line says so: load it where pandas is installed and save it
    again to serve it in the JAX package."""
    try:
        import pandas  # noqa: F401
    except ImportError:
        with open(path, "wb") as f:
            pickle.dump(tl, f)
        print(f"{path}: the port's TaskLoader layout (pandas is not installed); the JAX "
              "package reads it after load_task_loader + save_task_loader where pandas is")
        return
    frames = {}
    for e in list(tl.context) + [tl.target]:
        if isinstance(e, StationFrame) and id(e) not in frames:
            frames[id(e)] = e.to_pandas()
    with open(path, "wb") as f:
        _JaxLayoutPickler(f, frames).dump(tl)


def load_run(model_dir: str, device=None) -> dict:
    """{model, params (its ``state_dict``), task_loader, data_processor,
    metadata, variable, std_scale} of a training-run directory; the model
    on ``device`` (``None``: the card) in eval mode."""
    dev = resolve_device(device)
    task_loader = load_task_loader(os.path.join(model_dir, "task_loader.pkl"))
    dp = DataProcessor.load(os.path.join(model_dir, "data_processor.json"))
    with open(os.path.join(model_dir, "metadata.json")) as f:
        metadata = json.load(f)
    kw = metadata.get("convnp_kwargs", {})
    var = metadata.get("data_settings", {}).get("variable", "temperature")
    mc = metadata.get("model_config")
    if mc:
        model_cfg = ConvNPConfig.from_dict(mc)
    else:
        default = cfg.CONVNP_KWARGS_DEFAULT
        model_cfg = ConvNPConfig(
            unet_channels=tuple(kw.get("unet_channels", default["unet_channels"])),
            likelihood=kw.get("likelihood", cfg.LIKELIHOODS.get(var, "cnp")),
            internal_density=kw.get("internal_density", default["internal_density"]),
            dim_yt=task_loader.target_dim(),
            sigmoid_output=(var == "humidity" and kw.get("likelihood") in ("cnp", "gnp")),
        )
    # sized from one materialised task; the seeded draw is overwritten below
    example = task_loader([_first_time(task_loader)], seed_override=0)
    model = ConvNP.from_task(model_cfg, example, generator=torch.Generator().manual_seed(0))
    params = load_checkpoint(model_dir, upsample=model_cfg.upsample)["params"]
    model.load_state_dict(params, strict=True)
    model = model.to(dev).eval()
    return {
        "model": model,
        "params": model.state_dict(),
        "task_loader": task_loader,
        "data_processor": dp,
        "metadata": metadata,
        "variable": var,
        # the spread recalibration fit at train time; 1.0 when absent
        "std_scale": float(metadata.get("std_scale", 1.0)),
    }


def _first_time(task_loader: TaskLoader):
    for entry in list(task_loader.context) + [task_loader.target]:
        if isinstance(entry, StationFrame):
            return entry["time"][0]
        for f in (entry.values() if isinstance(entry, Dataset) else [entry]):
            if "time" in f.dims:
                return f.coords["time"][0]
    raise ValueError("no time coordinate found in task loader data")
