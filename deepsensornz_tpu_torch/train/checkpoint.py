"""Checkpoints: parameters, optimizer state and run metadata; conversion
from and to the JAX package's parameter and optimizer trees.

Counterpart of ``deepsensornz_tpu/train/checkpoint.py``. A checkpoint
directory holds ``params.pt`` and ``opt_state.pt`` (``torch.save`` of
plain dicts of CPU tensors, read back with ``weights_only=True``) and
``metadata.json`` in the JAX package's schema (``step`` plus the caller's
metadata). Every file is written atomically. Reading the JAX package's
``params.msgpack`` is not carried over yet (the card's machine has no
msgpack); its trees convert with the functions below.

:func:`params_from_jax` turns a flax ConvNP parameter tree (nested dicts of
arrays, e.g. ``jax.device_get(params)``) into the port's ``state_dict``, and
:func:`params_to_jax` turns one back:

- conv kernels HWIO ↔ OIHW;
- transposed-conv kernels (the U-Net's ``up_i`` unless ``upsample`` is
  ``"nearest"``) HWIO ↔ flipped spatially and laid out (I, O, kh, kw), the
  form ``conv_transpose2d`` needs to reproduce flax's SAME transpose;
- dense kernels (in, out) ↔ ``Linear.weight`` (out, in);
- length-scales and biases unchanged.

:func:`opt_state_from_jax` carries optax's Adam moments and count over, so
a JAX run's mid-training state can step in the port.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
from collections import OrderedDict
from typing import Any, Mapping, Optional

import numpy as np
import torch

PARAMS_FILE = "params.pt"
OPT_FILE = "opt_state.pt"
META_FILE = "metadata.json"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _transposed(mod: str, upsample: str) -> bool:
    return mod.startswith("up_") and not mod.startswith("up_mix_") and upsample != "nearest"


def params_from_jax(tree: Mapping, upsample: str = "transpose") -> "OrderedDict[str, torch.Tensor]":
    """flax ConvNP params (with or without the top-level ``"params"`` key)
    → a ``state_dict`` for :class:`..models.convnp.ConvNP`."""
    if "params" in tree:
        tree = tree["params"]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name, leaf in tree.items():
        if name == "unet":
            for mod, p in leaf.items():
                k = np.asarray(p["kernel"])
                if _transposed(mod, upsample):
                    w = np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1))
                else:
                    w = k.transpose(3, 2, 0, 1)
                out[f"unet.{mod}.weight"] = _t(w)
                out[f"unet.{mod}.bias"] = _t(p["bias"])
        elif isinstance(leaf, Mapping):  # dense head layers
            out[f"{name}.weight"] = _t(np.asarray(leaf["kernel"]).T)
            out[f"{name}.bias"] = _t(leaf["bias"])
        else:  # ls_* scalars
            out[name] = _t(leaf).reshape(())
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor], upsample: str = "transpose") -> dict:
    """The inverse of :func:`params_from_jax`: a port ``state_dict`` → the
    flax tree ``{"params": {...}}`` of float32 numpy arrays."""
    tree: dict = {}
    for name, t in state_dict.items():
        a = t.detach().cpu().numpy().astype(np.float32)
        parts = name.split(".")
        if parts[0] == "unet":
            mod, kind = parts[1], parts[2]
            node = tree.setdefault("unet", {}).setdefault(mod, {})
            if kind == "bias":
                node["bias"] = a
            elif _transposed(mod, upsample):
                node["kernel"] = np.ascontiguousarray(a.transpose(2, 3, 0, 1)[::-1, ::-1])
            else:
                node["kernel"] = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        elif len(parts) == 2:  # dense head layers
            node = tree.setdefault(parts[0], {})
            if parts[1] == "weight":
                node["kernel"] = np.ascontiguousarray(a.T)
            else:
                node["bias"] = a
        else:  # ls_* scalars
            tree[name] = a.reshape(())
    return {"params": tree}


def opt_state_from_jax(opt_state, upsample: str = "transpose") -> dict:
    """The Adam part of an optax state (the ``ScaleByAdamState`` in the
    chain of ``deepsensornz_tpu.train.trainer._adamw_core``: ``count``,
    ``mu``, ``nu``) → the port's optimizer state. The moments are laid out
    as the parameters are (the layout maps are linear and elementwise)."""
    def is_adam(s) -> bool:
        return all(hasattr(s, a) for a in ("count", "mu", "nu"))

    adam = [opt_state] if is_adam(opt_state) else [s for s in opt_state if is_adam(s)]
    if len(adam) != 1:
        raise ValueError("expected exactly one Adam state (count, mu, nu) in the optax state")
    s = adam[0]
    return {"count": torch.tensor(int(np.asarray(s.count)), dtype=torch.int32),
            "mu": dict(params_from_jax(s.mu, upsample)),
            "nu": dict(params_from_jax(s.nu, upsample))}


def _atomic_write(path: str, data: bytes) -> None:
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class _JsonEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, np.datetime64):
            return str(o)
        return super().default(o)


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return {k: _cpu(v) for k, v in tree.items()}


def _torch_bytes(tree) -> bytes:
    buf = io.BytesIO()
    torch.save(_cpu(tree), buf)
    return buf.getvalue()


def save_checkpoint(ckpt_dir: str, params: Mapping[str, torch.Tensor],
                    opt_state: Optional[dict] = None, step: int = 0,
                    metadata: Optional[dict[str, Any]] = None) -> None:
    """Write params (+ optimizer state) and metadata atomically into
    ``ckpt_dir``."""
    _atomic_write(os.path.join(ckpt_dir, PARAMS_FILE), _torch_bytes(dict(params)))
    if opt_state is not None:
        _atomic_write(os.path.join(ckpt_dir, OPT_FILE), _torch_bytes(opt_state))
    meta = {"step": int(step), **(metadata or {})}
    _atomic_write(os.path.join(ckpt_dir, META_FILE),
                  json.dumps(meta, indent=2, cls=_JsonEncoder).encode())


def update_metadata(ckpt_dir: str, **updates) -> dict:
    """Merge ``updates`` into a checkpoint's metadata atomically (tensors
    untouched), e.g. the ``std_scale`` recalibration factor."""
    meta_path = os.path.join(ckpt_dir, META_FILE)
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    meta.update(updates)
    _atomic_write(meta_path, json.dumps(meta, indent=2, cls=_JsonEncoder).encode())
    return meta


def load_checkpoint(ckpt_dir: str, map_location="cpu") -> dict[str, Any]:
    """{"params", and where present "opt_state" and "metadata"}, tensors on
    ``map_location``."""
    out: dict[str, Any] = {"params": torch.load(os.path.join(ckpt_dir, PARAMS_FILE),
                                                map_location=map_location, weights_only=True)}
    opt_path = os.path.join(ckpt_dir, OPT_FILE)
    if os.path.exists(opt_path):
        out["opt_state"] = torch.load(opt_path, map_location=map_location, weights_only=True)
    meta_path = os.path.join(ckpt_dir, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            out["metadata"] = json.load(f)
    return out
