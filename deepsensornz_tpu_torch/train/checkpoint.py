"""Carry JAX checkpoint parameters over to the port.

Counterpart of the parameter half of ``deepsensornz_tpu/train/checkpoint.py``.
:func:`params_from_jax` turns a flax ConvNP parameter tree (nested dicts of
arrays, e.g. ``jax.device_get(params)``) into the port's ``state_dict``:

- conv kernels HWIO → OIHW;
- transposed-conv kernels (the U-Net's ``up_i`` unless ``upsample`` is
  ``"nearest"``) HWIO → flipped spatially and laid out (I, O, kh, kw), the
  form ``conv_transpose2d`` needs to reproduce flax's SAME transpose;
- dense kernels (in, out) → ``Linear.weight`` (out, in);
- length-scales and biases unchanged.

Reading ``params.msgpack`` itself is not carried over yet (it needs msgpack).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


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
                if mod.startswith("up_") and not mod.startswith("up_mix_") \
                        and upsample != "nearest":
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
