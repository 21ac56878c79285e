"""Debug switches: NaN trapping, eager execution, double precision.

Counterpart of ``deepsensornz_tpu/debug.py`` for eager PyTorch:

- ``nans``: every floating output of every forward op is checked and a NaN
  raises ``FloatingPointError`` naming the op, as ``jax_debug_nans`` does
  (anomaly mode only checks the backward). A ``TorchDispatchMode`` does the
  check, so it sees the ops under autograd, inference mode and custom
  autograd functions alike; on a card each check waits for the device.
  Ops that allocate without writing (``empty*``) are not checked.
- ``disable_jit``: the port runs eagerly already (op by op, with its CUDA
  kernels launched from Python), so the one compiler left to turn off is
  ``torch.compile``'s: ``torch._dynamo.config.disable``, after which a
  compiled function runs its eager code.
- ``x64``: ``torch.set_default_dtype(torch.float64)``, JAX's x64 default
  for floats made without a dtype. The port names float32 explicitly
  almost everywhere, so this reaches less than it does in JAX.

The switches are process-wide (the NaN check for the thread that enabled
it). :func:`disable_debug` undoes all three (JAX's leaves x64 on).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class NanCheckMode(TorchDispatchMode):
    """Raises ``FloatingPointError`` when an op's floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name.startswith(("empty", "new_empty")):
            return out
        leaves = out if isinstance(out, (tuple, list)) else (out,)
        for t in leaves:
            if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


# what enable_debug changed, with the value to restore: "nans" (the active
# NanCheckMode), "disable_jit" (dynamo's previous ``disable``), "x64" (the
# previous default dtype)
_saved: dict = {}


def enable_debug(nans: bool = True, disable_jit: bool = False, x64: bool = False) -> None:
    """Turn on debug behaviour (tiny-config runs only; big perf cost)."""
    if nans and "nans" not in _saved:
        mode = NanCheckMode()
        mode.__enter__()
        _saved["nans"] = mode
    if disable_jit:
        from torch import _dynamo

        _saved.setdefault("disable_jit", _dynamo.config.disable)
        _dynamo.config.disable = True
    if x64:
        _saved.setdefault("x64", torch.get_default_dtype())
        torch.set_default_dtype(torch.float64)


def disable_debug() -> None:
    """Undo :func:`enable_debug`: no NaN check, ``torch.compile`` and the
    default dtype as they were before."""
    if "nans" in _saved:
        _saved.pop("nans").__exit__(None, None, None)
    if "disable_jit" in _saved:
        from torch import _dynamo

        _dynamo.config.disable = _saved.pop("disable_jit")
    if "x64" in _saved:
        torch.set_default_dtype(_saved.pop("x64"))
