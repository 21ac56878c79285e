"""The port's perf harness and debug switches, against the JAX package's (CPU).

Mirrors tests/test_misc.py's harness and debug tests: ``benchmark_fn``,
``Timer``, ``device_memory_stats``, ``profile_trace``, and
``enable_debug``/``disable_debug``, whose NaN check raises the
``FloatingPointError`` that ``jax_debug_nans`` raises.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsensornz_tpu.perf import harness as jharness
from deepsensornz_tpu_torch import debug
from deepsensornz_tpu_torch.perf import harness
from deepsensornz_tpu_torch.perf.harness import (
    Timer,
    benchmark_fn,
    device_memory_stats,
    profile_trace,
)


def test_benchmark_fn_runs():
    out = benchmark_fn(lambda x: x * 2 + 1, torch.ones((32, 32)), warmup=1, reps=2)
    assert out["p50_s"] > 0 and out["min_s"] <= out["p50_s"] and out["reps"] == 2
    assert set(out) == set(jharness.benchmark_fn(lambda x: x, jnp.ones(2), reps=1))


def test_benchmark_fn_calls_warmup_plus_reps():
    calls = []
    benchmark_fn(lambda: calls.append(1) or torch.zeros(1), warmup=2, reps=3)
    assert len(calls) == 5


@dataclasses.dataclass
class _Box:
    name: str
    value: torch.Tensor


@pytest.mark.parametrize("out,first", [
    (torch.arange(3), 0),
    ((np.zeros(2), [1.0, torch.arange(2) + 5]), 5),
    ({"placements": np.zeros((2, 2)), "history": [0.5], "task": _Box("t", torch.arange(2) + 7)},
     7),
    (_Box("b", torch.arange(1) + 9), 9),
    ({"host": np.ones(3)}, None),
])
def test_first_tensor_leaf(out, first):
    t = harness._first_tensor(out)
    assert (t is None) if first is None else int(t.reshape(-1)[0]) == first


def test_sync_waits_for_the_card_only(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    harness._sync({"a": torch.ones(2)})
    harness._sync(np.ones(2))
    assert calls == []


def test_timer_sections():
    t, jt = Timer(), jharness.Timer()
    for timer in (t, jt):
        with timer.section("a"):
            sum(range(1000))
        with timer.section("a"):
            pass
        with timer.section("b"):
            pass
    rep = t.report()
    assert "a" in rep and rep.index("a") < rep.index("b") or t.sections["b"] > t.sections["a"]
    assert list(t.sections) == list(jt.sections) == ["a", "b"]


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    jstats = jharness.device_memory_stats()
    assert set(stats[0]) == set(jstats[0])
    if torch.cuda.is_available():
        assert len(stats) == torch.cuda.device_count()
    else:  # a device without stats: nothing invented
        assert stats == [{"device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None,
                          "bytes_limit": None}]


def test_profile_trace_writes_dir(tmp_path):
    d = str(tmp_path / "trace")
    with profile_trace(d) as log_dir:
        _ = torch.ones((64, 64)) @ torch.ones((64, 64))
    assert log_dir == d and os.path.isdir(d)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


@pytest.fixture
def debug_off():
    yield
    debug.disable_debug()
    jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("op", ["div", "log", "mul_under_autograd", "inference_mode"])
def test_nan_check_raises_like_jax_debug_nans(debug_off, op):
    jax.config.update("jax_debug_nans", True)
    jfn = {"div": lambda: jnp.zeros(2) / jnp.zeros(2), "log": lambda: jnp.log(-jnp.ones(2)),
           "mul_under_autograd": lambda: jnp.ones(2) * jnp.nan,
           "inference_mode": lambda: jnp.sqrt(-jnp.ones(2))}[op]
    with pytest.raises(FloatingPointError):
        jax.block_until_ready(jfn())
    jax.config.update("jax_debug_nans", False)

    def tfn():
        if op == "div":
            return torch.zeros(2) / torch.zeros(2)
        if op == "log":
            return torch.log(-torch.ones(2))
        if op == "mul_under_autograd":
            return (torch.ones(2, requires_grad=True) * float("nan")).sum()
        with torch.inference_mode():
            return torch.sqrt(-torch.ones(2))

    debug.enable_debug(nans=True)
    with pytest.raises(FloatingPointError, match="nan"):
        tfn()
    debug.disable_debug()
    assert torch.isnan(tfn()).any()  # off again: the NaN comes back as a value


def test_nan_check_passes_finite_work_and_allocations(debug_off):
    debug.enable_debug(nans=True)
    x = torch.empty(1000)  # uninitialised memory is not checked
    y = torch.softmax(torch.randn(4, 5), -1)
    assert x.shape == (1000,) and torch.isfinite(y).all()


def test_disable_debug_undoes_all_three(debug_off):
    import torch._dynamo

    dtype, dynamo = torch.get_default_dtype(), torch._dynamo.config.disable
    debug.enable_debug(nans=True, disable_jit=True, x64=True)
    assert torch.get_default_dtype() == torch.float64 and torch.zeros(1).dtype == torch.float64
    assert torch._dynamo.config.disable is True
    with pytest.raises(FloatingPointError):
        torch.log(-torch.ones(1))
    debug.enable_debug(nans=True, x64=True)  # enabling twice stacks nothing
    debug.disable_debug()
    assert torch.get_default_dtype() == dtype and torch._dynamo.config.disable == dynamo
    assert torch.isnan(torch.log(-torch.ones(1))).all()
    debug.disable_debug()  # a second disable changes nothing
    assert torch.get_default_dtype() == dtype
