"""The port's msgpack codec against flax's ``to_bytes``/``msgpack_restore``.

The codec must write exactly the bytes flax writes for the trees a
checkpoint holds (a ConvNP parameter tree, numpy and Python scalars,
strings, nested lists and dicts, every integer width), read flax's bytes
back to the same values, dtypes and shapes, and its own bytes must load in
flax. ``params.msgpack`` written by the port's ``save_checkpoint`` loads in
the JAX ``load_checkpoint`` and back in the port.
"""

import dataclasses

import flax.serialization as fser
import jax
import msgpack as msgpack_lib
import numpy as np
import pytest
import torch

from deepsensornz_tpu.data.processor import DataProcessor as JProcessor
from deepsensornz_tpu.data.synthetic import synthetic_bundle
from deepsensornz_tpu.models.convnp import ConvNP as JConvNP
from deepsensornz_tpu.models.convnp import ConvNPConfig as JConfig
from deepsensornz_tpu.task.loader import TaskLoader as JTaskLoader
from deepsensornz_tpu.train.checkpoint import load_checkpoint as jload_checkpoint
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.task.task import TaskBatch
from deepsensornz_tpu_torch.train import msgpack
from deepsensornz_tpu_torch.train.checkpoint import (
    load_checkpoint, params_from_jax, params_to_jax, save_checkpoint)


def assert_same_tree(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_tree(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b or (a != a and b != b)


@pytest.fixture(scope="module")
def convnp_params():
    """A small flagship-shaped (gnp, transpose upsampling) ConvNP's flax
    params, as ``jax.device_get`` hands them to ``to_bytes``."""
    base, dem, stations = synthetic_bundle(n_times=3, base_hw=(16, 16), dem_hw=(32, 32),
                                           n_stations=10)
    dp = JProcessor()
    dp.set_coord_maps_from_extent(
        dem.coords["latitude"].min(), dem.coords["latitude"].max(),
        dem.coords["longitude"].min(), dem.coords["longitude"].max())
    tl = JTaskLoader(context=[dp(base, method="mean_std"), dp(stations, method="mean_std")],
                     target=dp(stations), internal_density=20,
                     aux_at_targets=dp(dem.fillna(0.0).rename("elevation"), method="min_max"))
    jtask = tl(list(base.coords["time"][:2]))
    jcfg = JConfig(unet_channels=(8, 8), likelihood="gnp", internal_density=20,
                   decoder_channels=8, mlp_hidden=8, rank=4, compute_dtype="float32")
    params = jax.device_get(JConvNP(jcfg).init(jax.random.key(0), jtask))
    return jcfg, jtask, params


def test_convnp_params_bitwise(convnp_params):
    _, _, params = convnp_params
    flax_bytes = fser.to_bytes(params)
    assert msgpack.packb(params) == flax_bytes
    assert_same_tree(msgpack.unpackb(flax_bytes), fser.msgpack_restore(flax_bytes))


SCALARS = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.0, -0.0, 1.5, 1e300, float("inf"), float("nan"), True, False, None,
    "", "a", "x" * 31, "x" * 32, "x" * 255, "x" * 256, "x" * 65536, "ünïcode",
    b"", b"\x00\x01", b"y" * 256, b"y" * 65536,
    np.float32(1.25), np.float64(-2.5), np.int32(-7), np.int64(2**40), np.uint8(200),
    np.bool_(True), np.float16(0.5),
]


@pytest.mark.parametrize("value", SCALARS, ids=lambda v: f"{type(v).__name__}:{str(v)[:12]}")
def test_scalars_bitwise(value):
    # flax's to_bytes turns lists into {"0": ...} dicts; msgpack_serialize
    # (in_place: no key sorting) packs them as arrays
    tree = {"v": value, "nested": {"list": [value, [value]]}}
    flax_bytes = fser.msgpack_serialize(tree, in_place=True)
    assert msgpack.packb(tree) == flax_bytes
    assert_same_tree(msgpack.unpackb(flax_bytes), fser.msgpack_restore(flax_bytes))
    assert_same_tree(fser.msgpack_restore(msgpack.packb(tree)), msgpack.unpackb(flax_bytes))


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "int8", "int32", "int64",
                                   "uint16", "bool", "complex64"])
@pytest.mark.parametrize("shape", [(), (0,), (3,), (2, 3, 4), (17, 1)], ids=str)
def test_arrays_bitwise(dtype, shape):
    a = (np.random.default_rng(1).normal(size=shape) * 10).astype(dtype)
    tree = {"a": a, "b": np.asfortranarray(a.T) if a.ndim > 1 else a}
    flax_bytes = fser.to_bytes(tree)
    assert msgpack.packb(tree) == flax_bytes
    assert_same_tree(msgpack.unpackb(flax_bytes), fser.msgpack_restore(flax_bytes))


def test_large_containers_bitwise():
    # a map and an array past 65535 entries (the 32-bit length forms)
    tree = {f"k{i}": {"v": np.float32(i)} for i in range(70000)}
    tree["list"] = list(range(70000))
    flax_bytes = fser.msgpack_serialize(tree, in_place=True)
    assert msgpack.packb(tree) == flax_bytes
    assert_same_tree(msgpack.unpackb(flax_bytes), fser.msgpack_restore(flax_bytes))


def test_big_array_uses_long_ext_header():
    a = np.arange(70000, dtype=np.float64)
    flax_bytes = fser.to_bytes({"a": a})
    assert msgpack.packb({"a": a}) == flax_bytes
    assert msgpack.unpackb(flax_bytes)["a"].tobytes() == a.tobytes()


def test_refused_encodings():
    with pytest.raises(ValueError, match="complex"):
        msgpack.unpackb(fser.to_bytes({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="ext code"):
        msgpack.unpackb(msgpack_lib.packb(msgpack_lib.ExtType(9, b"abc")))
    with pytest.raises(NotImplementedError, match="chunked"):
        msgpack.unpackb(msgpack_lib.packb({"__msgpack_chunked_array__": True, "shape": {}}))
    with pytest.raises(TypeError):
        msgpack.packb({"c": 1 + 2j})


def test_bfloat16_loads_where_numpy_knows_it():
    import jax.numpy as jnp  # registers bfloat16 with numpy (ml_dtypes)

    flax_bytes = fser.to_bytes({"a": np.asarray(jnp.linspace(-3, 3, 11, dtype=jnp.bfloat16))})
    assert_same_tree(msgpack.unpackb(flax_bytes), fser.msgpack_restore(flax_bytes))
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(fser.to_bytes({"a": np.ones(4)})[:-3])
    with pytest.raises(ValueError, match="after"):
        msgpack.unpackb(fser.to_bytes({"a": 1}) + b"\x00")


def test_port_checkpoint_msgpack_round_trip(convnp_params, tmp_path):
    """The port's ``params.msgpack`` loads in the JAX ``load_checkpoint``
    to flax's tree, and back in the port, bit for bit."""
    jcfg, jtask, params = convnp_params
    model = ConvNP.from_task(ConvNPConfig(**dataclasses.asdict(jcfg)), TaskBatch.from_numpy(jtask))
    model.load_state_dict(params_from_jax(params), strict=True)
    save_checkpoint(str(tmp_path), model.state_dict(), step=3, flax_upsample=jcfg.upsample)
    written = (tmp_path / "params.msgpack").read_bytes()
    assert written == fser.to_bytes(params_to_jax(model.state_dict(), jcfg.upsample))
    back = jload_checkpoint(str(tmp_path), params)["params"]
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(params)):
        assert pa == pb and np.asarray(a).tobytes() == np.asarray(b).tobytes()
    (tmp_path / "params.pt").unlink()
    got = load_checkpoint(str(tmp_path), upsample=jcfg.upsample)
    assert got["metadata"]["step"] == 3
    for k, v in model.state_dict().items():
        assert torch.equal(got["params"][k], v), k
