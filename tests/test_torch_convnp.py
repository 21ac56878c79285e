"""PyTorch U-Net, heads and ConvNP against the JAX package on the CPU.

(c) the U-Net against flax ``UNet`` (channels (8, 8)): k=5 and k=3,
    ``top_kernel``, transposed and nearest up-sampling, even and odd level
    sizes (the SAME-padding and ConvTranspose traps), and the TPU
    reparameterisations (lane packing, s2d, subpixel), which the port
    computes as the plain graph;
(d) ``ConvNP`` off-grid and gridded forward against ``model.apply`` for
    ``gnp`` and ``cnp``, through ``params_from_jax``.

Inputs and weights are made once (numpy seed / flax init) and handed to
both sides. f32 tolerances: rtol 1e-5 with an atol of 1e-5 times the
output's largest magnitude — convs of a dozen layers summed in different
orders by XLA and oneDNN. The bf16 row compares two bf16 pipelines that
round at different places: 3e-2 of the largest magnitude (bf16 keeps 8
mantissa bits, ~4e-3 per op, over ~10 layers).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsensornz_tpu.models import likelihoods as jlik
from deepsensornz_tpu.models.convnp import ConvNP as JConvNP
from deepsensornz_tpu.models.convnp import ConvNPConfig as JConfig
from deepsensornz_tpu.models.unet import UNet as JUNet
from deepsensornz_tpu.task.task import GridContext as JGrid
from deepsensornz_tpu.task.task import PointContext as JPoints
from deepsensornz_tpu.task.task import TaskBatch as JTask
from deepsensornz_tpu_torch.models import likelihoods as tlik
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.models.unet import UNet
from deepsensornz_tpu_torch.ops import setconv_cuda
from deepsensornz_tpu_torch.task.task import TaskBatch
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax


def _close(got, want, rtol=1e-5, atol_frac=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


def _port_unet(jparams, cin, **kw) -> UNet:
    sd = params_from_jax({"unet": jparams["params"]}, upsample=kw.get("upsample", "transpose"))
    net = UNet(cin, **kw)
    net.load_state_dict({k[len("unet."):]: v for k, v in sd.items()}, strict=True)
    return net


# -- (c) U-Net ------------------------------------------------------------------------


@pytest.mark.parametrize("hw,kw,jax_only", [
    ((32, 24), dict(kernel_size=5), {}),
    ((32, 24), dict(kernel_size=3), {}),
    ((32, 24), dict(kernel_size=5, top_kernel=3), {}),
    ((32, 24), dict(kernel_size=5, upsample="nearest"), {}),
    ((20, 12), dict(kernel_size=5), {}),               # odd bottleneck (5, 3)
    ((36, 28), dict(kernel_size=3, upsample="nearest"), {}),  # odd bottleneck (9, 7)
    ((32, 24), dict(kernel_size=5), dict(lane_pack="domain")),
    ((32, 24), dict(kernel_size=5, upsample="subpixel"), dict(downsample="s2d")),
])
def test_unet_matches_flax(rng, hw, kw, jax_only):
    B, cin = 2, 5
    x = rng.normal(size=(B,) + hw + (cin,)).astype(np.float32)
    jnet = JUNet(channels=(8, 8), out_channels=6, **kw, **jax_only)
    jparams = jnet.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x)))
    net = _port_unet(jparams, cin, channels=(8, 8), out_channels=6, **kw)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    _close(got, want)


def test_unet_bf16_close_to_flax(rng):
    B, cin, hw = 2, 5, (32, 24)
    x = rng.normal(size=(B,) + hw + (cin,)).astype(np.float32)
    jnet = JUNet(channels=(8, 8), out_channels=6, compute_dtype=jnp.bfloat16)
    jparams = jnet.init(jax.random.key(1), jnp.asarray(x))
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x)))
    net = _port_unet(jparams, cin, channels=(8, 8), out_channels=6,
                     compute_dtype=torch.bfloat16)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, rtol=0.0, atol_frac=3e-2)


# -- heads ------------------------------------------------------------------------------


@pytest.mark.parametrize("name,dim_y,kw", [("gnp", 1, {"rank": 4}), ("gnp", 2, {"rank": 3}),
                                           ("cnp", 1, {}), ("cnp", 2, {}),
                                           ("bernoulli-gamma", 1, {}),
                                           ("cnp-spikes-beta", 1, {})])
def test_heads_match_jax(rng, name, dim_y, kw):
    jl = jlik.get_likelihood(name, dim_y=dim_y, **kw)
    tl = tlik.get_likelihood(name, dim_y=dim_y, **kw)
    assert tl.num_params() == jl.num_params()
    raw = (2.0 * rng.normal(size=(3, 7, jl.num_params()))).astype(np.float32)
    for s in (1.0, 1.7):
        jr = jl.rescale_raw(jnp.asarray(raw), s)
        tr = tl.rescale_raw(torch.from_numpy(raw), s)
        _close(tr.numpy(), np.asarray(jr))
        for g, w in zip(tl.mean_std(tr), jl.mean_std(jr)):
            _close(g.numpy(), np.asarray(w))


# -- (d) ConvNP -------------------------------------------------------------------------


def _task(rng, B=2, H=48, W=32):
    return JTask(
        grids=(JGrid(x1=jnp.linspace(0, 1, 10), x2=jnp.linspace(0, 1, 9),
                     y=jnp.asarray(rng.normal(size=(B, 10, 9, 2)).astype(np.float32)),
                     mask=jnp.asarray((rng.random((B, 10, 9)) > 0.2).astype(np.float32))),),
        points=(JPoints(x=jnp.asarray(rng.random((B, 20, 2)).astype(np.float32)),
                        y=jnp.asarray(rng.normal(size=(B, 20, 1)).astype(np.float32)),
                        mask=jnp.asarray((rng.random((B, 20)) > 0.2).astype(np.float32))),),
        xt=jnp.asarray(rng.random((B, 7, 2)).astype(np.float32)),
        yt=jnp.zeros((B, 7, 1), jnp.float32), yt_mask=jnp.ones((B, 7), jnp.float32),
        yt_aux=jnp.asarray(rng.normal(size=(B, 7, 1)).astype(np.float32)),
        x1g=jnp.asarray(np.linspace(-0.1, 1.1, H).astype(np.float32)),
        x2g=jnp.asarray(np.linspace(-0.1, 1.1, W).astype(np.float32)),
    )


def _pair(rng, **cfg_kw):
    """A JAX ConvNP with its params, and the port loaded with the same."""
    jcfg = JConfig(unet_channels=(8, 8), internal_density=40, rank=4, decoder_channels=8,
                   mlp_hidden=8, compute_dtype="float32", **cfg_kw)
    jtask = _task(rng)
    jmodel = JConvNP(jcfg)
    params = jmodel.init(jax.random.key(0), jtask)
    cfg = ConvNPConfig(**dataclasses.asdict(jcfg))
    task = TaskBatch.from_numpy(jtask)
    model = ConvNP.from_task(cfg, task)
    model.load_state_dict(params_from_jax(jax.device_get(params), cfg.upsample), strict=True)
    return jmodel, params, jtask, model, task


@pytest.mark.parametrize("cfg_kw", [
    dict(likelihood="gnp"),
    dict(likelihood="cnp", upsample="nearest", kernel_size=3),
    dict(likelihood="gnp", top_kernel=3, sigmoid_output=True),
])
def test_convnp_offgrid_matches_jax(rng, cfg_kw):
    jmodel, params, jtask, model, task = _pair(rng, **cfg_kw)
    want = np.asarray(jmodel.apply(params, jtask))
    with torch.no_grad():
        got = model(task).numpy()
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("cfg_kw,target_hw", [
    (dict(likelihood="gnp"), (13, 11)),
    (dict(likelihood="cnp"), (13, 11)),
    # head hoisted through the decode: first layer narrower than the decoder
    # and a target grid larger than the internal one
    (dict(likelihood="cnp", mlp_layers=0), (50, 40)),
])
def test_convnp_gridded_matches_jax(rng, cfg_kw, target_hw):
    jmodel, params, jtask, model, task = _pair(rng, **cfg_kw)
    xt1 = np.linspace(0, 1, target_hw[0]).astype(np.float32)
    xt2 = np.linspace(0, 1, target_hw[1]).astype(np.float32)
    aux = rng.normal(size=(2,) + target_hw + (1,)).astype(np.float32)
    want = np.asarray(jmodel.apply(params, jtask, target_grid=(
        jnp.asarray(xt1), jnp.asarray(xt2), jnp.asarray(aux))))
    with torch.no_grad():
        got = model(task, target_grid=tuple(torch.from_numpy(a) for a in (xt1, xt2, aux)))
    assert got.shape == want.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("cfg_kw,target_hw", [
    (dict(likelihood="gnp"), (13, 11)),
    (dict(likelihood="cnp"), (70, 90)),
    (dict(likelihood="bernoulli-gamma"), (13, 11)),
    # the hoisted head: the decode carries the first layer's outputs
    (dict(likelihood="cnp", mlp_layers=0), (50, 40)),
])
def test_gridded_forward_at_cells_is_the_whole_grids_rows(rng, cfg_kw, target_hw):
    """The gridded forward given a list of target cells, with the aux at
    targets taken at those cells, equals the JAX gridded forward's and the
    port's own whole-grid forward's rows at those cells within the f32
    tolerance (the head's GEMM has another M), and gives (B, 0, K) for an
    empty list."""
    jmodel, params, jtask, model, task = _pair(rng, **cfg_kw)
    Ht, Wt = target_hw
    xt1 = np.linspace(0, 1, Ht).astype(np.float32)
    xt2 = np.linspace(0, 1, Wt).astype(np.float32)
    aux = rng.normal(size=(2, Ht, Wt, 1)).astype(np.float32)
    idx = np.sort(rng.choice(Ht * Wt, Ht * Wt // 6, replace=False))
    cells = setconv_cuda.target_cells(idx, Ht, Wt)
    jax_rows = np.asarray(jmodel.apply(params, jtask, target_grid=(
        jnp.asarray(xt1), jnp.asarray(xt2), jnp.asarray(aux))))
    xt1, xt2, aux = map(torch.from_numpy, (xt1, xt2, aux))
    with torch.no_grad():
        whole = model(task, target_grid=(xt1, xt2, aux))
        got = model(task, target_grid=(xt1, xt2, aux.flatten(1, 2)[:, idx]), cells=cells)
        none = model(task, target_grid=(xt1, xt2, aux.flatten(1, 2)[:, :0]),
                     cells=setconv_cuda.target_cells([], Ht, Wt))
    K = whole.shape[-1]
    assert got.shape == (2, len(idx), K) and none.shape == (2, 0, K)
    assert jax_rows.shape == (2, Ht, Wt, K)
    _close(got.numpy(), jax_rows.reshape(2, -1, K)[:, idx])
    _close(got.numpy(), whole.reshape(2, -1, K)[:, idx].numpy())


def test_init_matches_flax_names_shapes_and_lengthscales(rng):
    """The port's own init has the flax tree's names and shapes, flax's
    length-scale init, and lecun-normal kernels with zero biases."""
    jmodel, params, jtask, model, task = _pair(
        rng, init_lengthscale=(("ls_decoder", 0.05), ("ls_grid_0", 0.07)))
    fresh = ConvNP.from_task(model.cfg, task, generator=torch.Generator().manual_seed(0))
    ref = params_from_jax(jax.device_get(params), "transpose")
    sd = fresh.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    for k in sd:
        if k.startswith("ls_"):
            torch.testing.assert_close(sd[k], ref[k])
        elif k.endswith("bias"):
            assert not bool(sd[k].any())
    w = sd["unet.down_0.weight"]
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(float(w.std()) - fan_in ** -0.5) < 0.25 * fan_in ** -0.5
    assert float(w.abs().max()) <= 2.0 * fan_in ** -0.5 / 0.8796 + 1e-6


def test_config_from_jax_json():
    jcfg = JConfig(unet_channels=(16, 16, 16), likelihood="cnp", top_kernel=3,
                   init_lengthscale=(("ls_decoder", 0.02),))
    cfg = ConvNPConfig.from_dict(json.loads(json.dumps(dataclasses.asdict(jcfg))))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    # the spatial partition's axes are accepted; without a mesh the grid is whole
    model = ConvNP(ConvNPConfig(mesh_axes=("data", "spatial")), [1], [1])
    assert model.spatial_context(None, None) is None and model.partial_gradients(None) == set()
