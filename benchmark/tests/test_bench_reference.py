"""The plain reference against deepsensornz_tpu_torch at a tiny size on the
CPU: with the U-Net in float32 on both sides, every number a run compares
is at rounding level, for each cell's entry (maps, samples, losses,
gradients and updates)."""

import time

import numpy as np
import pytest
import torch

from benchmark import core, manifest
from benchmark.reference import convnp as ref
from benchmark.tests.tiny import CPU, tiny_cell

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]
# f32 on both sides: the int16 transfer (2^-16 of a map's range) and
# float32 summation orders; Adam's first steps turn rounding-sized
# gradient differences of tiny elements into up to ~1e-4 of a leaf's change
F32_LIMITS = {"moments_err": 1e-4, "sea_mismatch": 0, "wet_flip": 0.0, "sample_off": 1e-3,
              "loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-3}


@pytest.mark.parametrize("workload", CELLS)
def test_reference_matches_the_port_in_float32(workload):
    cell = tiny_cell(workload, "float32")
    cell.limits = {k: F32_LIMITS[k] for k in cell.limits}
    result, lines = core.run_cell(cell, 2**31 + 5, 0.3, False, CPU, time.perf_counter())
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0


def _port_unet(cin, channels, k):
    from deepsensornz_tpu_torch.models.unet import UNet

    torch.manual_seed(0)
    return UNet(cin, channels, 3, k, torch.float32)


@pytest.mark.parametrize("hw", [(16, 16), (24, 40)])
def test_reference_unet_is_the_port_unet(hw):
    """The reference's U-Net (lax's transposed conv by dilation, flax's SAME
    padding by hand) against the port's module on the same weights."""
    net = _port_unet(5, (4, 6), 5)
    p = {f"unet.{k}": v for k, v in net.state_dict().items()}
    x = torch.randn(2, 5, *hw)
    got = ref.unet(p, x, 2, ref.Arith("float32"))
    assert torch.allclose(got, net(x), rtol=1e-5, atol=1e-5)


def test_param_spec_is_the_ports_state_dict():
    from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig

    for workload in CELLS:
        cell = tiny_cell(workload)
        m = cell.config["model"]
        spec = ref.param_spec(m, [3, cell.traffic["aux_channels"]], [1], 1)
        port = ConvNP(ConvNPConfig.from_dict(m), [3, cell.traffic["aux_channels"]], [1], 1)
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
            k: tuple(s) for k, (s, _) in spec.items()}


def test_int16_roundtrip_is_within_half_a_step():
    """Half a step, plus the float32 roundings of the map's largest value
    (the division by the step, the product and the sum)."""
    v = np.random.default_rng(0).normal(size=(3, 1000)).astype(np.float32)
    back = ref.int16_roundtrip(v)
    step = (v.max(-1) - v.min(-1)) / 65535.0
    slack = 4 * np.finfo(np.float32).eps * np.abs(v).max(-1) + 65535 * 1e-7 * step
    assert (np.abs(back - v) <= (0.5 * step + slack)[:, None]).all()


def test_lin_weights_interpolate_and_clamp():
    w = ref.lin_weights(np.array([0.0, 1.0, 3.0]), np.array([-1.0, 0.5, 2.0, 5.0]))
    assert np.allclose(w @ np.array([0.0, 2.0, 6.0]), [0.0, 1.0, 4.0, 6.0])
