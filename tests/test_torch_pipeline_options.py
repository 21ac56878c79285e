"""The port's ``Train`` options against the JAX package's, on the CPU.

At ``tests/test_torch_pipeline.py``'s size (10 daily times, 24² base, 96²
DEM, 20 stations, internal density 24, U-Net (8, 8), float32):

- every ``station_as_context`` mode ("all", True, False, a fraction,
  "random", "split" with its link): the loader's sampling and links, and
  its tasks bit for bit;
- a warm start from a JAX run directory (``params.msgpack`` only): the
  loaded parameters bit for bit, and the frozen set (the encoder, except
  for surface pressure);
- ``run_training_sequence`` with the station context split, that warm
  start and ``recalibrate=False``: two epochs' losses to rtol 1e-4 (as
  ``test_two_epochs_match_jax``), the frozen parameters unchanged on both
  sides, and no ``std_scale`` fitted or stored.
"""

import json
import os

import jax
import pytest
import torch

from deepsensornz_tpu.pipeline.train import Train as JTrain
from deepsensornz_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from deepsensornz_tpu_torch.pipeline.train import Train
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax
from deepsensornz_tpu_torch.train.trainer import freeze_mask
from tests.test_torch_pipeline import FIT, MODEL, _bundles, assert_same_task

ENCODER = ("ls_grid", "ls_points", "unet")


@pytest.fixture(scope="module")
def bundles():
    out, jout, _ = _bundles("temperature")
    return out, jout


def pretrained(jout, path: str, seed: int = 1):
    """A JAX run directory holding a fresh JAX model's parameters drawn
    from ``seed``; returns them."""
    jt = JTrain(jout, seed=seed)
    jt.setup_task_loader(internal_density=24)
    jt.initialise_model(**MODEL)
    os.makedirs(path, exist_ok=True)
    jsave_checkpoint(path, jt.params)
    return jax.device_get(jt.params)


@pytest.mark.parametrize("mode", ["all", True, False, 0.5, "random", "split"])
def test_station_as_context_matches_jax(bundles, mode):
    out, jout = bundles
    jt, tt = JTrain(jout), Train(out, device="cpu")
    jtl = jt.setup_task_loader(station_as_context=mode, internal_density=24)
    tl = tt.setup_task_loader(station_as_context=mode, internal_density=24)
    assert len(tl.context) == len(jtl.context) == (3 if mode is False else 4)
    assert tl.context_sampling == jtl.context_sampling
    assert (tl.target_sampling, tl.links) == (jtl.target_sampling, jtl.links)
    for kw in ({"datewise_deterministic": True}, {"seed_override": 3}):
        assert_same_task(jt.create_tasks(**kw), tt.create_tasks(**kw))


@pytest.mark.parametrize("variable,frozen", [("temperature", ENCODER), ("surface_pressure", ())])
def test_warm_start_loads_the_jax_run(variable, frozen, tmp_path):
    out, jout, _ = _bundles(variable)
    want = pretrained(jout, str(tmp_path))
    jt, tt = JTrain(jout), Train(out, device="cpu")
    for t in (jt, tt):
        t.setup_task_loader(internal_density=24)
        t.initialise_model(pretrained_dir=str(tmp_path), **MODEL)
    assert tt.frozen_patterns == jt.frozen_patterns == frozen
    want = params_from_jax(want, tt.model.cfg.upsample)
    assert list(tt.params) == list(want)
    for k, v in want.items():
        assert torch.equal(tt.params[k], v), k
    for k, v in params_from_jax(jax.device_get(jt.params), tt.model.cfg.upsample).items():
        assert torch.equal(tt.params[k], v), k
    fresh = tt.model.state_dict()  # the seed-0 draw the warm start replaced
    assert any(not torch.equal(fresh[k], v) for k, v in want.items())


def test_warm_start_split_training_matches_jax(bundles, tmp_path):
    out, jout = bundles
    jstart = pretrained(jout, str(tmp_path / "pre"))
    kw = dict(station_as_context="split", recalibrate=False,
              convnp_kwargs={**MODEL, "pretrained_dir": str(tmp_path / "pre")}, **FIT)
    jt, tt = JTrain(jout), Train(out, device="cpu")
    jres = jt.run_training_sequence(model_dir=str(tmp_path / "jax"), **kw)
    res = tt.run_training_sequence(model_dir=str(tmp_path / "port"), **kw)
    assert tt.task_loader.links == [(3, 0)] and tt.frozen_patterns == ENCODER

    torch.testing.assert_close(torch.tensor(res["train_losses"]),
                               torch.tensor(jres["train_losses"]), rtol=1e-4, atol=0.0)
    torch.testing.assert_close(torch.tensor(res["val_losses"]),
                               torch.tensor(jres["val_losses"]), rtol=1e-4, atol=0.0)
    start = params_from_jax(jstart, tt.model.cfg.upsample)
    jend = params_from_jax(jax.device_get(jt.params), tt.model.cfg.upsample)
    frozen = freeze_mask(start, ENCODER)
    assert any(frozen.values()) and not all(frozen.values())
    for k, v in start.items():
        if frozen[k]:
            assert torch.equal(tt.params[k], v) and torch.equal(jend[k], v), k
    assert any(not torch.equal(tt.params[k], v) for k, v in start.items() if not frozen[k])

    assert tt.std_scale == jt.std_scale == 1.0
    assert "std_scale" not in res and "std_scale" not in jres
    for side in ("port", "jax"):
        with open(tmp_path / side / "metadata.json") as f:
            assert "std_scale" not in json.load(f), side
