"""Training orchestration: processed bundle → TaskLoader → ConvNP → fit.

Counterpart of ``deepsensornz_tpu/pipeline/train.py``:

- ``setup_task_loader``: context = [base, aux, (landmask), (stations)],
  target = stations, aux at the targets = the highres topography; the
  station-as-context modes all / fraction / random / split;
- ``initialise_model``: a ConvNP sized from one task, with the variable's
  default likelihood, its parameters drawn from ``seed`` on the CPU, an
  optional warm start with the encoder frozen (except for surface
  pressure), and the parameter count;
- ``train_model``: tasks built once, :class:`~..train.trainer.Trainer`
  (AdamW, plateau LR, early stopping, best-validation checkpoints with
  ``params.pt`` and ``params.msgpack``), the loader written with
  :func:`..pipeline.validate.save_task_loader`, the processor, and the
  post-hoc ``std_scale`` fitted on the validation tasks (:func:`fit_std_scale`)
  and stored in the metadata.

The model runs on ``device`` (``None``: the card, which must exist).
``train_model(mesh=)`` trains data parallel over the mesh's ranks, and in
row blocks of the internal grid over its spatial axis when the model's
config names ``mesh_axes``; rank 0 alone writes the run. The loss-curve
PNG (``losses.png``, :func:`..plot.make_loss_plot`) is written beside the
checkpoint where matplotlib imports, as the JAX package writes it; where
it does not (the card's machine), one line says it was skipped.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from scipy.special import ndtri

from deepsensornz_tpu_torch import config as cfg
from deepsensornz_tpu_torch.data.grid import Dataset
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig, count_params
from deepsensornz_tpu_torch.ops.grids import infer_internal_density
from deepsensornz_tpu_torch.pipeline.validate import resolve_device, save_task_loader
from deepsensornz_tpu_torch.task.loader import TaskLoader
from deepsensornz_tpu_torch.task.task import TaskBatch
from deepsensornz_tpu_torch.train.checkpoint import load_checkpoint, update_metadata
from deepsensornz_tpu_torch.train.trainer import Trainer, load_params


def write_loss_plot(train_losses, val_losses, path: str) -> bool:
    """The loss curves as a PNG at ``path`` (:func:`..plot.make_loss_plot`);
    False, with one printed line, where matplotlib does not import."""
    try:
        from deepsensornz_tpu_torch.plot import make_loss_plot
    except ImportError as e:
        print(f"{os.path.basename(path)} not written: {e}")
        return False
    make_loss_plot(train_losses, val_losses, path)
    return True


def fit_std_scale(model: ConvNP, params, tasks: TaskBatch, clip=(0.05, 20.0)) -> float:
    """The post-hoc spread recalibration factor, fitted on held-out tasks
    with ``params`` on the model's device.

    Gaussian heads: the std of the standardised residuals (y − mean)/std
    over valid targets, clipped. Mixed heads (bernoulli-gamma,
    spikes-beta): a log-space bisection (30 halvings) of the spread rescale
    s that brings the z_std of the body-conditional randomised PIT to 1:
    u = (F(y) − F_body_lo)/(F_body_hi − F_body_lo) over the observations in
    the continuous body (F(y⁻) = F(y)), z = Φ⁻¹(clip(u, 1e-6, 1 − 1e-6));
    fewer than 10 such z at s = 1 ship 1.0; the sharpest and widest
    allowed s are returned when even they miss. The head's spread moves
    through its ``rescale_raw``, so point masses are untouched.
    """
    lik = model.cfg.make_likelihood()
    load_params(model, params)
    device = next(model.parameters()).device
    tasks = tasks.to(device)
    with torch.no_grad():
        raw = model(tasks)
    y = tasks.yt.cpu().numpy().astype(np.float64)
    m = np.broadcast_to(tasks.yt_mask.cpu().numpy().astype(bool)[..., None], y.shape)
    if m.sum() < 2:
        return 1.0

    if lik.name in ("cnp", "gnp"):
        with torch.no_grad():
            mean, std = lik.mean_std(raw)
        mean = mean.cpu().numpy().astype(np.float64)
        std = std.cpu().numpy().astype(np.float64)
        z = (y[m] - mean[m]) / np.maximum(std[m], 1e-9)
        if not np.all(np.isfinite(z)):
            return 1.0
        return float(np.clip(np.std(z), *clip))

    def host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy().astype(np.float64)

    def body_zstd(s: float) -> Optional[float]:
        with torch.no_grad():
            r = lik.rescale_raw(raw, torch.tensor(s, dtype=torch.float32, device=device))
            lo, hi = map(host, lik.cdf_bounds(r, tasks.yt))
            b_lo, b_hi = map(host, lik.body_interval(r))
        body = m & (np.abs(hi - lo) < 1e-9)  # a continuous point: F(y⁻) = F(y)
        span = np.maximum(b_hi - b_lo, 1e-9)
        u = np.clip((hi - b_lo) / span, 0.0, 1.0)
        z = ndtri(np.clip(u[body], 1e-6, 1 - 1e-6))
        z = z[np.isfinite(z)]
        return float(z.std()) if len(z) >= 10 else None

    lo_s, hi_s = clip
    if body_zstd(1.0) is None:  # too few body observations: ship unscaled
        return 1.0
    # at extreme s the body can degenerate (NaN CDFs) and body_zstd gives
    # None: never compare it, fall back instead
    z_lo = body_zstd(lo_s)
    if z_lo is not None and z_lo < 1.0:  # even the sharpest allowed is too wide
        return float(lo_s)
    z_hi = body_zstd(hi_s)
    if z_hi is not None and z_hi > 1.0:  # even the widest allowed is too sharp
        return float(hi_s)
    for _ in range(30):
        mid = np.sqrt(lo_s * hi_s)  # bisect in log space
        z_mid = body_zstd(mid)
        if z_mid is None:
            break
        if z_mid > 1.0:
            lo_s = mid
        else:
            hi_s = mid
    return float(np.sqrt(lo_s * hi_s))


class Train:
    """End-to-end training of one variable/run, on ``device``
    (``None``: the card)."""

    def __init__(self, processed_output_dict: dict, seed: int = 0, device=None):
        self.p = processed_output_dict
        self.dp = processed_output_dict["data_processor"]
        self.seed = seed
        self.device = resolve_device(device)
        self.task_loader: Optional[TaskLoader] = None
        self.model: Optional[ConvNP] = None
        self.params = None
        self.metadata: dict = {}

    # ------------------------------------------------------------ task loader --

    def setup_task_loader(self, station_as_context="all",
                          internal_density: Optional[float] = None,
                          auto_set_internal_density: bool = False,
                          grid_multiple: int = 16) -> TaskLoader:
        p = self.p
        context = [p["base_ds"], p["aux_ds"]]
        sampling = ["all", "all"]
        if p.get("landmask_ds") is not None:
            context.append(p["landmask_ds"])
            sampling.append("all")
        links = []
        if station_as_context is not None and station_as_context is not False:
            context.append(p["station_df"])
            if station_as_context == "split":
                sampling.append("split")
                links = [(len(context) - 1, 0)]
            elif station_as_context == "all" or station_as_context is True:
                sampling.append("all")
            else:
                sampling.append(station_as_context)  # float fraction / "random"

        if auto_set_internal_density or internal_density is None:
            # the finest resolution of the gridded Datasets in the context
            res = [f.resolution(f.dims[-2]) for entry in context if isinstance(entry, Dataset)
                   for f in entry.values()]
            internal_density = (infer_internal_density(res) if res
                                else cfg.CONVNP_KWARGS_DEFAULT["internal_density"])

        self.task_loader = TaskLoader(
            context=context,
            target=p["station_df"],
            aux_at_targets=p["highres_aux_ds"],
            context_sampling=sampling,
            target_sampling="split" if station_as_context == "split" else "all",
            links=links,
            internal_density=internal_density,
            grid_multiple=grid_multiple,
        )
        self.internal_density = internal_density
        return self.task_loader

    def task_times(self) -> np.ndarray:
        base = next(iter(self.p["base_ds"].values()))
        return base.coords["time"]

    def create_tasks(self, times=None, **kw) -> TaskBatch:
        """Materialise the tasks of ``times`` (default: every base time) at once."""
        times = self.task_times() if times is None else times
        return self.task_loader(list(times), **kw)

    # ------------------------------------------------------------------ model --

    def initialise_model(self, unet_channels=None, likelihood: Optional[str] = None,
                         internal_density: Optional[float] = None,
                         pretrained_dir: Optional[str] = None,
                         compute_dtype: str = "bfloat16", **extra) -> ConvNP:
        assert self.task_loader is not None, "setup_task_loader first"
        var = self.p["data_settings"]["variable"]
        likelihood = likelihood or cfg.LIKELIHOODS[var]
        unet_channels = tuple(unet_channels or cfg.CONVNP_KWARGS_DEFAULT["unet_channels"])
        density = (internal_density or getattr(self, "internal_density", None)
                   or cfg.CONVNP_KWARGS_DEFAULT["internal_density"])
        self.convnp_kwargs = {"unet_channels": unet_channels, "likelihood": likelihood,
                              "internal_density": density}
        model_cfg = ConvNPConfig(
            unet_channels=unet_channels,
            likelihood=likelihood,
            internal_density=density,
            dim_yt=self.task_loader.target_dim(),
            compute_dtype=compute_dtype,
            sigmoid_output=(var == "humidity" and likelihood in ("cnp", "gnp")),
            **extra,
        )
        self.model_config_dict = {k: (list(v) if isinstance(v, tuple) else v)
                                  for k, v in dataclasses.asdict(model_cfg).items()
                                  if k != "mesh_axes"}
        example = self.task_loader([self.task_times()[0]], seed_override=0)
        # drawn on the CPU from the seed, so a run does not depend on the device
        self.model = ConvNP.from_task(model_cfg, example,
                                      generator=torch.Generator().manual_seed(self.seed)
                                      ).to(self.device)
        self.params = self.model.state_dict()
        self.frozen_patterns: tuple = ()
        if pretrained_dir is not None:
            self.params = load_checkpoint(pretrained_dir, map_location=self.device,
                                          upsample=model_cfg.upsample)["params"]
            if var != "surface_pressure":
                self.frozen_patterns = ("ls_grid", "ls_points", "unet")
        print(f"ConvNP parameters: {count_params(self.params):,}")
        return self.model

    # --------------------------------------------------------------- training --

    def train_model(self, train_times=None, val_times=None,
                    n_epochs: int = cfg.TRAIN_DEFAULTS["n_epochs"],
                    batch_size: int = cfg.TRAIN_DEFAULTS["batch_size"],
                    lr: float = cfg.TRAIN_DEFAULTS["lr"],
                    weight_decay: float = cfg.TRAIN_DEFAULTS["weight_decay"],
                    model_dir: Optional[str] = None, task_kwargs: Optional[dict] = None,
                    verbose: bool = True, recalibrate: str | bool = "auto",
                    anchor_schedule=None, lengthscale_lr_mult: float = 1.0,
                    mesh=None) -> dict:
        """Train, then (``recalibrate``: "auto" or True) fit ``std_scale``
        on the validation tasks. Without ``train_times`` the last fifth of
        the times (at least one) validates; explicit ``train_times``
        without ``val_times`` train with no validation. ``anchor_schedule``
        goes to :meth:`Trainer.fit`. ``mesh``: every rank calls this with
        the same arguments and trains on the mesh (module docstring); rank 0
        writes ``model_dir``."""
        lead = mesh is None or dist.get_rank() == 0
        times = self.task_times()
        if train_times is None:
            n_val = max(len(times) // 5, 1)
            train_times, val_times = times[:-n_val], times[-n_val:]
        if val_times is None:
            val_times = []
        task_kwargs = task_kwargs or {"datewise_deterministic": True}
        train_tasks = self.create_tasks(train_times, **task_kwargs)
        val_tasks = self.create_tasks(val_times, **task_kwargs) if len(val_times) else None

        self.metadata = self._construct_metadata_dict()
        if model_dir is not None and lead:
            os.makedirs(model_dir, exist_ok=True)
            save_task_loader(self.task_loader, os.path.join(model_dir, "task_loader.pkl"))
            self.dp.save(os.path.join(model_dir, "data_processor.json"))

        trainer = Trainer(self.model, lr=lr, weight_decay=weight_decay,
                          frozen_patterns=getattr(self, "frozen_patterns", ()),
                          lengthscale_lr_mult=lengthscale_lr_mult, mesh=mesh)
        out = trainer.fit(
            train_tasks, val_tasks, n_epochs=n_epochs, batch_size=batch_size,
            params=self.params,
            plateau_patience=cfg.TRAIN_DEFAULTS["plateau_patience"],
            plateau_factor=cfg.TRAIN_DEFAULTS["plateau_factor"],
            early_stop_patience=cfg.TRAIN_DEFAULTS["early_stop_patience"],
            checkpoint_dir=model_dir, metadata=self.metadata, verbose=verbose,
            anchor_schedule=anchor_schedule,
        )
        self.params = out["params"]
        self.train_losses = out["train_losses"]
        self.val_losses = out["val_losses"]
        load_params(self.model, self.params)

        do_recal = True if recalibrate == "auto" else bool(recalibrate)
        self.std_scale = 1.0
        if do_recal and val_tasks is None and verbose:
            print("recalibration skipped: no validation tasks "
                  "(std_scale stays 1.0 — pass val_times to fit it)")
        if do_recal and val_tasks is not None:
            self.std_scale = fit_std_scale(self.model, self.params, val_tasks)
            out["std_scale"] = self.std_scale
            if verbose:
                print(f"recalibration: std_scale = {self.std_scale:.4f}")
            if model_dir is not None and lead:
                update_metadata(model_dir, std_scale=self.std_scale)
        if model_dir is not None and lead:
            write_loss_plot(self.train_losses, self.val_losses,
                            os.path.join(model_dir, "losses.png"))
        return out

    def _construct_metadata_dict(self) -> dict:
        """What ``load_run`` rebuilds the run from."""
        return {
            "data_settings": self.p["data_settings"],
            "date_info": self.p["date_info"],
            "convnp_kwargs": getattr(self, "convnp_kwargs", {}),
            "model_config": getattr(self, "model_config_dict", {}),
        }

    def run_training_sequence(self, model_dir: Optional[str] = None,
                              station_as_context="all", convnp_kwargs=None,
                              **train_kw) -> dict:
        """setup → init → train."""
        self.setup_task_loader(station_as_context=station_as_context)
        self.initialise_model(**(convnp_kwargs or {}))
        return self.train_model(model_dir=model_dir, **train_kw)
