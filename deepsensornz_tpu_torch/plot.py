"""Plotting suite: maps, context encodings, timeseries, loss curves.

Counterpart of ``deepsensornz_tpu/plot.py``, with the same functions and
figures, on the port's ``data.grid`` ``Field``/``Dataset``; built on
matplotlib only (maps are plain pcolormesh over the NZ extent, without
coastlines). :func:`plot_context_encoding` takes the port's ``ConvNP``,
which carries its own parameters, and encodes with the port's SetConvs
(the station encode's kernel on the card, its plain version on the CPU).

matplotlib is imported here and nowhere else in the package, and nothing
imports this module on import of the package: where matplotlib is missing
(the card's machine), importing this module raises ``ImportError`` and
everything else runs.

All functions return the matplotlib Figure so callers can save or extend.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from deepsensornz_tpu_torch.data.grid import Dataset, Field  # noqa: E402


def _map_axes(ax, field: Field):
    lat = field.coords[field.dims[-2]]
    lon = field.coords[field.dims[-1]]
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    return lon, lat


def plot_field(field: Field, ax=None, title: str = "", cmap: str = "viridis",
               vmin=None, vmax=None, colorbar: bool = True):
    """Single map panel (role of ``PlotData.plot_with_coastlines``,
    ``utils.py:132-215``)."""
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 7))
    else:
        fig = ax.figure
    lon, lat = _map_axes(ax, field)
    pm = ax.pcolormesh(lon, lat, field.data, cmap=cmap, vmin=vmin, vmax=vmax,
                       shading="auto")
    if colorbar:
        fig.colorbar(pm, ax=ax, shrink=0.8)
    ax.set_title(title or field.name)
    return fig


def plot_prediction(prediction: Dataset, time_idx: int = 0,
                    station_coords: Optional[np.ndarray] = None):
    """Mean + std panels (role of ``deepsensor.plot.prediction`` at
    ``validate.py:544``), optional station overlay
    (``plot_stations_and_prediction``, ``validate.py:638-707``)."""
    mean = prediction["mean"].isel(time=time_idx)
    std = prediction["std"].isel(time=time_idx)
    fig, axes = plt.subplots(1, 2, figsize=(13, 7))
    plot_field(mean, axes[0], "mean", cmap="RdYlBu_r")
    plot_field(std, axes[1], "std", cmap="Greys_r")
    if station_coords is not None:
        for ax in axes:
            ax.scatter(station_coords[:, 1], station_coords[:, 0],
                       s=12, c="k", marker="^", label="stations")
        axes[0].legend(loc="lower right")
    fig.tight_layout()
    return fig


def plot_samples(prediction: Dataset, time_idx: int = 0, n: int = 3):
    """Sample panels (role of the "ConvNP sample i" figure,
    ``validate.py:1019-1027``)."""
    samples = prediction["samples"]
    n = min(n, samples.shape[0])
    mean = prediction["mean"].isel(time=time_idx)
    vmin = float(np.nanmin(mean.data))
    vmax = float(np.nanmax(mean.data))
    fig, axes = plt.subplots(1, n + 1, figsize=(5 * (n + 1), 6))
    plot_field(mean, axes[0], "mean", cmap="RdYlBu_r", vmin=vmin, vmax=vmax)
    for i in range(n):
        s = samples.isel(sample=i, time=time_idx)
        plot_field(s, axes[i + 1], f"sample {i}", cmap="RdYlBu_r",
                   vmin=vmin, vmax=vmax)
    fig.tight_layout()
    return fig


def plot_context_encoding(model, task, max_channels: int = 8):
    """Visualise the SetConv-encoded internal-grid channels of the first
    task of ``task`` (a ``TaskBatch`` on the model's device), each context
    set encoded at the length-scale the model encodes it with
    (``model.lengthscale``)."""
    import torch

    from deepsensornz_tpu_torch.ops.setconv import setconv_encode_grid
    from deepsensornz_tpu_torch.ops.setconv_cuda import encode_offgrid

    enc = []
    names = []
    with torch.no_grad():
        for i, g in enumerate(task.grids):
            ls = model.lengthscale(f"ls_grid_{i}")
            e = setconv_encode_grid(task.x1g, task.x2g, g.x1, g.x2, g.y, ls, g.mask)
            enc.append(e[0].cpu().numpy())
            names += [f"grid{i}/density"] + [f"grid{i}/ch{c}" for c in range(e.shape[-1] - 1)]
        for i, p in enumerate(task.points):
            ls = model.lengthscale(f"ls_points_{i}")
            e = encode_offgrid(task.x1g, task.x2g, p.x, p.y, p.mask, ls)
            enc.append(e[0].cpu().numpy())
            names += [f"points{i}/density"] + [f"points{i}/ch{c}" for c in range(e.shape[-1] - 1)]
    stacked = np.concatenate(enc, axis=-1)
    n = min(stacked.shape[-1], max_channels)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4.5))
    axes = np.atleast_1d(axes)
    for c in range(n):
        axes[c].imshow(stacked[..., c], origin="lower", cmap="viridis")
        axes[c].set_title(names[c], fontsize=9)
        axes[c].axis("off")
    fig.tight_layout()
    return fig


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def plot_task(task, batch_idx: int = 0):
    """Visualise one task's context/target geometry (role of
    ``deepsensor.plot.task``/``offgrid_context``): gridded context extents,
    station context points, and target points in x-space."""
    fig, ax = plt.subplots(figsize=(6, 6))
    for i, g in enumerate(task.grids):
        x1 = _np(g.x1)
        x2 = _np(g.x2)
        ax.add_patch(plt.Rectangle(
            (x2.min(), x1.min()), x2.max() - x2.min(), x1.max() - x1.min(),
            fill=False, ls="--", color=f"C{i}", label=f"grid context {i}",
        ))
    for i, p in enumerate(task.points):
        m = _np(p.mask)[batch_idx].astype(bool)
        pts = _np(p.x)[batch_idx][m]
        ax.scatter(pts[:, 1], pts[:, 0], s=16, marker="o",
                   label=f"point context {i} (n={m.sum()})")
    tm = _np(task.yt_mask)[batch_idx].astype(bool)
    tp = _np(task.xt)[batch_idx][tm]
    ax.scatter(tp[:, 1], tp[:, 0], s=24, marker="x", color="k",
               label=f"targets (n={tm.sum()})")
    ax.set_xlabel("x2")
    ax.set_ylabel("x1")
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    return fig


def plot_timeseries_comparison(
    times: np.ndarray,
    pred_mean: np.ndarray,
    pred_std: np.ndarray,
    obs: Optional[np.ndarray] = None,
    base: Optional[np.ndarray] = None,
    title: str = "",
):
    """Mean ±2σ CI vs station obs vs base field at one location
    (``plot_timeseries_comparison``, ``validate.py:862-946``)."""
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(times, pred_mean, label="ConvNP mean", color="C0")
    ax.fill_between(times, pred_mean - 2 * pred_std, pred_mean + 2 * pred_std,
                    alpha=0.25, color="C0", label="±2σ")
    if obs is not None:
        ax.plot(times, obs, ".", color="k", ms=4, label="station obs")
    if base is not None:
        ax.plot(times, base, color="C1", lw=1, label="base (ERA5)")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    return fig


def plot_errors_at_stations(
    station_lats: np.ndarray,
    station_lons: np.ndarray,
    errors: np.ndarray,
    title: str = "per-station error",
):
    """Error bubble map (``plot_errors_at_stations``, ``validate.py:549-635``)."""
    fig, ax = plt.subplots(figsize=(6, 7))
    lim = float(np.nanmax(np.abs(errors))) or 1.0
    sc = ax.scatter(station_lons, station_lats, c=errors, cmap="RdBu_r",
                    vmin=-lim, vmax=lim, s=30, edgecolor="k", linewidth=0.3)
    fig.colorbar(sc, ax=ax, shrink=0.8)
    ax.set_title(title)
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    return fig


def gen_test_fig(
    base_field: Optional[Field] = None,
    prediction: Optional[Dataset] = None,
    time_idx: int = 0,
    n_samples: int = 2,
    sea_mask: Optional[np.ndarray] = None,
):
    """Base-field / mean / samples / std panel figure
    (``gen_test_fig``, ``validate.py:948-1046``)."""
    panels = []
    if base_field is not None:
        f = base_field.isel(time=time_idx) if "time" in base_field.dims else base_field
        panels.append(("ERA5 / base", f, "RdYlBu_r"))
    if prediction is not None:
        panels.append(("ConvNP mean", prediction["mean"].isel(time=time_idx), "RdYlBu_r"))
        if "samples" in prediction:
            for i in range(min(n_samples, prediction["samples"].shape[0])):
                panels.append((f"ConvNP sample {i}",
                               prediction["samples"].isel(sample=i, time=time_idx),
                               "RdYlBu_r"))
        panels.append(("ConvNP std", prediction["std"].isel(time=time_idx), "Greys_r"))
    fig, axes = plt.subplots(1, len(panels), figsize=(5 * len(panels), 6))
    axes = np.atleast_1d(axes)
    for ax, (title, f, cmap) in zip(axes, panels):
        if sea_mask is not None and f.data.shape == sea_mask.shape:
            f = f.copy(np.where(sea_mask, np.nan, f.data))
        plot_field(f, ax, title, cmap=cmap)
    fig.tight_layout()
    return fig


def _resolve_location(location):
    """str city name (``LOCATION_LATLON``, ``config.py:181-205``) or
    (lat, lon) tuple → (lat, lon) (``_get_location_coordinates``,
    ``validate.py:1152-1165``)."""
    if isinstance(location, str):
        from deepsensornz_tpu_torch import config as _cfg

        return tuple(_cfg.LOCATION_LATLON[location])
    return tuple(location)


def _zoom_extent(location, pad: float = 2.0):
    lat, lon = _resolve_location(location)
    return (lat - pad, lat + pad), (lon - pad, min(lon + pad, 180.0))


def _sel_window(obj, lat_rng, lon_rng):
    """Label-window selection agnostic to coordinate direction (NZ grids
    store latitude descending)."""
    f = obj if isinstance(obj, Field) else next(iter(obj.values()))
    lat_c = f.coords["latitude"]
    lon_c = f.coords["longitude"]
    lat_sl = slice(*(lat_rng if lat_c[0] <= lat_c[-1] else lat_rng[::-1]))
    lon_sl = slice(*(lon_rng if lon_c[0] <= lon_c[-1] else lon_rng[::-1]))
    return obj.sel(latitude=lat_sl, longitude=lon_sl)


def plot_stations_and_prediction(
    prediction: Dataset,
    station_lats: np.ndarray,
    station_lons: np.ndarray,
    station_values: np.ndarray,
    base_field: Optional[Field] = None,
    time_idx: int = 0,
    cmap: Optional[str] = None,
    variable: str = "",
):
    """Three-panel comparison: station obs scatter / ConvNP mean / base
    field, on a shared colour scale taken from the station values
    (``plot_stations_and_prediction``, ``validate.py:638-707``)."""
    cmap = cmap or ("viridis" if "precip" in variable else "coolwarm")
    vmin = float(np.nanmin(station_values))
    vmax = float(np.nanmax(station_values))
    n = 3 if base_field is not None else 2
    fig, axes = plt.subplots(1, n, figsize=(6 * n, 7))
    sc = axes[0].scatter(station_lons, station_lats, c=station_values,
                         cmap=cmap, marker="o", edgecolor="k", linewidth=0.5,
                         s=60, vmin=vmin, vmax=vmax)
    fig.colorbar(sc, ax=axes[0], shrink=0.8)
    axes[0].set_title("Stations")
    axes[0].set_xlabel("longitude")
    axes[0].set_ylabel("latitude")
    mean = prediction["mean"].isel(time=time_idx)
    plot_field(mean, axes[1], "ConvNP mean", cmap=cmap, vmin=vmin, vmax=vmax)
    if base_field is not None:
        f = base_field.isel(time=time_idx) if "time" in base_field.dims else base_field
        plot_field(f, axes[2], "base (ERA5)", cmap=cmap, vmin=vmin, vmax=vmax)
    fig.tight_layout()
    return fig


def plot_base_and_prediction(
    base_field: Field,
    prediction: Dataset,
    time_idx: int = 0,
    location=None,
    var_label: str = "",
    std_clim: tuple = (None, 5.0),
):
    """Base field / ConvNP mean / ConvNP std panels with optional ±2° zoom
    around a named city or (lat, lon), marked on each panel
    (``plot_ERA5_and_prediction``, ``validate.py:711-798``)."""
    base = base_field.isel(time=time_idx) if "time" in base_field.dims else base_field
    mean = prediction["mean"].isel(time=time_idx)
    std = prediction["std"].isel(time=time_idx)
    if location is not None:
        lat_rng, lon_rng = _zoom_extent(location)
        base = _sel_window(base, lat_rng, lon_rng)
        mean = _sel_window(mean, lat_rng, lon_rng)
        std = _sel_window(std, lat_rng, lon_rng)
    vmin = float(min(np.nanmin(base.data), np.nanmin(mean.data)))
    vmax = float(max(np.nanmax(base.data), np.nanmax(mean.data)))
    fig, axes = plt.subplots(1, 3, figsize=(18, 7))
    plot_field(base, axes[0], f"base (ERA5) {var_label}", cmap="RdYlBu_r",
               vmin=vmin, vmax=vmax)
    plot_field(mean, axes[1], f"ConvNP mean {var_label}", cmap="RdYlBu_r",
               vmin=vmin, vmax=vmax)
    plot_field(std, axes[2], "ConvNP std", cmap="Greys_r",
               vmin=std_clim[0], vmax=std_clim[1])
    if location is not None:
        lat, lon = _resolve_location(location)
        for ax in axes:
            ax.scatter([lon], [lat], marker="s", s=100, facecolors="none",
                       edgecolors="black", linewidth=2)
    fig.tight_layout()
    return fig


def plot_prediction_with_stations(
    prediction: Dataset,
    station_lats: np.ndarray,
    station_lons: np.ndarray,
    time_idx: int = 0,
    location=None,
    zoom_to_location: bool = False,
    labels: Optional[dict] = None,
):
    """Prediction-mean map with the station network overlaid in red,
    optional location star/zoom and per-station text labels
    (``plot_prediction_with_stations``, ``validate.py:800-860``)."""
    mean = prediction["mean"].isel(time=time_idx)
    if location is not None and zoom_to_location:
        mean = _sel_window(mean, *_zoom_extent(location))
    fig, ax = plt.subplots(figsize=(9, 10))
    plot_field(mean, ax, "ConvNP mean", cmap="jet")
    ax.scatter(station_lons, station_lats, color="red", marker=".",
               s=60 if location is not None else 36)
    if location is not None:
        lat, lon = _resolve_location(location)
        ax.scatter([lon], [lat], color="black", marker="*", s=200)
    if labels:
        for (lat, lon), text in labels.items():
            ax.text(float(lon), float(lat), str(text), fontsize=8)
    if location is not None and zoom_to_location:
        (lat_lo, lat_hi), (lon_lo, lon_hi) = _zoom_extent(location)
        ax.set_xlim(lon_lo, lon_hi)
        ax.set_ylim(lat_lo, lat_hi)
    fig.tight_layout()
    return fig


def plot_elevation_band_errors(
    band_errors: dict,
    baseline_band_errors: Optional[dict] = None,
    ylabel: str = "RMSE",
    model_label: str = "ConvNP",
    baseline_label: str = "ERA5",
):
    """Paired boxplots of per-station RMSE by elevation band — the
    reference's strongest model diagnostic (violin/box error distributions
    by elevation band, ``validation_notebook.py:721-778``).

    ``band_errors``: {band label → list of per-station RMSEs} (from
    ``Validate.elevation_band_errors``)."""
    fig, ax = plt.subplots(figsize=(8, 5))
    bands = list(band_errors)
    positions = np.arange(1, len(bands) + 1, dtype=float)
    box1 = ax.boxplot(
        [band_errors[b] for b in bands], positions=positions, widths=0.35,
        patch_artist=True, boxprops=dict(facecolor="lightblue"),
    )
    handles = [box1["boxes"][0]]
    names = [model_label]
    if baseline_band_errors is not None:
        box2 = ax.boxplot(
            [baseline_band_errors.get(b, []) for b in bands],
            positions=positions + 0.4, widths=0.35,
            patch_artist=True, boxprops=dict(facecolor="darkblue"),
        )
        handles.append(box2["boxes"][0])
        names.append(baseline_label)
        ax.set_xticks(positions + 0.2)
    else:
        ax.set_xticks(positions)
    ax.set_xticklabels(bands)
    ax.legend(handles, names, loc="upper left")
    ax.set_xlabel("Elevation (m)")
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    return fig


def make_loss_plot(train_losses: Sequence[float], val_losses: Sequence[float],
                   path: Optional[str] = None):
    """Loss curves (``make_loss_plot``, ``train.py:513-522``)."""
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(train_losses, label="train")
    ax.plot(val_losses, label="val")
    ax.set_xlabel("epoch")
    ax.set_ylabel("normalised NLL")
    ax.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig


def plot_calibration(z: np.ndarray, path: Optional[str] = None, bins: int = 25):
    """Calibration figure from standardised residuals (z-scores for
    Gaussian heads; randomized-PIT z for any head —
    ``Validate.pit_stats(..., return_samples=True)["z"]``): histogram
    against the N(0,1) density, plus empirical vs nominal central-interval
    coverage. The reference assessed calibration visually via ±2σ CI
    timeseries (``validate.py:862-946``); this is the quantitative panel."""
    from scipy.stats import norm

    z = np.asarray(z)
    z = z[np.isfinite(z)]
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    ax = axes[0]
    ax.hist(z, bins=bins, density=True, alpha=0.7, label=f"z (n={len(z)})")
    grid = np.linspace(-4, 4, 200)
    ax.plot(grid, norm.pdf(grid), "k--", label="N(0,1)")
    ax.set_xlabel("standardised residual")
    ax.set_title(f"z_mean {z.mean():.2f}, z_std {z.std():.2f}")
    ax.legend()

    ax = axes[1]
    nominal = np.linspace(0.01, 0.99, 50)
    half = norm.ppf(0.5 + nominal / 2.0)
    empirical = [(np.abs(z) < h).mean() for h in half]
    ax.plot(nominal, empirical, label="empirical")
    ax.plot([0, 1], [0, 1], "k--", label="ideal")
    ax.set_xlabel("nominal central coverage")
    ax.set_ylabel("empirical coverage")
    ax.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig
