"""The port's ``TaskLoader`` against the JAX ``TaskLoader``, bit for bit.

Data: the JAX package's ``synthetic_bundle`` → ``PreprocessForDownscaling``
→ ``Train.setup_task_loader`` (as ``tests/test_server.py`` builds it): a
gridded base, a gridded aux, the station frame as context and target, and
the highres aux at the targets. Each JAX loader gets a twin in the port,
built from the same arguments with the JAX ``Field``s and ``Dataset``s
copied into the port's and the DataFrames passed through ``StationFrame``.
Every leaf of every task must have the same dtype, shape and bytes.

Both loaders have two paths: the native fast path (``native/taskpack.cpp``,
each package with its own binding) for all-``"all"`` sampling, and the
Python path for everything else; a test forces the Python path by making
both bindings report no library. Also here: ``DataFrame.sample``'s row
choice reproduced without pandas, ``StationFrame`` against pandas, and a
build of the port's taskpack from several processes at once.
"""

import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import deepsensornz_tpu.native.taskpack as jtaskpack
from deepsensornz_tpu.data import grid as jgrid
from deepsensornz_tpu.data.synthetic import synthetic_bundle
from deepsensornz_tpu.pipeline.preprocess import PreprocessForDownscaling
from deepsensornz_tpu.pipeline.train import Train
from deepsensornz_tpu.task.loader import TaskLoader as JTaskLoader
from deepsensornz_tpu_torch.data.frame import StationFrame, frame_value_cols
from deepsensornz_tpu_torch.data.grid import Dataset, Field
from deepsensornz_tpu_torch.native import taskpack
from deepsensornz_tpu_torch.pipeline.validate import load_task_loader
from deepsensornz_tpu_torch.task.loader import TaskLoader, sample_rows

REPO = Path(__file__).resolve().parent.parent


def to_port(entry):
    """A JAX-side context/target/aux entry as the port's."""
    if isinstance(entry, pd.DataFrame):
        return StationFrame.from_pandas(entry)
    if isinstance(entry, jgrid.Field):
        return Field(entry.data, entry.dims, entry.coords, entry.name, dict(entry.attrs))
    if isinstance(entry, jgrid.Dataset):
        return Dataset({k: to_port(v) for k, v in entry.items()})
    return entry


def leaves(task):
    out = [("xt", task.xt), ("yt", task.yt), ("yt_mask", task.yt_mask),
           ("yt_aux", task.yt_aux), ("x1g", task.x1g), ("x2g", task.x2g)]
    for i, g in enumerate(task.grids):
        out += [(f"grid{i}.{k}", getattr(g, k)) for k in ("x1", "x2", "y", "mask")]
    for i, p in enumerate(task.points):
        out += [(f"points{i}.{k}", getattr(p, k)) for k in ("x", "y", "mask")]
    return out


def assert_same_task(jtask, task):
    """Equal structure; every leaf the same dtype, shape and bytes."""
    assert (len(task.grids), len(task.points)) == (len(jtask.grids), len(jtask.points))
    for (name, a), (_, b) in zip(leaves(jtask), leaves(task)):
        if a is None:
            assert b is None, name
            continue
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu", name
        a, b = np.asarray(a), b.numpy()
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        assert a.tobytes() == b.tobytes(), name


@pytest.fixture(scope="module")
def data():
    base, dem, stations = synthetic_bundle(n_times=6, base_hw=(16, 16), dem_hw=(32, 32),
                                           n_stations=10)
    out = PreprocessForDownscaling(variable="temperature").run_processing_sequence(
        dem, {"temperature": base}, stations, highres_factor=2, lowres_factor=4)
    tr = Train(out)
    jtl = tr.setup_task_loader(station_as_context="all", internal_density=24)
    return {"out": out, "jtl": jtl, "times": list(tr.task_times())}


def pair(data, context=None, target=None, **kw):
    """A JAX loader over the preprocessed data and its port twin."""
    out = data["out"]
    args = dict(context=[out["base_ds"], out["aux_ds"], out["station_df"]],
                target=out["station_df"], aux_at_targets=out["highres_aux_ds"],
                internal_density=24)
    args.update(kw)
    if context is not None:
        args["context"] = context
    if target is not None:
        args["target"] = target
    port = {k: ([to_port(c) for c in v] if k == "context" else to_port(v))
            for k, v in args.items()}
    return JTaskLoader(**args), TaskLoader(**port)


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX binding with its library loaded: a load that failed earlier
    in this process (a concurrent first build) is tried again."""
    if not jtaskpack.available():
        monkeypatch.setattr(jtaskpack, "_TRIED", False)
    assert jtaskpack.available()


@pytest.fixture(params=["fast", "python"])
def path(request, monkeypatch):
    if request.param == "fast":
        request.getfixturevalue("jax_native")
        assert taskpack.available(), taskpack.build_error()
    else:
        monkeypatch.setattr(jtaskpack, "available", lambda: False)
        monkeypatch.setattr(taskpack, "available", lambda: False)
    return request.param


def check_path(path, before):
    """The port took the fast path exactly when ``path`` is "fast"."""
    ran = taskpack.call_counts()["pack_station_batches"] > before
    assert ran == (path == "fast")


@pytest.mark.parametrize("dates", ["one", "list", "array"])
def test_loader_matches_jax(data, path, dates):
    jtl, tl = pair(data)
    times = data["times"]
    arg = {"one": times[2], "list": times[:4], "array": np.asarray(times[1:])}[dates]
    before = taskpack.call_counts()["pack_station_batches"]
    assert_same_task(jtl(arg), tl(arg))
    check_path(path, before)
    assert tl.context_var_IDs == jtl.context_var_IDs
    assert tl.target_var_IDs == jtl.target_var_IDs
    assert (tl.context_dims(), tl.target_dim(), tl.aux_dim()) == \
        (jtl.context_dims(), jtl.target_dim(), jtl.aux_dim())
    assert (tl.point_capacity, tl.target_capacity) == (jtl.point_capacity, jtl.target_capacity)
    np.testing.assert_array_equal(tl.x1g, jtl.x1g)
    np.testing.assert_array_equal(tl.x2g, jtl.x2g)


def test_preprocessed_loader_copies_bitwise(data, path):
    """The loader ``Train.setup_task_loader`` built, through its own
    attributes."""
    jtl = data["jtl"]
    tl = TaskLoader([to_port(c) for c in jtl.context], to_port(jtl.target),
                    aux_at_targets=to_port(jtl.aux_at_targets),
                    context_sampling=jtl.context_sampling, internal_density=jtl.internal_density)
    assert_same_task(jtl(data["times"]), tl(data["times"]))


@pytest.mark.parametrize("sampling", ["all", True, 0.3, 0.5, 0.0, 4, 1, 100, "random"],
                         ids=str)
@pytest.mark.parametrize("seeding", [{"seed_override": 7}, {"seed_override": 42},
                                     {"datewise_deterministic": True}], ids=str)
def test_context_sampling_matches_jax(data, sampling, seeding):
    jtl, tl = pair(data, context_sampling=["all", "all", sampling])
    times = data["times"][:5]
    assert_same_task(jtl(times, **seeding), tl(times, **seeding))
    # the same sampling asked for per call, from an "all" loader
    jtl2, tl2 = pair(data)
    assert_same_task(jtl2(times, context_sampling=["all", "all", sampling], **seeding),
                     tl2(times, context_sampling=["all", "all", sampling], **seeding))


@pytest.mark.parametrize("seeding", [{"seed_override": 3}, {"datewise_deterministic": True}],
                         ids=str)
def test_split_with_links_matches_jax(data, seeding):
    jtl, tl = pair(data, context_sampling=["all", "all", "split"], target_sampling="split",
                   links=[(2, 0)])
    jtask, task = jtl(data["times"], **seeding), tl(data["times"], **seeding)
    assert_same_task(jtask, task)
    # context and target stations are disjoint and both present
    m = task.points[0].mask[0].bool()
    tm = task.yt_mask[0].bool()
    ctx = {tuple(p) for p in task.points[0].x[0][m].numpy().round(6).tolist()}
    tgt = {tuple(p) for p in task.xt[0][tm].numpy().round(6).tolist()}
    assert ctx and tgt and not ctx & tgt


def test_split_frac_and_unlinked_split_target(data):
    jtl, tl = pair(data, context_sampling=["all", "all", "split"], split_frac=0.3)
    assert_same_task(jtl(data["times"], seed_override=1), tl(data["times"], seed_override=1))
    jtl, tl = pair(data)
    for loader in (jtl, tl):
        with pytest.raises(ValueError, match="split"):
            loader(data["times"][:1], target_sampling="split")


@pytest.mark.parametrize("delta_t", [[-1, 0, 0], [0, 1, -1], [2, 0, 1]], ids=str)
def test_delta_t_matches_jax(data, path, delta_t):
    jtl, tl = pair(data, delta_t=delta_t)
    before = taskpack.call_counts()["pack_station_batches"]
    assert_same_task(jtl(data["times"]), tl(data["times"]))
    check_path(path, before)


@pytest.mark.parametrize("sampling", ["all", 0.5])
def test_aux_at_contexts_matches_jax(data, sampling):
    out = data["out"]
    jtl, tl = pair(data, aux_at_contexts=out["highres_aux_ds"],
                   context_sampling=["all", "all", sampling])
    task = tl(data["times"], seed_override=2)
    assert_same_task(jtl(data["times"], seed_override=2), task)
    assert tl.context_dims() == jtl.context_dims()
    assert task.points[0].y.shape[-1] == 1 + len(out["highres_aux_ds"])


def _with_nans(df: pd.DataFrame, rows) -> pd.DataFrame:
    bad = df.copy()
    col = [c for c in bad.columns if c.endswith("_station")][0]
    bad.loc[bad.index[rows], col] = np.nan
    return bad


@pytest.mark.parametrize("sampling", ["all", 0.6])
def test_nan_rows_dropped_like_jax(data, path, sampling):
    st = data["out"]["station_df"]
    first = np.nonzero((st["time"] == st["time"].iloc[0]).to_numpy())[0]
    bad = _with_nans(st, list(first[:3]) + [len(st) - 1])
    jtl, tl = pair(data, context=[data["out"]["base_ds"], data["out"]["aux_ds"], bad],
                   target=bad, context_sampling=["all", "all", sampling])
    times = data["times"]
    task = tl(times, seed_override=4)
    assert_same_task(jtl(times, seed_override=4), task)
    clean = pair(data)[1](times[:1])
    if sampling == "all":
        assert task.points[0].mask[0].sum() == clean.points[0].mask[0].sum() - 3
    assert task.yt_mask[0].sum() == clean.yt_mask[0].sum() - 3
    assert torch.isfinite(task.yt).all() and torch.isfinite(task.points[0].y).all()


@pytest.mark.parametrize("offset_h", [14, 3])
def test_daily_frame_snaps_hourly_queries(data, path, offset_h):
    jtl, tl = pair(data)
    t0 = np.datetime64(data["times"][1], "s")
    queries = [t0 + np.timedelta64(offset_h, "h"), t0 + np.timedelta64(1, "D")]
    with warnings.catch_warnings(record=True) as jrec:
        warnings.simplefilter("always")
        jtask = jtl(queries)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        task = tl(queries)
    assert_same_task(jtask, task)
    assert any("resolution" in str(r.message) for r in rec)
    assert len(rec) == len(jrec)
    assert float(task.yt_mask[0].sum()) > 0
    # a day the frame does not have at all stays empty
    far = [t0 + np.timedelta64(3650, "D")]
    empty = tl(far)
    assert_same_task(jtl(far), empty)
    assert float(empty.yt_mask.sum()) == 0


def test_seed_for_keeps_the_date_unit():
    for date in (np.datetime64("2000-01-02"), np.datetime64("2000-01-02T00:00:00"),
                 np.datetime64("2000-01-02T00:00")):
        assert TaskLoader._seed_for(date, None, True) == JTaskLoader._seed_for(date, None, True)
    assert TaskLoader._seed_for(np.datetime64("2000-01-02"), None, True) != \
        TaskLoader._seed_for(np.datetime64("2000-01-02T00:00:00"), None, True)
    assert TaskLoader._seed_for("x", 5, True) == 5
    assert TaskLoader._seed_for("x", None, False) is None


def test_swap_data_matches_jax_and_restores(data, path):
    out = data["out"]
    jtl, tl = pair(data)
    times = data["times"][:3]
    st = out["station_df"]
    sub = st[st["station_id"].isin(sorted(st["station_id"].unique())[:5])]
    before = tl(times, seed_override=3)
    saved = (tl.context_var_IDs, tl.target_var_IDs, tl.x1g.copy(), tl.x2g.copy(),
             tl.point_capacity, tl.target_capacity)
    ctx = [out["base_ds"], out["aux_ds"], sub]
    with jtl.swap_data(context=ctx, target=sub), \
            tl.swap_data(context=[to_port(c) for c in ctx], target=to_port(sub)) as swapped:
        assert swapped is tl
        task = tl(times, seed_override=3)
        assert_same_task(jtl(times, seed_override=3), task)
        assert task.points[0].mask.sum() < before.points[0].mask.sum()
        assert (tl.point_capacity, tl.target_capacity) == saved[4:]
    assert (tl.context_var_IDs, tl.target_var_IDs) == saved[:2]
    np.testing.assert_array_equal(tl.x1g, saved[2])
    np.testing.assert_array_equal(tl.x2g, saved[3])
    assert_same_task(jtl(times, seed_override=3), tl(times, seed_override=3))
    assert_same_task(before, tl(times, seed_override=3))


def test_swap_data_accepts_pandas_frames(data):
    out = data["out"]
    jtl, tl = pair(data)
    st = out["station_df"].iloc[:20]
    ctx = [out["base_ds"], out["aux_ds"], st]
    with jtl.swap_data(context=ctx, target=st), \
            tl.swap_data(context=[to_port(c) for c in ctx[:2]] + [st], target=st):
        assert isinstance(tl.target, StationFrame)
        assert_same_task(jtl(data["times"]), tl(data["times"]))


def test_swap_data_restores_on_exception(data):
    out = data["out"]
    jtl, tl = pair(data)
    times = data["times"][1:3]
    before = tl(times, seed_override=5)
    with pytest.raises(RuntimeError, match="boom"):
        with tl.swap_data(context=[tl.context[0], tl.context[1],
                                   to_port(out["station_df"].iloc[:4])]):
            raise RuntimeError("boom")
    assert_same_task(before, tl(times, seed_override=5))
    assert_same_task(jtl(times, seed_override=5), tl(times, seed_override=5))
    with pytest.raises(ValueError, match="sets"):
        with tl.swap_data(context=[tl.context[0]]):
            pass


def test_capacities_never_shrink(data):
    out = data["out"]
    jtl, tl = pair(data)
    cap = (tl.point_capacity, tl.target_capacity)
    assert cap == (jtl.point_capacity, jtl.target_capacity) and cap[0] > 8
    few = out["station_df"].iloc[:3]
    for loader, conv in ((jtl, lambda e: e), (tl, to_port)):
        with loader.swap_data(context=[conv(out["base_ds"]), conv(out["aux_ds"]), conv(few)],
                              target=conv(few)):
            assert (loader.point_capacity, loader.target_capacity) == cap
        loader._rebuild_static()
        assert (loader.point_capacity, loader.target_capacity) == cap
    # an explicit capacity above the data's survives a rebuild too
    for loader in pair(data, point_capacity=64, target_capacity=48):
        loader._rebuild_static()
        assert (loader.point_capacity, loader.target_capacity) == (64, 48)


def test_explicit_capacity_pads_like_jax(data, path):
    jtl, tl = pair(data, point_capacity=64, target_capacity=48)
    assert_same_task(jtl(data["times"]), tl(data["times"]))


def test_flat_cache_is_checked_by_identity(data):
    out = data["out"]
    jtl, tl = pair(data)
    times = data["times"][:1]
    ref = tl(times)
    col = [c for c in out["station_df"].columns if c.endswith("_station")][0]
    shifted = out["station_df"].copy()
    shifted[col] = shifted[col] + 5.0
    tl.target = to_port(shifted)
    tl.context = tl.context[:2] + [tl.target]
    task = tl(times)
    m = task.yt_mask[0].bool()
    np.testing.assert_allclose((task.yt[0][m] - ref.yt[0][m]).numpy(), 5.0, atol=1e-5)
    tl._rebuild_static()
    assert tl._flat_cache == {}


def test_port_pickle_round_trip(data, tmp_path, path):
    jtl, tl = pair(data)
    times = data["times"]
    tl(times)  # fills the fast path's cache
    blob = pickle.dumps(tl)
    assert b"_flat_cache" not in blob and b"pandas" not in blob
    p = tmp_path / "task_loader.pkl"
    p.write_bytes(blob)
    back = load_task_loader(str(p))
    assert back._flat_cache == {}
    assert_same_task(tl(times, seed_override=1), back(times, seed_override=1))
    assert_same_task(jtl(times, seed_override=1), back(times, seed_override=1))


def test_jax_pickle_loads_into_the_port(data, tmp_path, path):
    jtl = data["jtl"]
    jtl(data["times"])  # a JAX pickle may hold its fast path's cache
    p = tmp_path / "task_loader.pkl"
    with open(p, "wb") as f:
        pickle.dump(jtl, f)
    tl = load_task_loader(str(p))
    assert isinstance(tl, TaskLoader) and tl._flat_cache == {}
    assert isinstance(tl.target, StationFrame)
    assert all(type(c).__module__.startswith("deepsensornz_tpu_torch") for c in tl.context)
    for kw in ({}, {"seed_override": 42}):
        assert_same_task(jtl(data["times"], **kw), tl(data["times"], **kw))
    p.write_bytes(pickle.dumps({"a": 1}))
    with pytest.raises(TypeError, match="not a TaskLoader"):
        load_task_loader(str(p))


@pytest.mark.parametrize("n_rows", [0, 1, 7, 10, 55, 512])
@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_sample_rows_reproduces_dataframe_sample(n_rows, seed):
    df = pd.DataFrame({"a": np.arange(n_rows)})
    for frac in (0.0, 0.25, 0.5, 0.3, 1.0, 0.123456):
        want = df.sample(frac=frac, random_state=np.int64(seed))["a"].to_numpy()
        np.testing.assert_array_equal(sample_rows(n_rows, np.int64(seed), frac=frac), want)
    for n in {0, min(1, n_rows), min(3, n_rows), n_rows}:  # the loader's min(k, len)
        want = df.sample(n=n, random_state=np.int64(seed))["a"].to_numpy()
        np.testing.assert_array_equal(sample_rows(n_rows, np.int64(seed), n=n), want)


def test_station_frame_against_pandas(data):
    st = data["out"]["station_df"].copy()
    st["flag"] = st["x1"] > 0.5  # bool: not a value column
    st["count"] = np.arange(len(st), dtype=np.int32)
    sf = StationFrame.from_pandas(st)
    assert sf.columns == list(st.columns) and len(sf) == len(st)
    assert sf["time"].dtype == np.dtype("datetime64[s]")
    for c in st.columns:
        if c != "time":
            assert sf[c].dtype == st[c].dtype
    assert frame_value_cols(sf) == [c for c in st.columns if c in ("dry_bulb_station", "count")]
    assert sf.max_rows_per_time() == int(st.groupby("time").size().max())
    idx = [5, 0, 3]
    np.testing.assert_array_equal(sf.take(idx)["x1"], st.iloc[idx]["x1"].to_numpy())
    cols = ["x1", "count", "dry_bulb_station"]
    got = sf.to_numpy(cols)
    assert got.tobytes() == st[cols].to_numpy(np.float32).tobytes()
    assert sf.to_numpy([]).shape == (len(st), 0)
    with pytest.raises(ValueError, match="length"):
        StationFrame({"a": np.zeros(3), "b": np.zeros(4)})


_BUILD = """
import sys
from pathlib import Path
sys.path.insert(0, {repo!r})
from deepsensornz_tpu_torch.native import taskpack
taskpack.BUILD_DIR = Path({build!r})
ok = taskpack.available()
import numpy as np
out = taskpack.interp_grid_points_native(np.ones((2, 2), np.float32), np.arange(2.0),
                                         np.arange(2.0), np.array([0.5]), np.array([0.5]))
print(ok, float(out[0]) if out is not None else None, taskpack.build_error())
"""


def test_parallel_taskpack_builds_all_load(tmp_path):
    """Processes that build the library at once all load a whole one."""
    code = _BUILD.format(repo=str(REPO), build=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr
        assert stdout.split() == ["True", "1.0", "None"], stdout + stderr
    assert [f.name for f in tmp_path.iterdir()] == [taskpack.library_path().name]


def test_taskpack_build_failure_is_reported(tmp_path, monkeypatch):
    monkeypatch.setattr(taskpack, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(taskpack, "_LIB", None)
    monkeypatch.setattr(taskpack, "_ERROR", None)
    assert not taskpack.available()
    assert "missing.cpp" in taskpack.build_error()
    assert taskpack.pack_station_batches(np.zeros(0, "datetime64[s]"), np.zeros(0),
                                         np.zeros(0), np.zeros((0, 1)),
                                         np.zeros(1, "datetime64[s]"), 8) is None


def test_taskpack_matches_jax_binding(jax_native):
    rng = np.random.default_rng(0)
    t = np.datetime64("2000-01-01T00", "s") + rng.integers(0, 4, 200) * np.timedelta64(1, "h")
    x1, x2 = rng.random(200).astype(np.float32), rng.random(200).astype(np.float32)
    v = rng.normal(size=(200, 2)).astype(np.float32)
    dates = np.datetime64("2000-01-01T00", "s") + np.arange(5) * np.timedelta64(1, "h")
    for a, b in zip(jtaskpack.pack_station_batches(t, x1, x2, v, dates, 80),
                    taskpack.pack_station_batches(t, x1, x2, v, dates, 80)):
        assert a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="capacity"):
        taskpack.pack_station_batches(t, x1, x2, v, dates, 8)
    grid = rng.normal(size=(6, 7)).astype(np.float32)
    g1, g2 = np.linspace(0, 1, 6), np.linspace(0, 1, 7)
    p1, p2 = rng.random(50) * 1.4 - 0.2, rng.random(50) * 1.4 - 0.2
    assert jtaskpack.interp_grid_points_native(grid, g1, g2, p1, p2).tobytes() == \
        taskpack.interp_grid_points_native(grid, g1, g2, p1, p2).tobytes()
