"""The port's netCDF files (``data.grid.save_dataset``/``open_dataset``,
the CF time codec, ``infer.writer``) against the JAX package's, on the CPU.

Files written by either package are read by the other and must read equal
to what the writer read back itself: every variable's dims, dtype and
values (bitwise, NaN where NaN), its coordinates (times to the second),
its attributes and the file's. Also the hyperslab time-window read, the
codec on other units and origins, and the error without h5py.
"""

import sys

import numpy as np
import pytest

from deepsensornz_tpu.data import grid as jgrid
from deepsensornz_tpu.infer import writer as jwriter
from deepsensornz_tpu_torch.data import grid as tgrid
from deepsensornz_tpu_torch.infer import writer as twriter

SIDES = {"jax": (jgrid, jwriter), "port": (tgrid, twriter)}


def _dataset(mod, rng, n_time=30):
    """A Dataset with a time axis, float64 with NaNs, float32, int32 and a
    static field, with scalar attributes of each kind."""
    t = np.datetime64("2001-03-01T00", "s") + np.arange(n_time) * np.timedelta64(1, "h")
    lat = np.linspace(-34.0, -47.0, 9)
    lon = np.linspace(166.0, 178.0, 11)
    a = 12 + 3 * rng.standard_normal((n_time, 9, 11))
    a[0, :2] = np.nan
    fields = {
        "t2m": mod.Field(a, ("time", "latitude", "longitude"),
                         {"time": t, "latitude": lat, "longitude": lon}, "t2m",
                         {"units": "degC", "level": 2, "scale": 0.5, "code": np.float32(1.5)}),
        "rh": mod.Field(rng.random((n_time, 9, 11)).astype(np.float32),
                        ("time", "latitude", "longitude"),
                        {"time": t, "latitude": lat, "longitude": lon}, "rh"),
        "count": mod.Field(rng.integers(0, 9, (n_time,)).astype(np.int32), ("time",),
                           {"time": t}, "count"),
        "elevation": mod.Field(rng.random((9, 11)) * 1000, ("latitude", "longitude"),
                               {"latitude": lat, "longitude": lon}, "elevation"),
    }
    return mod.Dataset(fields, attrs={"title": "fixture", "year": 2001, "version": 1.25})


def _assert_same(got, want):
    assert list(got.keys()) == list(want.keys())
    for name in want:
        g, w = got[name], want[name]
        assert g.dims == w.dims, name
        assert g.data.dtype == w.data.dtype, name
        np.testing.assert_array_equal(g.data, w.data, err_msg=name)
        assert set(g.coords) == set(w.coords), name
        for d in w.coords:
            assert g.coords[d].dtype == w.coords[d].dtype, (name, d)
            np.testing.assert_array_equal(g.coords[d], w.coords[d])
        assert g.attrs.keys() == w.attrs.keys(), name
        for k, v in w.attrs.items():
            assert g.attrs[k] == v and type(g.attrs[k]) is type(v), (name, k)
    assert got.attrs == want.attrs


@pytest.mark.parametrize("opts", [dict(float32=False), dict(float32=True),
                                  dict(compress=False, float32=False), dict(packing="int16")],
                         ids=["float64", "float32", "uncompressed", "int16"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_files_read_equal_on_the_other_side(tmp_path, rng, writer, reader, opts):
    wmod, rmod = SIDES[writer][0], SIDES[reader][0]
    path = str(tmp_path / "f.nc")
    wmod.save_dataset(_dataset(wmod, rng), path, **opts)
    _assert_same(rmod.open_dataset(path), wmod.open_dataset(path))
    sub = rmod.open_dataset(path, variables=["rh"])
    assert list(sub.keys()) == ["rh"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_field_and_a_dataset_write_the_same_values(tmp_path, rng, writer):
    """Both writers on the same data: the files read equal, and a Field is
    written as a one-variable Dataset."""
    jpath, tpath = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    jgrid.save_dataset(_dataset(jgrid, np.random.default_rng(3)), jpath, float32=False)
    tgrid.save_dataset(_dataset(tgrid, np.random.default_rng(3)), tpath, float32=False)
    _assert_same(tgrid.open_dataset(tpath), jgrid.open_dataset(jpath))
    mod = SIDES[writer][0]
    ds = _dataset(mod, rng)
    mod.save_dataset(ds["t2m"], str(tmp_path / "one.nc"), float32=False)
    back = tgrid.open_dataset(str(tmp_path / "one.nc"))
    assert list(back.keys()) == ["t2m"]
    np.testing.assert_array_equal(back["t2m"].data, ds["t2m"].data)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_time_window_reads_the_same_rows(tmp_path, rng, writer):
    path = str(tmp_path / "f.nc")
    SIDES[writer][0].save_dataset(_dataset(SIDES[writer][0], rng), path, float32=False)
    for window in [("2001-03-01T05", "2001-03-01T09"),
                   (np.datetime64("2001-03-01T20:30"), np.datetime64("2001-03-05")),
                   ("1990-01-01", "1990-02-01")]:
        got = tgrid.open_dataset(path, time_window=window)
        want = jgrid.open_dataset(path, time_window=window)
        _assert_same(got, want)
    assert got["t2m"].sizes()["time"] == 0 and got["elevation"].shape == (9, 11)
    five = tgrid.open_dataset(path, time_window=("2001-03-01T05", "2001-03-01T09"))
    assert five["t2m"].sizes()["time"] == 5 and five["count"].shape == (5,)


@pytest.mark.parametrize("units", ["seconds since 1970-01-01 00:00:00", "hours since 1900-01-01",
                                   "days since 2000-01-01T00:00:00Z",
                                   "minutes since 1999-12-31 12:00:00"])
def test_time_codec_matches_jax(units):
    values = np.array([0.0, 1.0, 36.0, 1e5, 7.5e5])
    np.testing.assert_array_equal(tgrid._decode_time(values, units),
                                  jgrid._decode_time(values, units))
    t = np.datetime64("1950-06-01T03:04:05", "s") + np.arange(5) * np.timedelta64(98765, "s")
    enc, u = tgrid._encode_time(t)
    want, wu = jgrid._encode_time(t)
    assert u == wu and enc.dtype == want.dtype
    np.testing.assert_array_equal(enc, want)
    np.testing.assert_array_equal(tgrid._decode_time(enc, u), t)


@pytest.mark.parametrize("kw", [dict(), dict(mean_only=True), dict(packing="int16")],
                         ids=["mean-std", "mean-only", "int16"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_predictions_read_equal_on_the_other_side(tmp_path, rng, writer, reader, kw):
    wgrid, wwriter = SIDES[writer]
    rgrid = SIDES[reader][0]
    t = np.datetime64("2020-01-01T00", "s") + np.arange(6) * np.timedelta64(1, "h")
    lat, lon = np.linspace(-34.0, -47.0, 13), np.linspace(166.0, 178.0, 12)
    coords = {"time": t, "latitude": lat, "longitude": lon}
    mean = (10 + rng.standard_normal((6, 13, 12))).astype(np.float32)
    mean[:, :3] = np.nan
    pred = wgrid.Dataset({
        "mean": wgrid.Field(mean, ("time", "latitude", "longitude"), coords, "mean",
                            {"variable": "temperature"}),
        "std": wgrid.Field(np.abs(mean), ("time", "latitude", "longitude"), coords, "std",
                           {"variable": "temperature"})})
    path = str(tmp_path / "out" / "temperature_2020_01.nc")
    wwriter.save_prediction(pred, path, "temperature", "m0", attrs={"year": 2020, "month": 1},
                            **kw)
    got, want = rgrid.open_dataset(path), wgrid.open_dataset(path)
    _assert_same(got, want)
    assert ("std" in got) == (not kw.get("mean_only"))
    for k, v in {"institution": "Bodeker Scientific", "variable": "temperature",
                 "model_name": "m0", "year": 2020, "month": 1}.items():
        assert got.attrs[k] == v
    assert set(got.attrs) == set(jwriter.standard_metadata({"variable": "x", "model_name": "",
                                                             "year": 0, "month": 0}))
    if kw.get("packing") == "int16":
        span = np.nanmax(mean) - np.nanmin(mean)
        np.testing.assert_allclose(got["mean"].data, mean, atol=span / 65533)
    else:
        np.testing.assert_array_equal(got["mean"].data, mean)


def test_standard_metadata_matches_jax():
    got = twriter.standard_metadata({"variable": "temperature", "institution": "x"})
    want = jwriter.standard_metadata({"variable": "temperature", "institution": "x"})
    assert got.keys() == want.keys()
    assert {k: got[k] for k in got if k != "created"} == {k: want[k] for k in want
                                                         if k != "created"}
    assert twriter.STANDARD_ATTRS == jwriter.STANDARD_ATTRS


def test_without_h5py_netcdf_raises(tmp_path, rng, monkeypatch):
    """The JAX package's own message; nothing is written in another format."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    path = tmp_path / "f.nc"
    with pytest.raises(RuntimeError, match="h5py unavailable; cannot write netCDF"):
        tgrid.save_dataset(_dataset(tgrid, rng), str(path))
    assert not path.exists()
    with pytest.raises(RuntimeError, match="h5py unavailable; cannot read netCDF"):
        tgrid.open_dataset(str(path))
