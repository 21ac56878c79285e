"""The port's ``TaskCache`` and ``concat`` against the JAX package's.

Shards written by the JAX ``TaskCache`` load in the port as the port's
``TaskBatch`` of CPU tensors, and shards the port writes load in the JAX
``TaskCache``, leaf for leaf the same bytes as the loader's own task.
``iter_epochs`` visits the shards in the JAX order for the same seed, with
and without prefetching, and the prefetch thread's errors reach the
consumer.
"""

import json

import numpy as np
import pytest
import torch

from deepsensornz_tpu.data.processor import DataProcessor as JProcessor
from deepsensornz_tpu.data.synthetic import synthetic_bundle
from deepsensornz_tpu.task import batching as jbatching
from deepsensornz_tpu.task.cache import TaskCache as JTaskCache
from deepsensornz_tpu.task.loader import TaskLoader as JTaskLoader
from deepsensornz_tpu_torch.task import cache as cache_mod
from deepsensornz_tpu_torch.task.batching import concat
from deepsensornz_tpu_torch.task.cache import TaskCache, prefetch_iterator
from deepsensornz_tpu_torch.task.loader import TaskLoader
from deepsensornz_tpu_torch.task.task import GridContext, TaskBatch
from tests.test_torch_loader import assert_same_task, to_port


@pytest.fixture(scope="module")
def loaders():
    base, dem, stations = synthetic_bundle(n_times=8, base_hw=(16, 16), dem_hw=(32, 32),
                                           n_stations=10)
    dp = JProcessor()
    dp.set_coord_maps_from_extent(
        dem.coords["latitude"].min(), dem.coords["latitude"].max(),
        dem.coords["longitude"].min(), dem.coords["longitude"].max())
    args = dict(context=[dp(base, method="mean_std"), dp(stations, method="mean_std")],
                target=dp(stations),
                aux_at_targets=dp(dem.fillna(0.0).rename("elevation"), method="min_max"),
                internal_density=24)
    port = {k: ([to_port(c) for c in v] if k == "context" else to_port(v))
            for k, v in args.items()}
    return JTaskLoader(**args), TaskLoader(**port), list(base.coords["time"])


def _shard_files(cache) -> list[str]:
    return [p.split("/")[-1] for p in cache.shards()]


def test_jax_shards_load_in_the_port(loaders, tmp_path):
    jtl, _, times = loaders
    jcache = JTaskCache(str(tmp_path))
    assert jcache.build(jtl, times, shard_size=3) == 3
    cache = TaskCache(str(tmp_path))
    assert _shard_files(cache) == _shard_files(jcache)
    for i, path in enumerate(cache.shards()):
        task = cache.load_shard(path)
        assert isinstance(task, TaskBatch)
        assert_same_task(jtl(times[3 * i: 3 * i + 3]), task)
        assert_same_task(jcache.load_shard(path), task)


def test_port_shards_load_in_jax(loaders, tmp_path):
    jtl, tl, times = loaders
    cache = TaskCache(str(tmp_path))
    assert cache.build(tl, times, shard_size=5, seed_override=1) == 2
    jcache = JTaskCache(str(tmp_path))
    for i, path in enumerate(jcache.shards()):
        assert_same_task(jcache.load_shard(path), tl(times[5 * i: 5 * i + 5], seed_override=1))
        with open(path + ".json") as f:
            meta = json.load(f)
        assert meta["times"] == [str(t) for t in times[5 * i: 5 * i + 5]]
    # a task without targets' values and with a grid mask round-trips too
    task = tl(times[:2])
    g = task.grids[0]
    masked = TaskBatch(grids=(GridContext(g.x1, g.x2, g.y, torch.ones(g.y.shape[:3])),),
                       points=task.points, xt=task.xt, yt=None, yt_mask=task.yt_mask,
                       yt_aux=None, x1g=task.x1g, x2g=task.x2g)
    arrays, meta = cache_mod._flatten(masked)
    np.savez_compressed(tmp_path / "shard_00009.npz", **arrays)
    (tmp_path / "shard_00009.npz.json").write_text(json.dumps({**meta, "times": []}))
    back = jcache.load_shard(str(tmp_path / "shard_00009.npz"))
    assert back.yt is None and back.yt_aux is None
    assert_same_task(back, cache.load_shard(str(tmp_path / "shard_00009.npz")))
    np.testing.assert_array_equal(np.asarray(back.grids[0].mask), np.ones(g.y.shape[:3]))


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_iter_epochs_order_matches_jax(loaders, tmp_path, shuffle, prefetch):
    jtl, tl, times = loaders
    TaskCache(str(tmp_path)).build(tl, times, shard_size=2)
    got = list(TaskCache(str(tmp_path)).iter_epochs(3, shuffle=shuffle, seed=4,
                                                     prefetch=prefetch))
    want = list(JTaskCache(str(tmp_path)).iter_epochs(3, shuffle=shuffle, seed=4, prefetch=0))
    assert len(got) == len(want) == 12
    for a, b in zip(want, got):
        assert_same_task(a, b)
    assert len(list(TaskCache(str(tmp_path)))) == 4


def test_prefetch_iterator_order_and_errors():
    assert list(prefetch_iterator(iter(range(10)), depth=3)) == list(range(10))

    def boom():
        yield 1
        raise RuntimeError("shard corrupt")

    it = prefetch_iterator(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="shard corrupt"):
        next(it)


def test_concat_matches_jax(loaders):
    jtl, tl, times = loaders
    parts = [times[:2], times[2:5], times[5:6]]
    jtask = jbatching.concat([jtl(p) for p in parts])
    task = concat([tl(p) for p in parts])
    assert_same_task(jtask, task)
    assert_same_task(jtl(times[:6]), task)
