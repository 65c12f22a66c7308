"""The port's ERA5 data layer against the JAX package's, on small trees
written by ``ERA5NpyDataset.save_timestep``: dataset items and batches
bitwise equal (both are numpy arithmetic), ``PrefetchLoader`` order and
errors, every ``ERA5EvalDataset`` mode, the bilinear resize against
``jax.image.resize`` (its weights within 1e-6 of the jitted JAX weights,
equal where it upsamples; results within 2e-6 x max |ref|, float32
rounding of those weights and of the sums), ``ERA5NcDataset`` with
``xarray`` replaced by a stand-in, and the downloader with ``cdsapi``
replaced by a recorder (nothing is downloaded)."""

import sys
import types

import jax
import numpy as np
import pytest
import torch

import cra5_tpu.data as jdata
from cra5_tpu.api.downloader import era5_downloader as j_downloader
from cra5_tpu_torch import data as tdata
from cra5_tpu_torch.api.cra5_api import cra5_api
from cra5_tpu_torch.api.downloader import era5_downloader as t_downloader
from cra5_tpu_torch.data.era5 import _bilinear_weights

VNAMES = dict(pressure=["z", "t"], single=["t2m", "msl"])
LEVELS = [1000.0, 500.0, 50.0]
YEARS = ("2020-01-01T00:00:00", "2020-01-02T00:00:00")
HW = (9, 16)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Per-channel .npy files for every 6-hourly timestamp of YEARS plus
    the 12 hours a sequence may reach past its end, and mean/std."""
    root = str(tmp_path_factory.mktemp("era5_np"))
    ds = tdata.ERA5NpyDataset(root, VNAMES, LEVELS, (YEARS[0], "2020-01-02T12:00:00"))
    rng = np.random.default_rng(3)
    for ts in ds.timestamps:
        tdata.ERA5NpyDataset.save_timestep(
            root, ts, rng.standard_normal((ds.num_channels, *HW)).astype(np.float32) * 7,
            ds.channel_names())
    mean = rng.standard_normal(ds.num_channels).astype(np.float32)
    std = rng.random(ds.num_channels).astype(np.float32) + 0.5
    return root, mean, std


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    else:
        assert a == b


def test_timestamp_range_matches_jax():
    for args in ((*YEARS, 6), ("1998-05-04", "1998-05-06", 12), ("2018-01-01", "2018-01-01", 6)):
        assert tdata.timestamp_range(*args) == jdata.timestamp_range(*args)


@pytest.mark.parametrize("seq,norm,num", [({"input": [0], "gt": [0]}, False, None),
                                          ({"input": [0], "gt": [0, 6, 12]}, True, None),
                                          ({"input": [0, 6], "gt": [6]}, True, 3)])
def test_npy_dataset_items_equal_jax(tree, seq, norm, num):
    root, mean, std = tree
    kw = dict(time_interval=6, sequence_cfg=seq, num_samples=num,
              mean=mean if norm else None, std=std if norm else None)
    got = tdata.ERA5NpyDataset(root, VNAMES, LEVELS, YEARS, **kw)
    want = jdata.ERA5NpyDataset(root, VNAMES, LEVELS, YEARS, **kw)
    assert len(got) == len(want) > 0 and got.timestamps == want.timestamps
    assert got.channel_names() == want.channel_names() and got.num_channels == 8
    for i in range(len(got)):
        _equal(got[i], want[i])


@pytest.mark.parametrize("shuffle,drop_last,epochs,bs", [(False, True, 1, 2), (True, True, 2, 2),
                                                         (True, False, 1, 3), (True, True, 3, 1)])
def test_batch_iterator_equals_jax(tree, shuffle, drop_last, epochs, bs):
    root, mean, std = tree
    ds = tdata.ERA5NpyDataset(root, VNAMES, LEVELS, YEARS, mean=mean, std=std)
    kw = dict(shuffle=shuffle, seed=5, drop_last=drop_last, epochs=epochs)
    got = list(tdata.batch_iterator(ds, bs, **kw))
    want = list(jdata.batch_iterator(ds, bs, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _equal(a, b)


def test_prefetch_loader_keeps_order_moves_batches_and_raises_the_producers_error():
    batches = [np.full((1, 2, 3, 3), i, np.float32) for i in range(7)]
    out = list(tdata.PrefetchLoader(iter(batches), depth=2, to_device=tdata.device_put("cpu")))
    assert [int(b[0, 0, 0, 0]) for b in out] == list(range(7))
    assert all(isinstance(b, torch.Tensor) and b.device.type == "cpu" for b in out)
    assert [int(b[0, 0, 0, 0]) for b in tdata.PrefetchLoader(iter(batches))] == list(range(7))

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    it = iter(tdata.PrefetchLoader(broken()))
    assert int(next(it)[0, 0, 0, 0]) == 0
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_device_put_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdata.device_put()


@pytest.mark.parametrize("shape,hw", [((2, 181, 360), (721, 1440)), ((2, 721, 1440), (181, 360)),
                                      ((3, 37, 50), (19, 80)), ((1, 5, 7), (5, 3))])
def test_resize_bilinear_is_jax_image_resize(shape, hw):
    """The port's resize has the jitted jax.image.resize's weights (the
    sample positions rounded once, as XLA's fused multiply-add gives them)
    and agrees with its result within float32 rounding; F.interpolate's
    bilinear agrees where it upsamples, but not where it downsamples
    (no antialiasing there)."""
    from jax._src.image import scale as jscale

    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = tdata.resize_bilinear(x, hw)
    want = np.asarray(jax.image.resize(x, (*shape[:-2], *hw), method="bilinear"))
    scale = np.abs(want).max()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-6 * scale
    weights = []
    for n_in, n_out in zip(shape[-2:], hw):
        jw = np.asarray(jax.jit(lambda: jscale.compute_weight_mat(
            n_in, n_out, n_out / n_in, 0.0, jscale._fill_triangle_kernel, True))())
        w = _bilinear_weights(n_in, n_out)
        assert np.abs(w - jw).max() <= (0.0 if n_out >= n_in else 1e-6)
        weights.append(w.astype(np.float64))
    exact = np.einsum("cHw,wW->cHW", np.einsum("chw,hH->cHw", x.astype(np.float64), weights[0]),
                      weights[1])
    assert np.abs(got - exact).max() <= 1e-6 * scale
    interp = torch.nn.functional.interpolate(torch.from_numpy(x)[None], size=hw,
                                             mode="bilinear", align_corners=False)[0].numpy()
    if any(o < i for i, o in zip(shape[-2:], hw)):
        assert np.abs(interp - want).max() > 1e-3 * scale
    else:
        assert np.abs(interp - want).max() <= 2e-6 * scale


@pytest.fixture(scope="module")
def eval_roots(tree, tmp_path_factory):
    """Forecast runs, AI-model forecasts (on a coarser grid, for the
    interpolating mode) and day-of-year climate means for the eval modes,
    written with the JAX package's writers and read by both."""
    root, _, _ = tree
    base = tmp_path_factory.mktemp("preds")
    rng = np.random.default_rng(4)
    ds = jdata.ERA5NpyDataset(root, VNAMES, LEVELS, YEARS)
    C = ds.num_channels
    runs, ai, clim = str(base / "runs"), str(base / "ai"), str(base / "clim")
    for ts in ds.timestamps:
        jdata.ERA5EvalDataset.save_prediction_run(
            runs, ts, [rng.standard_normal((C, *HW)).astype(np.float32) for _ in range(6)])
        for h in (0, 6, 12):
            valid = ds._offset_ts(ts, h)
            jdata.ERA5EvalDataset.save_aimodel_forecast(
                ai, ts, valid, rng.standard_normal((C, 5, 8)).astype(np.float32))
    for md in ("01-01", "01-02", "01-03"):
        jdata.ERA5EvalDataset.save_climate_mean(
            clim, md, rng.standard_normal((C, *HW)).astype(np.float32), ds.channel_names())
    return root, runs, ai, clim


@pytest.mark.parametrize("mode,pred", [("default", None), ("ensemble", "runs"), ("hres", "runs"),
                                       ("aimodel", "ai"), ("aimodel_interp", "ai")])
def test_eval_dataset_modes_equal_jax(tree, eval_roots, mode, pred):
    """Every mode's items as the JAX package's: bitwise, but the resized
    predictions of aimodel_interp, within the resize's bound."""
    _, mean, std = tree
    root, runs, ai, clim = eval_roots
    kw = dict(time_interval=6, sequence_cfg={"input": [0], "gt": [0, 6]}, mean=mean, std=std,
              test_mode=mode, pred_root={"runs": runs, "ai": ai, None: None}[pred],
              climate_root=clim)
    got = tdata.ERA5EvalDataset(root, VNAMES, LEVELS, YEARS, **kw)
    want = jdata.ERA5EvalDataset(root, VNAMES, LEVELS, YEARS, **kw)
    assert len(got) == len(want) > 0
    for i in (0, len(got) - 1):
        a, b = got[i], want[i]
        if mode == "aimodel_interp":
            for k in ("pred_label", "input"):
                assert a[k].shape == b[k].shape
                assert np.abs(a[k] - b[k]).max() <= 2e-6 * np.abs(b[k]).max()
                a[k], b[k] = b[k], b[k]
        _equal(a, b)
    with pytest.raises(ValueError, match="requires pred_root"):
        tdata.ERA5EvalDataset(root, VNAMES, LEVELS, YEARS, test_mode="hres")


class _FakeVar:
    def __init__(self, data):
        self.data = data


class _FakeDataset:
    """What read_data_from_nc reads of an xarray Dataset, made from the
    file name so both packages read the same numbers."""

    def __init__(self, path):
        rng = np.random.default_rng(sum(path.encode()))
        self.level = _FakeVar(np.array([1000.0, 850.0, 500.0, 50.0]))
        self._vars = {v: _FakeVar(rng.standard_normal((1, 4, 3, 4)).astype(np.float32))
                      for v in VNAMES["pressure"]}
        self._vars.update({v: _FakeVar(rng.standard_normal((1, 3, 4)).astype(np.float32))
                           for v in VNAMES["single"] + ["tp"]})

    def __getitem__(self, name):
        return self._vars[name]


def test_nc_dataset_equals_jax(monkeypatch):
    """ERA5NcDataset through a stand-in xarray (the real one reads NetCDF
    files this test does not have): the same items, normalized, in both
    packages."""
    fake = types.ModuleType("xarray")
    fake.open_dataset = lambda path, engine=None: _FakeDataset(path)
    monkeypatch.setitem(sys.modules, "xarray", fake)
    cfg = dict(vnames=dict(pressure=["z", "t"], single=["t2m", "tp"]),
               pressure_level=[500.0, 1000.0], total_levels=[1000.0, 500.0])
    stamps = ["2020-01-01T00:00:00", "2020-01-01T06:00:00"]
    for norm in (False, True):
        got = tdata.ERA5NcDataset(cfg, "/nowhere", stamps, normalize=norm)
        want = jdata.ERA5NcDataset(cfg, "/nowhere", stamps, normalize=norm)
        assert len(got) == len(want) == 2
        for i in range(2):
            _equal(got[i], want[i])


class _Result:
    def __init__(self, size, short):
        self.content_length, self._short = size, short

    def download(self, target):
        with open(target, "wb") as f:
            f.write(b"x" * (self.content_length - (1 if self._short else 0)))


@pytest.fixture
def fake_cdsapi(monkeypatch):
    """A cdsapi whose Client records its requests and writes files of the
    promised size (one short write first for a retry)."""
    calls = []

    class Client:
        def retrieve(self, dataset, req):
            calls.append((dataset, req))
            return _Result(100 + len(calls), short=len(calls) == 1)

    mod = types.ModuleType("cdsapi")
    mod.Client = Client
    monkeypatch.setitem(sys.modules, "cdsapi", mod)
    return calls


def test_downloader_requests_and_files_equal_jax(fake_cdsapi, tmp_path):
    ts = "2021-03-04T06:00:00"
    got = t_downloader().get_form_timestamp(ts, str(tmp_path / "t"))
    t_calls = list(fake_cdsapi)
    fake_cdsapi.clear()
    want = j_downloader().get_form_timestamp(ts, str(tmp_path / "j"))
    assert t_calls == fake_cdsapi and len(t_calls) == 3  # one retry after the short file
    assert [c[0] for c in t_calls] == ["reanalysis-era5-pressure-levels"] * 2 + [
        "reanalysis-era5-single-levels"]
    assert t_calls[0][1]["date"] == "2021-03-04" and t_calls[0][1]["time"] == "06:00"
    assert {k: v.replace(str(tmp_path / "t"), "") for k, v in got.items()} == {
        k: v.replace(str(tmp_path / "j"), "") for k, v in want.items()}
    assert got[f"{ts}_single.nc"].endswith(f"ERA5/2021/{ts}_single.nc")


def test_downloader_without_cdsapi_raises_on_use(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cdsapi", None)
    dl = t_downloader()  # construction needs no cdsapi
    with pytest.raises(RuntimeError, match="cdsapi is not installed"):
        dl.save("2021-03-04T06:00:00", str(tmp_path))


def test_api_download_era5_data_goes_through_the_downloader(fake_cdsapi, tmp_path):
    api = cra5_api(model_version=-1, device="cpu", local_root=str(tmp_path))
    paths = api.download_era5_data("2022-07-01T12:00:00")
    assert sorted(paths) == ["2022-07-01T12:00:00_pressure.nc", "2022-07-01T12:00:00_single.nc"]
    assert all(p.startswith(str(tmp_path)) for p in paths.values())


def test_prefetch_loader_releases_its_batches_when_the_consumer_stops():
    """A consumer that stops early (Trainer.fit after num_steps) and drops
    its iterator: the producer thread ends and no batch it loaded ahead
    stays alive (on the card those are whole timesteps)."""
    import gc
    import threading
    import time
    import weakref

    class Batch:
        pass

    made = []

    def endless():
        while True:
            b = Batch()
            made.append(weakref.ref(b))
            yield b

    before = threading.active_count()
    it = iter(tdata.PrefetchLoader(endless(), depth=2))
    first = next(it)
    time.sleep(0.2)  # the producer fills the queue and blocks
    assert len(made) >= 3
    del it
    gc.collect()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    gc.collect()
    assert [r for r in made if r() is not None and r() is not first] == []
