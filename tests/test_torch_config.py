"""The port's config loader, config files and registries against the JAX
package's: every config file loads to the same dict in both packages
(``_base_`` chains and ``{{$CRA5_ERA5_ROOT:...}}`` substitution included),
the lazy-import mode reads the same namespace, and the port's registries
hold the JAX package's names less those listed as not ported yet. Exact
equality throughout: a config is data, not arithmetic."""

import os
from pathlib import Path

import pytest
import torch

import cra5_tpu.registry as j_registry
from cra5_tpu.utils.config import Config as JConfig
from cra5_tpu.utils.config import LazyObject as JLazyObject
from cra5_tpu_torch import registry
from cra5_tpu_torch.api.cra5_api import cra5_api
from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_tiny
from cra5_tpu_torch.utils.config import Config, ConfigDict, LazyObject

ROOT = Path(__file__).resolve().parents[1]
J_CONFIGS = ROOT / "cra5_tpu" / "api" / "configs"
T_CONFIGS = ROOT / "cra5_tpu_torch" / "api" / "configs"
NAMES = ["cra5_268v.py", "era5_cds.py", "train_era5_base.py", "train_era5_268v_1h.py",
         "train_era5_159v_1h.py"]


def _plain(x):
    """Config values as plain containers (ConfigDict is a dict subclass in
    each package; LazyObject by its dotted path)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, (LazyObject, JLazyObject)):
        return ("lazy", x.dotted)
    return x


@pytest.mark.parametrize("env_root", [None, "/srv/era5"])
@pytest.mark.parametrize("name", NAMES)
def test_every_config_file_loads_as_in_jax(monkeypatch, name, env_root):
    """Each port config file gives the JAX file's dict, with and without
    CRA5_ERA5_ROOT set (the substitution and the _base_ chain resolve
    alike)."""
    if env_root is None:
        monkeypatch.delenv("CRA5_ERA5_ROOT", raising=False)
    else:
        monkeypatch.setenv("CRA5_ERA5_ROOT", env_root)
    got = Config.fromfile(str(T_CONFIGS / name)).to_dict()
    want = JConfig.fromfile(str(J_CONFIGS / name)).to_dict()
    assert _plain(got) == _plain(want)
    if name.startswith("train_era5"):
        assert got["dataset"]["root"] == (env_root or "/data/era5_np")
        assert got["mesh"] == {"dp": -1}


def test_config_files_stay_importable():
    """The port's config files are plain constants: each imports, and
    cra5_268v's constants are what Config.fromfile reads."""
    from cra5_tpu_torch.api.configs import cra5_268v, era5_cds, train_era5_base

    cfg = Config.fromfile(str(T_CONFIGS / "cra5_268v.py"))
    assert cfg.total_levels == cra5_268v.total_levels and cfg.vnames == cra5_268v.vnames
    assert train_era5_base.mesh == {"dp": -1} and era5_cds.grid == [0.25, 0.25]


def _write(path: Path, text: str) -> str:
    path.write_text(text)
    return str(path)


def test_base_chain_merge_delete_and_predefined_vars(tmp_path):
    """_base_ lists merge recursively (child wins), _delete_ replaces a
    base dict, {{fileDirname}} and {{$VAR:default}} substitute; both
    loaders agree."""
    _write(tmp_path / "a.py", "x = dict(a=1, b=dict(c=2, d=3))\nname = 'a'\n")
    _write(tmp_path / "b.py", "_base_ = './a.py'\nx = dict(b=dict(c=20))\nextra = [1, 2]\n")
    child = _write(tmp_path / "c.py",
                   "_base_ = ['./b.py']\nx = dict(b=dict(_delete_=True, e=5))\n"
                   "where = '{{fileDirname}}/{{fileBasenameNoExtension}}'\n"
                   "root = '{{$CRA5_TEST_UNSET_VAR:fallback}}'\n")
    got, want = Config.fromfile(child), JConfig.fromfile(child)
    assert _plain(got.to_dict()) == _plain(want.to_dict())
    assert got.x == {"a": 1, "b": {"e": 5}} and got.extra == [1, 2] and got.name == "a"
    assert got.where == f"{tmp_path}/c" and got.root == "fallback"
    assert isinstance(got.x, ConfigDict) and got.x.b.e == 5


def test_lazy_import_mode_reads_the_same_namespace(tmp_path):
    """A config with a `with read_base():` block is lazy: its imports are
    LazyObjects (nothing imported at load), read_base inherits by path,
    and both packages read the same names, the same dotted paths and the
    same pretty_text."""
    (tmp_path / "sub").mkdir()
    _write(tmp_path / "sub" / "base.py", "import os.path\nlr = 1e-3\nmodel = dict(depth=2)\n")
    lazy = _write(tmp_path / "lazy.py",
                  "from cra5_tpu_torch.utils.config import read_base\n"
                  "with read_base():\n    from .sub.base import *\n"
                  "import numpy as np\nfrom json import dumps as jd\n"
                  "model = dict(type=np.float32, depth=model['depth'] + 1)\n")
    got, want = Config.fromfile(lazy), JConfig.fromfile(lazy)
    assert _plain(got.to_dict()) == _plain(want.to_dict())
    assert got.pretty_text == want.pretty_text
    assert isinstance(got.model.type, LazyObject) and got.model.type.dotted == "numpy.float32"
    assert got.model.depth == 3 and got.lr == 1e-3
    import json

    import numpy as np

    assert got.jd.build() is json.dumps and got.model.type.build() is np.float32
    assert got.os.path.build() is os.path
    # a mention of read_base in a string does not make a config lazy
    eager = _write(tmp_path / "eager.py", "note = 'read_base'\nx = 1\n")
    assert Config.fromfile(eager).x == 1


@pytest.mark.parametrize("name", ["MODELS", "DATASETS", "CRITERIONS", "OPTIMIZERS", "SCHEDULERS"])
def test_registries_hold_the_jax_names_less_the_queued_ones(name):
    """Each port registry holds every name of the JAX registry of the same
    name but those NOT_PORTED lists (none: every name is ported), and nothing
    else."""
    got = set(getattr(registry, name).keys())
    want = set(getattr(j_registry, name).keys())
    queued = set(registry.NOT_PORTED.get(name.lower(), ()))
    assert got | queued == want and not got & queued
    assert registry.NOT_PORTED == {"models": (), "datasets": ()}  # ScaleSpaceFlow is ported


def test_registries_build_the_ports_objects(tmp_path):
    model = registry.MODELS.build({"type": "VAEformer", "cfg": vaeformer_tiny()}, device="cpu")
    assert isinstance(model, VAEformer) and model.device.type == "cpu"
    ds = registry.DATASETS.build(dict(type="ERA5NpyDataset", root=str(tmp_path),
                                      vnames=dict(pressure=["z"], single=["t2m"]),
                                      pressure_level=[500.0], years=("2020-01-01", "2020-01-02")))
    assert len(ds) == 5 and ds.channel_names() == ["z500.0", "t2m"]
    tx = registry.OPTIMIZERS.build({"type": "net_aux", "learning_rate": 1e-3})
    assert tx.aux_lr == 1e-3 and tx.net_rate(0) == 1e-3
    assert registry.SCHEDULERS.get("WarmupCosineLR")(1.0, 10, 2)(0) == 0.0
    with pytest.raises(KeyError, match="NoSuchModel"):
        registry.MODELS.get("NoSuchModel")
    ssf = registry.MODELS.build({"type": "ScaleSpaceFlow", "planes": 8, "mid_planes": 8,
                                 "num_levels": 2}, device="cpu")
    assert ssf.planes == 8 and ssf.device.type == "cpu"
    zoo = registry.MODELS.build({"type": "ScaleHyperprior", "N": 8, "M": 12}, device="cpu")
    assert zoo.CODEC_KIND == "hyper" and zoo.device.type == "cpu"


def test_cra5_api_takes_a_config_file_or_a_mapping():
    """config= as a file path (as in the JAX package) and as a mapping give
    the same cfg, mean and std; the default is the bundled cra5_268v.py."""
    path = str(T_CONFIGS / "cra5_268v.py")
    by_path = cra5_api(config=path, model_version=-1, device="cpu")
    default = cra5_api(model_version=-1, device="cpu")
    by_map = cra5_api(config=dict(by_path.cfg), model_version=-1, device="cpu")
    want = JConfig.fromfile(str(J_CONFIGS / "cra5_268v.py")).to_dict()
    for api in (by_path, default, by_map):
        assert _plain(api.cfg) == _plain(want)
        assert torch.equal(torch.as_tensor(api.mean), torch.as_tensor(by_path.mean))
        assert torch.equal(torch.as_tensor(api.std), torch.as_tensor(by_path.std))
