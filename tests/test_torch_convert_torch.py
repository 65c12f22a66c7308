"""Port vs JAX: the reference ``.pth`` converter (``tools/convert_torch.py``).

The reference state dicts are built here without the reference code: the
flax params of the JAX package's ``vaeformer_tiny`` (a seeded init plus
seeded noise, so that the hyperprior's scales spread over the scale
table; ``tiny_flax_params``) go through an inverse of the converter's
layout map written in this file (``reference_state_dict``), and that
inverse is held first: JAX's own
``convert_vaeformer_state_dict`` must give the flax params back exactly.
The port's conversion must then equal ``convert.from_flax_params`` of
JAX's conversion bit for bit, its CDF tables JAX's, and the two packages'
tiny models on those weights give float32 symbols exactly and x_hat within
ATOL (the tolerance of ``test_torch_api.py``). The other test files of
the slice build their ``.pth`` files with ``tiny_pth``."""

import hashlib
import json
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from cra5_tpu.entropy import eb_update as j_eb_update
from cra5_tpu.entropy import gc_update as j_gc_update
from cra5_tpu.entropy import get_scale_table as j_get_scale_table
from cra5_tpu.entropy.entropy_bottleneck import eb_params_from_variables
from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu.tools import convert_torch as jct
from cra5_tpu_torch import convert
from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_tiny
from cra5_tpu_torch.tools import convert_torch as tct
from cra5_tpu_torch.utils import msgpack

ATOL = 1e-5
NOISE = 0.2  # on the seeded init: GC indexes 0..24 of the default table on TS's field
ST48 = j_get_scale_table(levels=48)  # a non-default scale table, so the install shows
CDF_KEYS = ("_quantized_cdf", "_cdf_length", "_offset")


# ---------------------------------------------------------------- helpers
def tiny_flax_params(seed: int = 0):
    """The tiny model's seeded init plus NOISE x N(0, 1), float32, as the
    flax params tree of the JAX package's ``vaeformer_tiny``. The init is
    the port's (``reset_parameters(0)``, the same distributions) laid out
    by ``convert.to_flax_params``, because JAX's own init compiles for
    ~15 s in every process that builds a .pth; its tree and every leaf's
    shape are held against JAX's (``jax.eval_shape`` of its init)."""
    cfg = j_tiny()
    want = jax.eval_shape(JVAEformer(cfg).init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, cfg.in_chans, *cfg.img_size), jnp.float32))
    model = VAEformer(vaeformer_tiny(), device="cpu").reset_parameters(0)
    params = convert.to_flax_params(model, dict(model.named_parameters()))
    shapes = {k: v.shape for k, v in _flat(params).items()}
    assert shapes == {k: v.shape for k, v in _flat(want["params"]).items()}
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + NOISE * rng.standard_normal(a.shape)).astype(np.float32), params)


def reference_state_dict(params) -> dict:
    """Flax params -> the reference's state dict (torch tensors): the
    inverse of the converter's layouts, written independently of it."""
    sd = {}

    def name(kind):
        return {"kernel": "weight", "scale": "weight", "bias": "bias"}[kind]

    def put(tower, p, v):
        if tower in ("quant_conv", "post_quant_conv"):
            sd[f"{tower}.{name(p[0])}"] = v.transpose(3, 2, 0, 1) if p[0] == "kernel" else v
        elif tower == "entropy_bottleneck":
            sd[f"{tower}.{p[0] if p[0] == 'quantiles' else '_' + p[0]}"] = v
        elif p == ("pos_embed",):
            sd[f"{tower}.pos_embed"] = v
        elif p[0] == "patch_embed":  # HWIO -> OIHW
            sd[f"{tower}.patch_embed.proj.{name(p[2])}"] = (
                v.transpose(3, 2, 0, 1) if p[2] == "kernel" else v)
        elif p[:2] == ("final", "final"):  # flax's flipped (kh, kw, in, out) -> (in, out, kh, kw)
            sd[f"{tower}.final.{name(p[2])}"] = (
                v[::-1, ::-1].transpose(2, 3, 0, 1) if p[2] == "kernel" else v)
        elif p[0] in ("final", "norm", "quan_mlp", "post_quan_mlp") or p[0].startswith("blocks_"):
            head = re.sub(r"^blocks_(\d+)$", r"blocks.\1", p[0])
            sd[".".join((tower, head, *p[1:-1], name(p[-1])))] = v.T if p[-1] == "kernel" else v
        else:
            raise KeyError((tower, p))

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                put(path[0], path[1:] + (k,), np.asarray(v))

    walk(params, ())
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def with_tables(sd: dict, eb, gc, scale_table) -> dict:
    """The state dict with the CDF buffers a trained reference model holds."""
    sd = dict(sd)
    for prefix, t in (("entropy_bottleneck", eb), ("gaussian_conditional", gc)):
        for key, arr in zip(CDF_KEYS, (t.quantized_cdf, t.cdf_length, t.offset)):
            sd[f"{prefix}.{key}"] = torch.from_numpy(np.asarray(arr, np.int32))
    sd["gaussian_conditional.scale_table"] = torch.from_numpy(np.asarray(scale_table, np.float32))
    return sd


def tiny_pth(path, scale_table=ST48, seed: int = 0):
    """A tiny reference .pth with trained-style tables: the EB table of its
    own EB params, the GC table of ``scale_table``. Returns (path, flax
    params, JAX's tables)."""
    params = tiny_flax_params(seed)
    tables = {"eb": j_eb_update(eb_params_from_variables({"params": params},
                                                         "entropy_bottleneck")),
              "gc": j_gc_update(scale_table), "scale_table": np.asarray(scale_table, np.float32)}
    sd = with_tables(reference_state_dict(params), tables["eb"], tables["gc"], scale_table)
    torch.save(sd, str(path))
    return str(path), params, tables


def _flat(tree):
    return {"/".join(str(k.key) for k in p): v if isinstance(v, jax.ShapeDtypeStruct)
            else np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


def _assert_tables_equal(got, want):
    assert set(got) == set(want)
    for k, t in want.items():
        if k == "scale_table":
            assert got[k].dtype == t.dtype and np.array_equal(got[k], t)
        else:
            for f in ("quantized_cdf", "cdf_length", "offset"):
                a, b = getattr(got[k], f), getattr(t, f)
                assert a.dtype == b.dtype and np.array_equal(a, b), (k, f)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path, params, tables = tiny_pth(tmp_path_factory.mktemp("pth") / "tiny.pth")
    return path, params, tables


# ---------------------------------------------------------------- manifest
def test_manifest_copy_is_byte_identical_and_fingerprinted():
    with open(jct.__file__.replace("convert_torch.py", "assets/cra5_268v_state_manifest.json"),
              "rb") as f:
        want = f.read()
    with open(tct.MANIFEST, "rb") as f:
        got = f.read()
    assert got == want
    m = json.loads(got)
    blob = json.dumps(sorted((k, tuple(s)) for k, s in m["keys"].items()), default=list).encode()
    assert hashlib.sha256(blob).hexdigest() == m["fingerprint_sha256"]
    assert m["n_keys"] == len(m["keys"]) == 447


def _manifest_case(case: str) -> dict:
    with open(tct.MANIFEST) as f:
        keys = json.load(f)["keys"]
    fake = {k: SimpleNamespace(shape=tuple(v)) for k, v in keys.items()}
    if case == "broken":
        fake.pop("quant_conv.weight")
        fake["not_a_key"] = SimpleNamespace(shape=(1,))
        fake["post_quant_conv.weight"] = SimpleNamespace(shape=(1, 2, 3, 4))
        fake["epoch"] = 7  # no shape: reported, not a crash
    elif case == "unrenamed":
        plural = {"bias": "biases", "matrix": "matrices", "factor": "factors"}
        fake = {"module." + re.sub(r"entropy_bottleneck\._(bias|matrix|factor)(\d+)$",
                                   lambda g: f"entropy_bottleneck._{plural[g.group(1)]}."
                                             f"{g.group(2)}", k): v for k, v in fake.items()}
        assert any("._biases." in k for k in fake)
    return fake


@pytest.mark.parametrize("case", ["exact", "broken", "unrenamed"])
def test_verify_268_manifest_reports_as_jax(case):
    sd = _manifest_case(case)
    got, want = tct.verify_268_manifest(sd), jct.verify_268_manifest(sd)
    assert got == want
    if case == "broken":
        assert got == {"missing": ["quant_conv.weight"], "extra": ["not_a_key"],
                       "shape_mismatch": ["post_quant_conv.weight"]}
    else:
        assert got == {"missing": [], "extra": [], "shape_mismatch": []}


def test_rename_key_as_jax():
    for k in ("module.model.g_a.blocks.3.attn.qkv.weight", "model.h_s.final.weight",
              "module.entropy_bottleneck._biases.4", "entropy_bottleneck._matrices.0",
              "entropy_bottleneck._factors.12", "g_a.layer.downsample.conv.weight",
              "quant_conv.bias"):
        assert tct.rename_key(k) == jct.rename_key(k)


# ---------------------------------------------------------------- the tiny dict
def test_inverse_map_round_trips_through_jax(tiny):
    """The test's inverse is held first: JAX's converter gives the flax
    params back exactly, and the tables ride along."""
    path, params, tables = tiny
    variables, got_tables = jct.convert_vaeformer_state_dict(torch.load(path), 4)
    _assert_trees_equal(variables["params"], params)
    _assert_tables_equal(got_tables, tables)


def test_tiny_reference_dict_converts_as_jax(tiny):
    path, _, _ = tiny
    sd = torch.load(path)
    j_vars, j_tables = jct.convert_vaeformer_state_dict(sd, 4)
    model = VAEformer(vaeformer_tiny(), device="cpu")
    want = convert.from_flax_params(model, j_vars)
    got = tct.convert_checkpoint(path, depth=4, model=model)
    tables = got.pop("_cdf_tables")
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == torch.float32
        assert np.array_equal(got[name].numpy(), want[name]), name
    _assert_tables_equal(tables, j_tables)
    _assert_tables_equal(tct.extract_cdf_tables(sd), jct.extract_cdf_tables(
        {k: v.numpy() for k, v in sd.items()}))
    # the flax tree main writes is JAX's, leaf for leaf
    _assert_trees_equal(tct.convert_vaeformer_state_dict(sd, 4)[0], j_vars)


def test_tiny_models_agree_on_converted_weights(tiny):
    """The two packages' tiny models on the converted weights: float32
    symbols and GC indexes exactly, x_hat within ATOL."""
    from cra5_tpu.models.vaeformer import VAEformerCodec as JCodec
    from cra5_tpu_torch.models.vaeformer import VAEformerCodec

    path, _, _ = tiny
    j_vars = jct.convert_checkpoint(path, depth=4)
    j_vars.pop("_cdf_tables")
    jcodec = JCodec(JVAEformer(j_tiny()), j_vars)
    model = VAEformer(vaeformer_tiny(), device="cpu")
    params = tct.convert_checkpoint(path, depth=4, model=model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    codec = VAEformerCodec(model)
    cfg = vaeformer_tiny()
    x = np.random.default_rng(5).standard_normal((1, cfg.in_chans, *cfg.img_size), np.float32)
    want = jcodec._encode_symbols(jcodec.variables, jnp.asarray(x), jcodec._scale_table_dev)
    with torch.inference_mode():
        got = model.encode_symbols(torch.from_numpy(x))
        got["gc_idx"] = codec._gc_indexes(got["scales"])
        x_hat = model.reconstruct_from_y_symbols(got["y_sym"], got["means"])
    assert np.unique(np.asarray(want["gc_idx"])).size > 4  # the scales spread
    for key in ("z_sym", "y_sym", "gc_idx"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    want_x = jcodec._reconstruct(jcodec.variables, want["y_sym"], want["means"])
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(want_x), atol=ATOL, rtol=ATOL)


# ---------------------------------------------------------------- main
def test_main_refuses_a_mismatched_268_dict_as_jax(tiny, tmp_path, capsys):
    path, _, _ = tiny
    assert jct.main([path, "-o", str(tmp_path / "j.msgpack")]) == 1
    want = capsys.readouterr().err
    assert tct.main([path, "-o", str(tmp_path / "t.msgpack")]) == 1
    got = capsys.readouterr().err
    assert got == want and got.startswith("manifest mismatch vs the published 268v structure")
    assert not (tmp_path / "t.msgpack").exists()


@pytest.mark.parametrize("flags", [["--depth", "4"], ["--no-verify"]])
def test_main_writes_the_jax_file(tiny, tmp_path, flags):
    """Past the gate (not at depth 24, or --no-verify): exit 0 and JAX's
    bytes, read alike by flax's reader and the port's."""
    path, params, tables = tiny
    j_out, t_out = tmp_path / "j.msgpack", tmp_path / "t.msgpack"
    assert jct.main([path, "-o", str(j_out), *flags]) == 0
    assert tct.main([path, "-o", str(t_out), *flags]) == 0
    assert t_out.read_bytes() == j_out.read_bytes()
    by_flax = serialization.msgpack_restore(t_out.read_bytes())
    by_port = msgpack.loads(t_out.read_bytes())
    _assert_trees_equal(by_port, by_flax)
    _assert_trees_equal(by_port["variables"]["params"], params)
    assert np.array_equal(by_port["cdf"]["gc"]["quantized_cdf"], tables["gc"].quantized_cdf)
