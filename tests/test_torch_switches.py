"""Port vs JAX: the flash mode and the sorted-lanes mode.

``nn.blocks.set_flash_attention`` and ``coder.rans_kernels.set_sorted_lanes``
take JAX's modes ("auto" | "on" | "off") and environment variables
(``CRA5_TPU_FLASH``, ``CRA5_TPU_SORTED_LANES``). On the CPU, "on" sends
every attention through ``ops/attention.flash_attention``, whose plain
versions stand in for K4-K6 as JAX's interpret mode stands in for its
Pallas kernels; the tiny VAEformer's x_hat under it matches JAX "on" and
the port's "off" within 2e-4 (JAX's own on/off bound), and one tiny remat
step's gradients under "on" match "off" (float32: summation order only).
Under "off" the port writes JAX's unsorted container at K = 2048 byte for
byte, under "on" JAX's sorted one at K = 128, and each package decodes the
other's unsorted stream. Every test restores both modes."""

import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.coder import rans_pallas as j_rans_pallas
from cra5_tpu.coder import rans_tpu as rt
from cra5_tpu.entropy.cdf import CdfTable as JCdfTable
from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu.nn import blocks as j_blocks
from cra5_tpu_torch.coder import rans_kernels
from cra5_tpu_torch.coder.lane_coder import LaneCoder, parse_v2_header
from cra5_tpu_torch.convert import load_flax_variables
from cra5_tpu_torch.entropy import gc_update, get_scale_table
from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_tiny
from cra5_tpu_torch.nn import blocks
from test_torch_model import _random_variables

ROOT = Path(__file__).resolve().parents[1]
XHAT_ATOL = 2e-4  # JAX's bound for its tiny VAEformer under flash on and off
GRAD_RTOL = 1e-4  # float32 gradients, plain flash vs plain attention: summation order


@contextlib.contextmanager
def flash_mode(port: str, jax_mode: str = "auto"):
    saved = blocks.flash_attention_mode()
    blocks.set_flash_attention(port)
    j_blocks.set_flash_attention(jax_mode)
    try:
        yield
    finally:
        blocks.set_flash_attention(saved)
        j_blocks.set_flash_attention("auto")


@contextlib.contextmanager
def sorted_mode(port: str, jax_mode: str):
    saved = rans_kernels.sorted_lanes_mode()
    rans_kernels.set_sorted_lanes(port)
    j_rans_pallas.set_sorted_lanes(jax_mode)
    try:
        yield
    finally:
        rans_kernels.set_sorted_lanes(saved)
        j_rans_pallas.set_sorted_lanes("auto")


@contextlib.contextmanager
def counting_flash(monkeypatch):
    """Counts the calls of ``flash_attention`` from the blocks."""
    calls = []
    real = blocks.flash_attention
    monkeypatch.setattr(blocks, "flash_attention", lambda *a: calls.append(1) or real(*a))
    yield calls


@pytest.mark.parametrize("setter", [blocks.set_flash_attention, rans_kernels.set_sorted_lanes],
                         ids=["flash", "sorted_lanes"])
def test_setters_reject_a_bad_mode(setter):
    with pytest.raises(ValueError, match="invalid"):
        setter("sometimes")


def test_modes_are_read_from_the_environment_at_import():
    """A fresh interpreter takes each mode from its variable; a bad value
    raises at import."""
    code = ("from cra5_tpu_torch.nn import blocks; from cra5_tpu_torch.coder import "
            "rans_kernels as r; print(blocks.flash_attention_mode(), r.sorted_lanes_mode())")
    env = dict(os.environ, CRA5_TPU_FLASH="on", CRA5_TPU_SORTED_LANES="off",
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["on", "off"]
    env["CRA5_TPU_FLASH"] = "fast"
    bad = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert bad.returncode != 0 and "invalid flash mode" in bad.stderr


@pytest.mark.parametrize("mode,n,bh,cpu,cuda", [
    ("auto", 576, 18 * 16, False, False), ("auto", 10368, 16, False, True),
    ("on", 576, 18 * 16, True, True), ("on", 4, 2, True, True),
    ("off", 10368, 16, False, False), ("off", 576, 18 * 16, False, False)])
def test_use_flash_follows_the_mode(mode, n, bh, cpu, cuda):
    """"auto" keeps the card's rule (the 268v window blocks stay plain),
    "on" routes everything, "off" nothing, on either device."""
    with flash_mode(mode):
        assert blocks._use_flash(n, bh, torch.device("cpu")) == cpu
        assert blocks._use_flash(n, bh, torch.device("cuda")) == cuda


@pytest.fixture(scope="module")
def tiny_pair():
    jcfg, cfg = j_tiny(), vaeformer_tiny()
    x = np.random.default_rng(0).standard_normal((1, cfg.in_chans, *cfg.img_size))
    x = x.astype(np.float32)
    jmodel = JVAEformer(jcfg)
    shapes = jax.eval_shape(lambda k, a: jmodel.init(k, a), jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _random_variables(shapes, np.random.default_rng(1))
    return x, jmodel, variables, load_flax_variables(VAEformer(cfg, device="cpu"), variables)


def test_flash_on_x_hat_matches_jax_on_and_port_off(tiny_pair, monkeypatch):
    """Every attention of the tiny model under "on" goes through
    flash_attention (g_a 3, h_a 1, h_s 1, g_s 2), none under "off" and
    "auto" on the CPU; x_hat under "on" matches JAX "on" (its Pallas
    kernels in interpret mode) and the port's "off"."""
    x, jmodel, variables, model = tiny_pair
    got = {}
    with counting_flash(monkeypatch) as calls:
        for mode in ("on", "off", "auto"):
            calls.clear()
            with flash_mode(mode), torch.no_grad():
                got[mode] = model(torch.from_numpy(x))["x_hat"].numpy()
            assert len(calls) == {"on": 7, "off": 0, "auto": 0}[mode], mode
    with flash_mode("on", "on"):
        want = np.asarray(jmodel.apply(variables, jnp.asarray(x))["x_hat"])
    np.testing.assert_allclose(got["on"], want, atol=XHAT_ATOL)
    np.testing.assert_allclose(got["on"], got["off"], atol=XHAT_ATOL)
    np.testing.assert_array_equal(got["off"], got["auto"])


def test_flash_on_remat_step_gradients_match_off(tiny_pair, monkeypatch):
    """One remat training step of the tiny model (noise from one seed),
    its loss and every parameter's gradient under "on" against "off":
    max |on - off| <= 1e-4 x max |off| + 1e-7 for each; under "on" the
    step calls flash_attention 12 times (7 forward calls, and 5 where the
    backward recomputes the blocks of g_a and g_s)."""
    x, _, variables, _ = tiny_pair
    model = load_flax_variables(
        VAEformer(dataclasses.replace(vaeformer_tiny(), remat=True), device="cpu"), variables)
    grads, losses = {}, {}
    with counting_flash(monkeypatch) as calls:
        for mode in ("on", "off"):
            calls.clear()
            model.zero_grad(set_to_none=True)
            with flash_mode(mode):
                out = model(torch.from_numpy(x), training=True,
                            generator=torch.Generator().manual_seed(5))
                bpp = sum(-torch.log2(v).sum() for v in out["likelihoods"].values())
                loss = bpp / x[0, 0].size + ((out["x_hat"] - torch.from_numpy(x)) ** 2).mean()
                loss.backward()
            losses[mode] = loss.item()
            grads[mode] = {k: p.grad.clone() for k, p in model.named_parameters()
                           if p.grad is not None}
            assert len(calls) == {"on": 12, "off": 0}[mode]
    assert np.isfinite(losses["on"])
    assert losses["on"] == pytest.approx(losses["off"], rel=1e-5)
    assert grads["on"].keys() == grads["off"].keys() and len(grads["on"]) > 50
    for k, ref in grads["off"].items():
        err = (grads["on"][k] - ref).abs().max().item()
        assert err <= GRAD_RTOL * ref.abs().max().item() + 1e-7, (k, err)


# ------------------------------------------------------------ sorted lanes
@pytest.fixture(scope="module")
def gc_table():
    return gc_update(get_scale_table())


def _symbols(table, n, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, table.num_indexes, n).astype(np.int32)
    sym = np.empty(n, np.int64)
    for r in np.unique(idx):
        m = idx == r
        L = int(table.cdf_length[r])
        u = rng.integers(0, 1 << 16, int(m.sum()))
        bins = np.searchsorted(table.quantized_cdf[r, :L], u, side="right") - 1
        sym[m] = np.minimum(bins, L - 3) + int(table.offset[r])
    esc = rng.random(n) < 0.02
    sym[esc] += rng.integers(50, 3000, int(esc.sum()))
    return sym.astype(np.int32), idx


def _jax_coder(table, K):
    return rt.LaneCoder(JCdfTable(table.quantized_cdf, table.cdf_length, table.offset),
                        num_lanes=K)


@pytest.mark.parametrize("port_mode,jax_mode,K,sort", [("off", "off", 2048, False),
                                                       ("off", "auto", 2048, False),
                                                       ("on", "on", 128, True)])
def test_container_equals_jax_under_the_mode(gc_table, port_mode, jax_mode, K, sort):
    """The same symbols and indexes: under "off" the port writes JAX's
    unsorted container at K = 2048 (JAX's "auto" on its CPU writes it
    too), under "on" JAX's sorted one at K = 128; each decodes."""
    sym, idx = _symbols(gc_table, 5 * K - 37, seed=K)
    with sorted_mode(port_mode, jax_mode):
        mine = LaneCoder(gc_table, num_lanes=K, device="cpu").encode(sym, idx)
        theirs = _jax_coder(gc_table, K).encode(sym, idx)
    assert mine == theirs
    assert parse_v2_header(mine)[4] == sort
    np.testing.assert_array_equal(LaneCoder(gc_table, num_lanes=K, device="cpu").decode(mine, idx),
                                  sym)


def test_each_package_decodes_the_others_unsorted_stream(gc_table):
    K = 2048
    sym, idx = _symbols(gc_table, 3 * K + 5, seed=3)
    with sorted_mode("off", "off"):
        mine = LaneCoder(gc_table, num_lanes=K, device="cpu").encode(sym, idx)
    theirs = _jax_coder(gc_table, K).encode(sym, idx)  # JAX's "auto" on its CPU: unsorted
    assert not parse_v2_header(mine)[4] and not parse_v2_header(theirs)[4]
    port = LaneCoder(gc_table, num_lanes=K, device="cpu")
    np.testing.assert_array_equal(_jax_coder(gc_table, K).decode(mine, idx), sym)
    np.testing.assert_array_equal(port.decode(theirs, idx), sym)


@pytest.mark.parametrize("mode,K,coder_on,sort", [
    ("auto", 2048, False, True), ("auto", 1024, False, False), ("auto", 2000, False, False),
    ("on", 1024, False, True), ("on", 1000, False, False), ("off", 2048, False, False),
    ("off", 256, True, True)])
def test_sorted_ok_follows_the_mode(gc_table, mode, K, coder_on, sort):
    """"auto" sorts from 2048 lanes (the format default), "on" whenever
    K % 128 == 0, "off" never; a coder's own sorted_lanes=True is "on" for
    that coder, whatever the mode."""
    with sorted_mode(mode, "auto"):
        coder = LaneCoder(gc_table, num_lanes=K, device="cpu", sorted_lanes=coder_on)
        assert coder._sorted_ok(10 * K, K) == sort
        assert rans_kernels.use_sorted_lanes(K) == (sort and not coder_on)
