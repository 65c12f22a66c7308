"""Port vs JAX: attention, patch embeds, blocks and the four towers, with
the flax weights copied in by ``convert.load_flax_variables``.

float32 throughout unless stated; tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu.nn import blocks as j_blocks
from cra5_tpu.nn import patch_embed as j_pe
from cra5_tpu.nn import vit as j_vit
from cra5_tpu.ops.attention import _flash_forward
from cra5_tpu_torch.convert import load_flax_variables
from cra5_tpu_torch.nn import blocks, patch_embed, vit
from cra5_tpu_torch.ops.attention import flash_attention_forward

F32_ATOL = 1e-5  # float32: summation order differs between XLA and torch


def _flax(module, *args, seed=0):
    """(numpy variables, module output) for ``module(*args)``,
    with every parameter moved off its init (nonzero biases, LayerNorm
    scales off 1) so that each one matters."""
    r = np.random.default_rng(seed)
    vn = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * r.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(module.init(jax.random.PRNGKey(seed), *args)))
    return vn, module.apply(vn, *args)


def _close(got: torch.Tensor, want, atol=F32_ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("dtype,N", [("float32", 300), ("bfloat16", 300), ("bfloat16", 127),
                                     ("bfloat16", 129), ("bfloat16", 257)],
                         ids=["float32", "bfloat16", "bfloat16-127", "bfloat16-129",
                              "bfloat16-257"])
def test_flash_plain_matches_pallas_forward(rng, dtype, N):
    """Ragged N over 128-wide Pallas tiles (tail mask), H = 2, D = 64; the
    bf16 N sit at the card kernel's 128-row tile edges. float32: out and
    lse within 1e-5. bfloat16 inputs: P is rounded to bf16 against the
    running maximum in the tiled TPU kernel and against the row maximum in
    the plain version, so out agrees within 1e-2 and lse within 1e-4."""
    B, H, D = 1, 2, 64
    q, k, v = (rng.standard_normal((B, H, N, D)).astype(np.float32) * 1.5 for _ in range(3))
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    out_j, lse_j = _flash_forward(*(jnp.asarray(a, jd) for a in (q, k, v)), D ** -0.5, 128, 128)
    out_t, lse_t = flash_attention_forward(*(torch.from_numpy(a).to(td) for a in (q, k, v)))
    tol = (1e-2, 1e-4) if dtype == "bfloat16" else (F32_ATOL, F32_ATOL)
    assert out_t.dtype == td
    _close(out_t, out_j, tol[0])
    _close(lse_t, np.asarray(lse_j)[:, :N, 0].reshape(B, H, N), tol[1])


def test_patch_embed_kh_sh_plus_one(rng):
    x = rng.standard_normal((2, 5, 31, 40)).astype(np.float32)  # 31 = 2*10 + 11
    jm = j_pe.PatchEmbed(12, (11, 10), (10, 10))
    vn, (want, grid) = _flax(jm, jnp.asarray(x))
    tm = load_flax_variables(patch_embed.PatchEmbed(5, 12, (11, 10), (10, 10)), vn)
    got, tgrid = tm(torch.from_numpy(x))
    assert tgrid == grid == (3, 4)
    _close(got, want)


@pytest.mark.parametrize("patch,stride,hw", [((11, 10), (10, 10), (3, 4)), ((2, 2), (2, 2), (2, 3))])
def test_patch_unembed(rng, patch, stride, hw):
    """kh = sh + 1 (row kh-1 of patch h lands on row 0 of patch h+1) and
    kh = sh."""
    x = rng.standard_normal((2, hw[0] * hw[1], 6)).astype(np.float32)
    jm = j_pe.PatchUnembed(5, patch, stride)
    vn, want = _flax(jm, jnp.asarray(x), hw)
    tm = load_flax_variables(patch_embed.PatchUnembed(6, 5, patch, stride), vn)
    got = tm(torch.from_numpy(x), hw)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_window_attention_with_padding(rng):
    """A (5, 6) grid under (2, 4) windows pads to (6, 8); the padded
    tokens are not masked, in either package."""
    H, W, C = 5, 6, 16
    x = rng.standard_normal((2, H * W, C)).astype(np.float32)
    jm = j_blocks.WindowAttention(C, 2, (2, 4))
    vn, want = _flax(jm, jnp.asarray(x), H, W)
    tm = load_flax_variables(blocks.WindowAttention(C, 2, (2, 4)), vn)
    _close(tm(torch.from_numpy(x), H, W), want)


@pytest.mark.parametrize("window", [None, (4, 1)])
def test_block_global_and_window(rng, window):
    H, W, C = 4, 4, 16
    x = rng.standard_normal((1, H * W, C)).astype(np.float32)
    jm = j_blocks.Block(C, 2, window_size=window, layer_id=1)
    vn, want = _flax(jm, jnp.asarray(x), H, W)
    tm = load_flax_variables(blocks.Block(C, 2, window_size=window, layer_id=1), vn)
    _close(tm(torch.from_numpy(x), H, W), want)


def _towers():
    """The four towers at vaeformer_tiny() geometry."""
    win, kw = ((2, 2), (1, 4), (4, 1)), dict(depth=4, num_heads=2, interval=2)
    return {
        "g_a": (j_vit.ViTEncoder((41, 40), (11, 10), (10, 10), 8, 16, window_sizes=win, **kw),
                vit.ViTEncoder((41, 40), (11, 10), (10, 10), 8, 16, 4, 2, win, 2),
                (1, 8, 41, 40)),
        "g_s": (j_vit.ViTDecoder((41, 40), (11, 10), (10, 10), 8, 16, window_sizes=win, **kw),
                vit.ViTDecoder((41, 40), (11, 10), (10, 10), 8, 16, 4, 2, win, 2),
                (1, 16, 4, 4)),
        "h_a": (j_vit.HyperEncoder((4, 4), (2, 2), (2, 2), 8, 8, 12, 2, 2),
                vit.HyperEncoder((4, 4), (2, 2), (2, 2), 8, 8, 12, 2, 2),
                (1, 8, 4, 4)),
        "h_s": (j_vit.HyperDecoder((4, 4), (2, 2), (2, 2), 8, 8, 12, 2, 2),
                vit.HyperDecoder((2, 2), 8, 8, 12, 2, 2),
                (1, 8, 2, 2)),
    }


@pytest.mark.parametrize("tower", ["g_a", "g_s", "h_a", "h_s"])
def test_towers_tiny(rng, tower):
    jm, tm, shape = _towers()[tower]
    x = rng.standard_normal(shape).astype(np.float32)
    vn, want = _flax(jm, jnp.asarray(x))
    got = load_flax_variables(tm, vn)(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    _close(got, want, 2e-5)


def test_converter_is_strict(rng):
    x = rng.standard_normal((1, 16, 16)).astype(np.float32)
    jm = j_blocks.Block(16, 2, layer_id=0)
    vn, _ = _flax(jm, jnp.asarray(x), 4, 4)
    with pytest.raises(ValueError, match="unused"):
        load_flax_variables(blocks.Block(16, 2, window_size=(2, 2), layer_id=0),
                            {"params": {**vn["params"], "extra": {"kernel": np.zeros(1)}}})
    del vn["params"]["norm1"]
    with pytest.raises(ValueError, match="lack"):
        load_flax_variables(blocks.Block(16, 2, layer_id=0), vn)
