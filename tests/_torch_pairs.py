"""Shared helpers of the port-vs-JAX tests of the context-model codecs
(tests/test_torch_elic.py, test_torch_swin_stf.py, test_torch_tcm.py,
test_torch_inv.py).

``pair`` gives a JAX model, its variables and the port model with the same
weights. The weights are the port's seeded init (``reset_parameters``, the
flax initializers' distributions) laid out as JAX's flax tree by
``convert.to_flax_params``, because a flax init of these models compiles
for ~30 s on the CPU; the tree and every leaf's shape are held against
``jax.eval_shape`` of JAX's init, and the port model the tests use is a
fresh one filled from that tree by ``convert.load_flax_variables``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cra5_tpu_torch.convert import flax_layout, load_flax_variables, to_flax_params

RTOL = 1e-4  # x max|ref|: float32 towers differ in summation order only


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread for a module (import it and name it in
    ``pytestmark``'s usefixtures): tiny CPU ops, such as the plain
    coder's steps and the metrics' 11 x 11 depthwise convs, run tens of
    times slower with oversubscribed threads when the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: tuple(v.shape)})
    return out


def pair(make_jax, make_port, x_shape, seed=0, tweak=None):
    """(JAX model, its variables, a port model with those weights);
    ``tweak(model)`` may change the seeded weights first."""
    jm = make_jax()
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct(x_shape, jnp.float32))
    src = make_port().reset_parameters(seed)
    if tweak is not None:
        with torch.no_grad():
            tweak(src)
    assert len(flax_layout(src)) == len(list(src.parameters()))
    params = to_flax_params(src, dict(src.named_parameters()))
    assert set(want) == {"params"} and _flat(params) == _flat(want["params"])
    pm = load_flax_variables(make_port(), {"params": params})
    assert all(torch.equal(p, pm.get_parameter(k)) for k, p in src.named_parameters())
    return jm, {"params": params}, pm


def image(b=1, seed=0, hw=(64, 64)):
    return np.random.default_rng(seed).random((b, 3, *hw)).astype(np.float32)


def np_(a):
    return a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, want, what, rtol=RTOL):
    want = np.asarray(want)
    err = np.abs(np_(got) - want).max()
    assert err <= rtol * np.abs(want).max(), f"{what}: err {err}, max|ref| {np.abs(want).max()}"


def to_t(a):
    """JAX arrays (in lists, tuples, dicts) -> torch tensors."""
    if isinstance(a, (list, tuple)):
        return type(a)(to_t(x) for x in a)
    if isinstance(a, dict):
        return {k: to_t(x) for k, x in a.items()}
    if isinstance(a, (jax.Array, np.ndarray)):
        return torch.from_numpy(np.array(a))
    return a


def to_j(a):
    if isinstance(a, (list, tuple)):
        return tuple(to_j(x) for x in a)
    return jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a


def feed(pm, fns):
    """Make each of the port model's device methods (the keys of ``fns``)
    return its JAX counterpart (the value, a function of JAX arrays: the
    JAX codec's own jitted method, so nothing compiles twice) on the same
    arguments."""
    for name, fn in fns.items():
        setattr(pm, name, lambda *a, _f=fn: to_t(_f(*to_j(a))))


def record(obj, name, seen):
    """obj.name, recording each call's result under seen[name]."""
    fn = getattr(obj, name)

    def wrapped(*args):
        out = fn(*args)
        seen.setdefault(name, []).append(out)
        return out

    setattr(obj, name, wrapped)


def charm_feed(pm, jcodec, v):
    """The port charm model's device methods fed the JAX codec's."""
    feed(pm, {"analysis": lambda x: jcodec._analysis(v, x),
              "hyper_params_from_z": lambda z: jcodec._hyper(v, z),
              "slice_entropy": lambda lm, ls, sl, i: (
                  *jcodec._slice_params(v, lm, ls, sl, i), (lm, sl)),
              "slice_residual": lambda lrp_in, ys, i: jcodec._slice_lrp(v, *lrp_in, ys, i),
              "synthesis": lambda y: jcodec._synthesis(v, y)})


def charm_bytes_check(codec, jcodec, x, num_slices):
    """Both codecs on x: the same strings, byte for byte; the port's decode
    of JAX's strings gives back the encoded symbols, slice by slice."""
    seen = {}
    record(codec, "_symbols", seen)
    out, jout = codec.compress(x), jcodec.compress(x)
    B = x.shape[0]
    assert out["shape"] == tuple(jout["shape"]) and len(out["strings"][0]) == num_slices * B
    assert out["strings"] == [[bytes(s) for s in group] for group in jout["strings"]]
    record(codec, "_decode", seen)
    x_hat = codec.decompress(jout["strings"], jout["shape"])["x_hat"]
    assert len(seen["_decode"]) == len(seen["_symbols"]) == num_slices
    for enc, dec in zip(seen["_symbols"], seen["_decode"]):
        assert dec.dtype == torch.int32 and torch.equal(enc, dec)
    assert x_hat.shape == x.shape


def charm_roundtrip_check(codec, x, num_slices):
    """The port alone: indexes and symbols of every slice equal on both
    sides, x_hat bitwise synthesis of the encoder's y_hat, bytes repeat."""
    seen = {}
    for name in ("_indexes", "_symbols", "_slice_hat"):
        record(codec, name, seen)
    out = codec.compress(x)
    record(codec, "_decode", seen)
    x_hat = codec.decompress(out["strings"], out["shape"])["x_hat"]
    S = num_slices
    assert [len(seen[k]) for k in ("_indexes", "_symbols", "_slice_hat", "_decode")] == [
        2 * S, S, 2 * S, S]
    idx, hats = seen["_indexes"], seen["_slice_hat"]
    assert all(torch.equal(a, b) for a, b in zip(idx[:S], idx[S:]))
    assert all(torch.equal(a, b) for a, b in zip(hats[:S], hats[S:]))
    assert all(torch.equal(a, b) for a, b in zip(seen["_symbols"], seen["_decode"]))
    with torch.no_grad():
        assert torch.equal(x_hat, codec.model.synthesis(torch.cat(hats[:S], dim=1)))
    assert codec.compress(x)["strings"] == out["strings"]
