"""The port's msgpack codec and its ``.msgpack`` checkpoints against the
JAX package's (``msgpack``, ``flax.serialization``,
``cra5_tpu/train/checkpoints.py``), on the CPU:

  - the codec's bytes equal msgpack's and flax's, and each reads what the
    other writes, a chunked leaf included (flax's chunk size lowered);
  - the JAX package's ``.msgpack`` variables give the port the JAX forward,
    and the port's give JAX the port's forward;
  - a JAX train state after 2 steps, loaded into the port, gives the
    port's next step equal to JAX's, and the port's state after 2 steps,
    restored by JAX with a template, gives JAX's next step equal to the
    port's (at tests/test_torch_train.py's tolerance, under its shape-keyed
    shared noise); a JAX state read and written by the port keeps its bytes.
"""

import dataclasses

import flax.serialization as fs
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import cra5_tpu.entropy.entropy_bottleneck as j_ebm
import cra5_tpu.entropy.gaussian_conditional as j_gcm
from cra5_tpu.entropy import ops as j_ops
from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu.train import checkpoints as j_ckpt
from cra5_tpu.train.ema import ema_init as j_ema_init
from cra5_tpu.train.loop import TrainerConfig as JTrainerConfig
from cra5_tpu.train.loop import TrainState as JTrainState
from cra5_tpu.train.loop import make_train_step as j_make_train_step
from cra5_tpu.train.optim import make_net_aux_optimizers as j_make_tx
from cra5_tpu_torch.convert import load_flax_variables
from cra5_tpu_torch.entropy import entropy_bottleneck as ebm
from cra5_tpu_torch.entropy import gaussian_conditional as gcm
from cra5_tpu_torch.entropy import ops
from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_tiny
from cra5_tpu_torch.train import Trainer, TrainerConfig
from cra5_tpu_torch.train import checkpoints as ckpt
from cra5_tpu_torch.utils import msgpack as mp

RNG = np.random.default_rng(31)
TREES = {
    "scalars": {"none": None, "t": True, "f": False, "i": 5, "neg": -17, "i8": -100,
                "i16": -30000, "i32": -2**31, "i64": -2**40, "u8": 200, "u16": 60000,
                "u32": 2**32 - 1, "u64": 2**63, "float": 3.25, "s": "x" * 40,
                "long": "y" * 70000, "bin": b"\x01" * 300, "c": 1.5 - 2j},
    "numpy": {"f32": RNG.standard_normal((3, 4)).astype(np.float32),
              "i32": np.arange(20, dtype=np.int32).reshape(4, 5), "u8": np.arange(7, dtype=np.uint8),
              "f64": RNG.standard_normal(5), "empty": np.zeros((0, 3), np.float32),
              "zero_d": np.asarray(2.5, np.float32), "np_scalar": np.int64(9),
              "np_f32": np.float32(1.5), "np_bool": np.bool_(True)},
    "nested": {"b": {"c": {"d": np.ones(3, np.float32)}}, "a": [1, "two", np.zeros(2)],
               "many": {str(i): np.float32(i) for i in range(20)}, "tuple": (1, 2.0)},
}


def _flax_ext(x):
    return fs._msgpack_ext_pack(x)


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("name", TREES)
def test_codec_bytes_equal_flax_and_msgpack_both_ways(name):
    tree = TREES[name]
    want = fs.to_bytes(tree)
    got = mp.dumps(tree)
    assert got == want
    _same(mp.loads(want), fs.msgpack_restore(want))
    _same(fs.msgpack_restore(got), mp.loads(got))
    plain = fs.to_state_dict(tree)
    assert mp.packb(plain) == msgpack.packb(plain, default=_flax_ext, strict_types=True)
    raw = msgpack.unpackb(want, ext_hook=fs._msgpack_ext_unpack, raw=False)
    _same(mp.unpackb(want), raw)


def test_chunked_leaf_both_ways(monkeypatch):
    """A leaf over the chunk size goes out in flax's chunked form (the size
    lowered to 100 bytes in both packages) and comes back whole."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 100)
    monkeypatch.setattr(mp, "MAX_CHUNK_SIZE", 100)
    tree = {"w": RNG.standard_normal((9, 7)).astype(np.float32), "small": np.arange(3.0)}
    want = fs.to_bytes(tree)
    assert mp.dumps(tree) == want and b"__msgpack_chunked_array__" in want
    _same(mp.loads(want), fs.msgpack_restore(want))
    _same(fs.msgpack_restore(mp.dumps(tree)), tree)


def test_bfloat16_leaves_both_ways():
    """numpy has no bfloat16: the port writes a torch bf16 tensor under
    JAX's dtype name and reads one back as a torch tensor."""
    jx = jnp.asarray(RNG.standard_normal((2, 3)), jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    assert mp.dumps({"w": tx}) == fs.to_bytes({"w": jx})
    back = mp.loads(fs.to_bytes({"w": jx}))["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, tx)


@pytest.fixture(scope="module")
def tiny():
    cfg = j_tiny()
    x = np.random.default_rng(5).standard_normal((1, cfg.in_chans, *cfg.img_size)).astype(np.float32)
    variables = jax.device_get(JVAEformer(cfg).init(jax.random.PRNGKey(3), jnp.asarray(x)))
    return x, variables


def _port_xhat(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x))["x_hat"].numpy()


def test_jax_msgpack_variables_give_the_port_the_jax_forward(tiny, tmp_path):
    x, variables = tiny
    path = str(tmp_path / "step_1.msgpack")
    j_ckpt.save_variables(path, variables)
    model = VAEformer(vaeformer_tiny(), device="cpu")
    params = ckpt.load_variables(path, model=model)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
    want = np.asarray(JVAEformer(j_tiny()).apply(variables, jnp.asarray(x))["x_hat"])
    np.testing.assert_allclose(_port_xhat(model, x), want, atol=1e-5, rtol=0)


def test_port_msgpack_variables_give_jax_the_port_forward(tiny, tmp_path):
    """The port's seeded init written as .msgpack: JAX's load_variables
    reads it (and its own save writes the same bytes), and JAX's forward
    equals the port's."""
    x, _ = tiny
    model = VAEformer(vaeformer_tiny(), device="cpu").reset_parameters(6)
    path = str(tmp_path / "port.msgpack")
    ckpt.save_variables(path, dict(model.named_parameters()), model=model)
    loaded = j_ckpt.load_variables(path)
    again = str(tmp_path / "again.msgpack")
    j_ckpt.save_variables(again, loaded)
    assert open(again, "rb").read() == open(path, "rb").read()
    got = np.asarray(JVAEformer(j_tiny()).apply(loaded, jnp.asarray(x))["x_hat"])
    np.testing.assert_allclose(got, _port_xhat(model, x), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="needs the model"):
        ckpt.save_variables(path, dict(model.named_parameters()))


# ------------------------------------------------------------------ train states
LR, AUX_LR, CLIP = 1e-3, 1e-2, 0.02
TCFG = dict(learning_rate=LR, aux_learning_rate=AUX_LR, max_grad_norm=CLIP, use_ema=True,
            scheduler=dict(type="WarmupCosineLR", warmup_steps=2, min_lr_ratio=0.1),
            total_steps=5)


def _shape_noise(shape):
    """tests/test_torch_train.py's shared noise: the same uniform(-0.5,
    0.5) values for one shape in both packages, every step."""
    seed = int(np.prod([int(s) + 7 for s in shape])) % (2**31)
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=shape).astype(np.float32)


@pytest.fixture
def noise_patch(monkeypatch):
    def jq(inputs, mode, means=None, rng=None):
        if mode == "noise":
            return inputs + jnp.asarray(_shape_noise(inputs.shape)).astype(inputs.dtype)
        return j_ops.quantize(inputs, mode, means=means, rng=rng)

    def tq(inputs, mode, means=None, generator=None):
        if mode == "noise":
            return inputs + torch.from_numpy(_shape_noise(tuple(inputs.shape))).to(inputs.dtype)
        return ops.quantize(inputs, mode, means=means, generator=generator)

    for mod in (j_ebm, j_gcm):
        monkeypatch.setattr(mod, "quantize", jq)
    for mod in (ebm, gcm):
        monkeypatch.setattr(mod, "quantize", tq)


def _jax_run(params, x, steps, state=None):
    jmodel = JVAEformer(j_tiny())
    jtx = j_make_tx(LR, AUX_LR, CLIP, scheduler=TCFG["scheduler"], total_steps=5)
    jstep = jax.jit(j_make_train_step(jmodel, jtx, JTrainerConfig(**TCFG)))
    if state is None:
        state = JTrainState(step=jnp.int32(0), params=params, opt_state=jtx.init(params),
                            ema=j_ema_init(params))
    metrics = None
    for _ in range(steps):
        state, metrics = jstep(state, jnp.asarray(x), jax.random.PRNGKey(1))
    return state, {k: float(v) for k, v in metrics.items()} if metrics else None


def _port_trainer():
    return Trainer(VAEformer(vaeformer_tiny(), device="cpu"), TrainerConfig(**TCFG), seed=0)


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), what


def _compare(port_state, port_metrics, jstate, jmetrics, model):
    for k, v in jmetrics.items():
        assert port_metrics[k] == pytest.approx(v, rel=1e-3), k
    jp = dict(load_flax_variables(VAEformer(vaeformer_tiny(), device="cpu"),
                                  {"params": jax.device_get(jstate.params)}).named_parameters())
    je = dict(load_flax_variables(VAEformer(vaeformer_tiny(), device="cpu"),
                                  {"params": jax.device_get(jstate.ema.params)}).named_parameters())
    for name, p in port_state.params.items():
        _close(p.detach(), jp[name].detach(), name)
        _close(port_state.ema.params[name], je[name].detach(), f"ema {name}")
    assert port_state.step == int(jstate.step) and port_state.ema.steps == int(jstate.ema.steps)


def test_jax_train_state_resumes_in_the_port(noise_patch, tiny, tmp_path):
    x, variables = tiny
    jstate, _ = _jax_run(variables["params"], x, 2)
    path = str(tmp_path / "state_2.msgpack")
    j_ckpt.save_train_state(path, jstate)
    tr = _port_trainer()
    state = tr.restore(x, path=path)
    assert state.step == 2 and state.opt_state.count == 2 and state.ema.steps == 2
    again = str(tmp_path / "again.msgpack")
    ckpt.save_train_state(again, state, model=tr.model, scheduled=True)
    assert open(again, "rb").read() == open(path, "rb").read()
    state, m = tr._step_fn(state, tr.shard_batch(x), 0)
    jstate3, jm = _jax_run(None, x, 1, state=jstate)
    _compare(state, {k: float(v) for k, v in m.items()}, jstate3, jm, tr.model)


def test_port_train_state_resumes_in_jax(noise_patch, tiny, tmp_path):
    x, variables = tiny
    tr = _port_trainer()
    state = tr.init_state(tr.shard_batch(x))
    load_flax_variables(tr.model, variables)
    state.ema.params.update({k: p.detach().clone() for k, p in state.params.items()})
    for _ in range(2):
        state, _ = tr._step_fn(state, tr.shard_batch(x), 0)
    path = str(tmp_path / "state_2.msgpack")
    ckpt.save_train_state(path, state, model=tr.model, scheduled=True)
    jmodel = JVAEformer(j_tiny())
    jtx = j_make_tx(LR, AUX_LR, CLIP, scheduler=TCFG["scheduler"], total_steps=5)
    p0 = variables["params"]
    template = JTrainState(step=jnp.int32(0), params=p0, opt_state=jtx.init(p0),
                           ema=j_ema_init(p0))
    jstate = j_ckpt.load_train_state(path, template)
    assert int(jstate.step) == 2
    state, m = tr._step_fn(state, tr.shard_batch(x), 0)
    jstate3, jm = _jax_run(None, x, 1, state=jstate)
    _compare(state, {k: float(v) for k, v in m.items()}, jstate3, jm, tr.model)


def test_state_leaf_order_follows_the_jax_tree(tiny):
    """jax_state_leaves names every leaf of the JAX TrainState in
    jax.tree_util order, with and without the schedule's count and the
    EMA."""
    x, variables = tiny
    model = VAEformer(vaeformer_tiny(), device="cpu")
    layout = __import__("cra5_tpu_torch.convert", fromlist=["x"]).flax_layout(model)
    p0 = variables["params"]
    for sched in (None, TCFG["scheduler"]):
        for ema in (False, True):
            jtx = j_make_tx(LR, AUX_LR, CLIP, scheduler=sched, total_steps=5)
            js = JTrainState(step=jnp.int32(0), params=p0, opt_state=jtx.init(p0),
                             ema=j_ema_init(p0) if ema else None)
            paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(js)[0]]
            leaves = ckpt.jax_state_leaves(model, ema, sched is not None)
            assert len(leaves) == len(paths)
            for (kind, name), path in zip(leaves, paths):
                if name in layout:
                    keys = "".join(f"['{k}']" for k in layout[name][0].split("/"))
                    assert path.endswith(keys), (kind, name, path)
                assert {"step": ".step", "params": ".params[", "mu": ".mu[", "nu": ".nu[",
                        "count": ".count", "ema": ".ema.params[",
                        "ema_steps": ".ema.steps"}[kind] in path, (kind, path)
