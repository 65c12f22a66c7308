"""The port's tensor parallelism against the JAX package's, on the CPU.

First the layout, with no ranks: the port's placement splits exactly
where the JAX spec does, except attention whose head count does not
divide by tp (vaeformer_tiny's 2 heads at tp 4, 268v's 5-head hyperprior
towers at tp 2), and cutting a full tensor to the ranks' shards and
joining them back is the identity for every parameter of vaeformer_tiny
and of the 268v shapes (built on the ``meta`` device). A placed ``Dense``
draws its shard of the one-device init.

Then one 4-rank gloo world (spawned as ``tests/test_torch_distributed.py``
spawns its worlds; each rank's ``communicate()`` has its own timeout)
runs every task once, on a ``{"dp": 2, "tp": 2}`` mesh of float32
vaeformer_tiny from the JAX package's init, and on a ``{"tp": 4}`` mesh of
the same world:

  - the eval forward against JAX's ``shard_variables`` forward on
    ``make_mesh({"dp": 2, "tp": 2})``, atol 2e-4 (as tests/test_parallel.py
    holds JAX's own against one device);
  - the loss gradients, averaged over dp and gathered over tp, leaf by leaf
    against the one-process port within 1e-4 x max|ref| + 1e-7;
  - 3 ``Trainer`` steps under the shape-keyed noise patch of
    tests/test_torch_train.py (keyed by the global shape, each dp rank
    keeping its rows) against JAX's ``Trainer`` on the same mesh, within
    that file's trajectory bounds; the replicated parameters bitwise equal
    across each tp pair; the saved checkpoint loading into a one-process
    ``Trainer`` and, as ``.msgpack``, into the JAX package;
  - a resume that repeats an uninterrupted run, bitwise;
  - the codec: ``forward`` within 2e-4 of one process, the tp ranks' bytes
    identical, ``decompress`` within 2e-3 of one process and of JAX's tp
    codec;
  - ``tools/train.py`` with ``mesh = dict(dp=2, tp=2)``, 2 steps, whose
    checkpoint equals a ``Trainer``'s on the same batches.

The JAX references are computed while the ranks run.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import cra5_tpu.entropy.entropy_bottleneck as j_ebm
import cra5_tpu.entropy.gaussian_conditional as j_gcm
from cra5_tpu.entropy import ops as j_ops
from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import VAEformerCodec as JCodec
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu.parallel import make_mesh as j_make_mesh
from cra5_tpu.parallel import mesh_param_specs as j_mesh_param_specs
from cra5_tpu.parallel import shard_variables as j_shard_variables
from cra5_tpu.train import Trainer as JTrainer
from cra5_tpu.train import TrainerConfig as JTrainerConfig
from cra5_tpu.train.checkpoints import load_train_state as j_load_train_state
from cra5_tpu.train.checkpoints import load_variables as j_load_variables
from cra5_tpu.train.checkpoints import save_variables as j_save_variables
from cra5_tpu_torch.convert import flax_layout, load_flax_variables
from cra5_tpu_torch.models import vaeformer as vf
from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_tiny
from cra5_tpu_torch.nn.blocks import Dense
from cra5_tpu_torch.nn.init import init_linear_
from cra5_tpu_torch.parallel import (TPGroup, gather_tensor, mesh_param_specs, shard_tensor,
                                     tp_placement)
from cra5_tpu_torch.parallel.tensor_parallel import model_placement
from cra5_tpu_torch.train import RateDistortionLoss, Trainer, TrainerConfig
from cra5_tpu_torch.train.loop import step_generator

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240  # seconds for each rank's communicate()
SEED, RNG = 3, 7
STEPS = 3
# tests/test_torch_train.py's trajectory settings
LR, AUX_LR, CLIP = 1e-3, 1e-2, 0.02
TCFG = dict(learning_rate=LR, aux_learning_rate=AUX_LR, max_grad_norm=CLIP,
            scheduler=dict(type="WarmupCosineLR", warmup_steps=2, min_lr_ratio=0.1),
            total_steps=STEPS, use_ema=True, log_every=1, ckpt_every=10**9)


def _shape_noise(shape):
    """tests/test_torch_train.py's shape-keyed uniform(-0.5, 0.5) noise."""
    seed = int(np.prod([int(s) + 7 for s in shape])) % (2**31)
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=shape).astype(np.float32)


WORKER = r'''
import json, os, pickle, sys
import numpy as np, torch
spec, out_dir = json.loads(sys.argv[1]), sys.argv[2]
from cra5_tpu_torch.entropy import entropy_bottleneck as ebm, gaussian_conditional as gcm, ops
from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_tiny
from cra5_tpu_torch.parallel import (fetch_tree, init_distributed, make_mesh, parallelize_,
                                     placement_of, shard_variables)
from cra5_tpu_torch.parallel.distributed import all_reduce_mean_
from cra5_tpu_torch.parallel.mesh import axis_group
from cra5_tpu_torch.train import RateDistortionLoss, Trainer, TrainerConfig
from cra5_tpu_torch.train.checkpoints import (full_state, load_variables, save_train_state,
                                              save_variables)
from cra5_tpu_torch.train.loop import step_generator
from cra5_tpu_torch.entropy.ops import BatchRows
rank = init_distributed(device="cpu")
x = np.load(spec["batch"])
mesh = make_mesh({"dp": 2, "tp": 2}, device_type="cpu")
_, _, dp = axis_group(mesh, "dp")
_, _, tpr = axis_group(mesh, "tp")
local = torch.from_numpy(x[dp:dp + 1])
res = {"rank": rank, "dp": dp, "tp": tpr}

def loaded():
    model = VAEformer(vaeformer_tiny(), device="cpu")
    with torch.no_grad():
        for k, v in load_variables(spec["vars"], model=model).items():
            model.get_parameter(k).copy_(v)
    return model

def grads(model, mesh, batch, rows):
    gen = step_generator(RNG, 0, "cpu")
    if rows is not None:
        gen = BatchRows(gen, rows[0], rows[1], 2)
    out = model(batch, training=True, generator=gen)
    RateDistortionLoss()(out, batch)["loss"].backward()
    g = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    dp_group = axis_group(mesh, "dp")[0]
    if dp_group is not None:
        all_reduce_mean_(list(g.values()), dp_group)
    return fetch_tree(g, mesh, placement_of(model))

RNG = spec["rng"]
# the eval forward and the gradients
model = parallelize_(loaded(), mesh)
res["placement"] = placement_of(model)
res["local_heads"] = {n: m.local_heads for n, m in model.named_modules() if hasattr(m, "local_heads")}
with torch.no_grad():
    res["forward"] = model(local)["x_hat"]
res["grads"] = grads(model, mesh, local, (dp, dp + 1))
# the codec on the same placed model
codec = VAEformerCodec(model)
codec.update()
res["codec_forward"] = codec.forward(local)["x_hat"]
enc = codec.compress(local)
res["strings"] = enc["strings"]
res["decompress"] = codec.decompress(enc["strings"], enc["z_shape"])["x_hat"]
del model, codec

# a tp axis of 4: vaeformer_tiny's 2-head attention stays whole, its MLPs split
mesh4 = make_mesh({"tp": 4}, device_type="cpu")
model = parallelize_(loaded(), mesh4)
res["tp4_placement"] = placement_of(model)
res["tp4_local_heads"] = {n: m.local_heads for n, m in model.named_modules()
                          if hasattr(m, "local_heads")}
with torch.no_grad():
    res["tp4_forward"] = model(torch.from_numpy(x))["x_hat"]
res["tp4_grads"] = grads(model, mesh4, torch.from_numpy(x), None)

# the shape-keyed noise, keyed by the global shape: each dp rank keeps its rows
def tq(inputs, mode, means=None, generator=None):
    if mode == "noise":
        fill = lambda shape, g: torch.from_numpy(noise(tuple(shape)))
        return inputs + ops.draw(tuple(inputs.shape), generator, fill).to(inputs.dtype)
    return ops.quantize(inputs, mode, means=means, generator=generator)
exec(spec["noise_src"])
noise = _shape_noise
ebm.quantize = gcm.quantize = tq
tcfg = dict(spec["tcfg"], ckpt_dir=os.path.join(out_dir, "ckpt"))
tr = Trainer(loaded(), TrainerConfig(**tcfg), mesh=mesh, seed=spec["seed"])
batch = tr.shard_batch(x[dp:dp + 1])
state = tr.init_state(batch)
with torch.no_grad():  # start from the JAX init, as the JAX Trainer does
    start = shard_variables(mesh, torch.load(spec["start"]), placement_of(tr.model))
    for k, v in start.items():
        state.params[k].copy_(v)
        state.ema.params[k].copy_(v)
logs = []
state = tr.fit([x[dp:dp + 1]] * spec["steps"], state=state, num_steps=spec["steps"],
               log_fn=lambda s, m: logs.append(m))
res["logs"] = logs
res["replicated"] = {k: p.detach().clone() for k, p in state.params.items()
                     if placement_of(tr.model).get(k) is None}
res["ckpt"] = tr.save(state)
full = full_state(state, mesh, placement_of(tr.model))
if rank == 0:
    save_variables(os.path.join(out_dir, "tp.msgpack"), full.params, model=tr.model)
    save_train_state(os.path.join(out_dir, "tp_state.msgpack"), full, model=tr.model,
                     scheduled=True)
res["params"], res["ema"] = full.params, full.ema.params

# a resume repeats an uninterrupted run
data = [np.random.default_rng(40 + dp * 10 + i).standard_normal(x[:1].shape).astype(np.float32)
        for i in range(3)]
rcfg = dict(log_every=10**9, ckpt_every=10**9, ckpt_dir=os.path.join(out_dir, "resume"),
            scheduler=dict(type="LinearWarmupLR", warmup_steps=2))
fresh = lambda: Trainer(VAEformer(vaeformer_tiny(), device="cpu"), TrainerConfig(**rcfg),
                        mesh=mesh, seed=spec["seed"])
whole = fresh().fit(data, num_steps=3)
first = fresh()
first.save(first.fit(data[:2], num_steps=2))
second = fresh()
resumed = second.restore(data[0])
res["resumed_step"] = (resumed.step, resumed.opt_state.count)
resumed = second.fit(data[2:], state=resumed, num_steps=1)
res["resume_equal"] = all(
    torch.equal(a[k], b[k]) for a, b in (
        (whole.params, resumed.params), (whole.ema.params, resumed.ema.params),
        (whole.opt_state.mu, resumed.opt_state.mu), (whole.opt_state.nu, resumed.opt_state.nu))
    for k in a) and whole.step == resumed.step == 3

# tools/train.py with mesh = dict(dp=2, tp=2) against a Trainer on the same batches
from cra5_tpu_torch.tools import train as cli
cfg_path = os.path.join(out_dir, f"cfg{rank}.py")
with open(cfg_path, "w") as f:
    f.write("model = dict(type='VAEformer', cfg='tiny')\n"
            "dataset = dict(type='synthetic', shape=(1, 8, 41, 40))\n"
            "trainer = dict(log_every=10**9)\nmesh = dict(dp=2, tp=2)\nsteps = 2\n")
_, _, cli_path = cli.run([cfg_path, "--steps", "2", "--ckpt-dir", os.path.join(out_dir, "cli"),
                          "--device", "cpu", "--seed", "5"])
tr = Trainer(cli.build_model(dict(type="VAEformer", cfg="tiny"), device="cpu"),
             TrainerConfig(log_every=10**9, total_steps=2,
                           ckpt_dir=os.path.join(out_dir, "cli_trainer")),
             mesh=mesh, seed=5)
own_path = tr.save(tr.fit(cli.build_data(dict(type="synthetic", shape=(1, 8, 41, 40)),
                                         seed=5 + dp), num_steps=2))
res["cli"] = (cli_path, own_path)

with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(n: int, spec: dict, out_dir: Path) -> list:
    env = {k: v for k, v in os.environ.items()
           if k not in ("CRA5_TPU_COORDINATOR", "CRA5_TPU_NUM_PROCESSES", "CRA5_TPU_PROCESS_ID",
                        "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", CRA5_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}",
               CRA5_TPU_NUM_PROCESSES=str(n),
               PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""))
    return [subprocess.Popen([sys.executable, "-c", WORKER, json.dumps(spec), str(out_dir)],
                             env={**env, "CRA5_TPU_PROCESS_ID": str(r)}, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)]


def _finish(procs: list, out_dir: Path) -> list:
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            results.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, err) in enumerate(results):
        assert rc == 0, f"rank {r} of {len(procs)} exited {rc}:\n{err[-3000:]}"
    ranks = []
    for r in range(len(procs)):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


# ------------------------------------------------------------------ layout
def _meta_268():
    """The 268v model's parameters on the meta device (shapes only)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(vf, "resolve_device", lambda device=None: torch.device("meta"))
    try:
        return VAEformer(vf.vaeformer_268(), device="meta")
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def models():
    return {"tiny": VAEformer(vaeformer_tiny(), device="cpu"), "268": _meta_268()}


def _departs(name: str, model, tp: int) -> bool:
    """Whether the parameter is a qkv or proj of attention whose heads do
    not divide by tp."""
    owner, layer = name.rsplit(".", 2)[:2]
    if layer not in ("qkv", "proj"):
        return False
    return model.get_submodule(owner).num_heads % tp != 0


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("which", ["tiny", "268"])
def test_placement_splits_where_the_jax_spec_does(models, which, tp):
    """Split exactly where mesh_param_specs (the JAX spec, held to JAX name
    by name in tests/test_torch_parallel.py) splits, replicated only where
    attention's heads do not divide: tiny's 2 heads at tp 4, 268v's 5-head
    hyper towers at tp 2 and 4 (and its 16-head towers split)."""
    model = models[which]
    named = dict(model.named_parameters())
    specs = mesh_param_specs({"tp": tp}, named)
    placement = model_placement(model, tp)
    assert set(placement) == set(named)
    departed = set()
    for name, spec in specs.items():
        jax_splits = any(a is not None for a in spec)
        if _departs(name, model, tp) and jax_splits:
            departed.add(name.split(".")[0])
            assert placement[name] is None, name
        else:
            assert (placement[name] is not None) == jax_splits, name
    want = {("tiny", 2): set(), ("tiny", 4): {"g_a", "g_s", "h_a", "h_s"},
            ("268", 2): {"h_a", "h_s"}, ("268", 4): {"h_a", "h_s"}}[which, tp]
    assert departed == want
    assert placement["g_a.blocks.0.mlp.fc1.weight"] == (0, 1)
    assert placement["g_a.blocks.0.mlp.fc2.weight"] == (1, 1)
    assert placement["g_a.blocks.0.mlp.fc2.bias"] is None
    if which == "268":
        assert placement["g_a.blocks.3.attn.qkv.weight"] == (0, 3)
        assert placement["g_a.blocks.3.attn.qkv.bias"] == (0, 3)
        assert placement["g_a.blocks.3.attn.proj.weight"] == (1, 1)
        assert placement["g_a.blocks.3.attn.proj.bias"] is None
        assert placement["h_a.quan_mlp.fc1.weight"] == (0, 1)


def test_placement_matches_the_jax_package_spec_on_tiny():
    """On vaeformer_tiny the JAX package's own mesh_param_specs, not only
    the port's mirror, says where to split."""
    cfg = j_tiny()
    x = jnp.zeros((1, cfg.in_chans, *cfg.img_size), jnp.float32)
    jparams = jax.eval_shape(lambda: JVAEformer(cfg).init(jax.random.PRNGKey(0), x))["params"]
    model = VAEformer(vaeformer_tiny(), device="cpu")
    want = j_mesh_param_specs(j_make_mesh({"dp": 4, "tp": 2}), jparams)
    placement = model_placement(model, 2)
    for name, (path, _) in flax_layout(model).items():
        spec = want
        for key in path.split("/"):
            spec = spec[key]
        assert (placement[name] is not None) == any(a is not None for a in spec), name


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("which", ["tiny", "268"])
def test_shard_then_gather_is_the_identity(models, which, tp):
    """Every parameter's shards (one per rank) join back to the full
    tensor bitwise, each shard of its local shape; for the 268v shapes on
    the meta device, once per distinct (shape, split) on real values."""
    placement = model_placement(models[which], tp)
    gen = torch.Generator().manual_seed(tp)
    seen = set()
    for name, p in models[which].named_parameters():
        split = placement[name]
        if (tuple(p.shape), split) in seen:
            continue
        seen.add((tuple(p.shape), split))
        full = torch.randn(p.shape, generator=gen)
        shards = [shard_tensor(full, split, r, tp) for r in range(tp)]
        if split is None:
            assert all(s is full for s in shards)
        else:
            dim = split[0]
            assert all(s.shape[dim] * tp == full.shape[dim] for s in shards), name
        assert torch.equal(gather_tensor(shards, split), full), name


def test_qkv_shard_holds_whole_heads():
    """The fused qkv rows of rank r at tp 2 are q, k and v of heads
    [r H/2, (r + 1) H/2), each Dh rows a head, in that order."""
    H, Dh, C = 4, 3, 12
    full = torch.arange(3 * C * C, dtype=torch.float32).reshape(3 * C, C)
    for r in range(2):
        shard = shard_tensor(full, (0, 3), r, 2)
        rows = [j * C + h * Dh + d for j in range(3) for h in range(r * 2, r * 2 + 2)
                for d in range(Dh)]
        assert torch.equal(shard, full[rows])
    assert tp_placement({"b.attn.qkv.weight": full}, 2, {"b.attn": H}) == \
        {"b.attn.qkv.weight": (0, 3)}
    assert tp_placement({"b.attn.qkv.weight": full}, 2, {"b.attn": 3}) == \
        {"b.attn.qkv.weight": None}


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_flash_routing_at_tp_keeps_the_seven_global_blocks(models, tp):
    """_use_flash decides on a rank's local heads: at 268v the 16-head
    global blocks (10 368 tokens) take K4/K5/K6 at 16 / tp heads, the
    window and hyper blocks stay plain."""
    from cra5_tpu_torch.nn.blocks import _use_flash

    model, cuda = models["268"], torch.device("cuda")
    placement = model_placement(model, tp) if tp > 1 else {}
    Hp, Wp = model.cfg.latent_grid
    flash = []
    for name, m in model.named_modules():
        if hasattr(m, "num_heads"):
            split = placement.get(f"{name}.qkv.weight") is not None
            heads = m.num_heads // tp if split else m.num_heads
            if getattr(m, "window_size", None) is None and name.startswith("g_"):
                assert _use_flash(Hp * Wp, heads, cuda), name
                flash.append((name, heads))
            elif getattr(m, "window_size", None) is not None:
                wh, ww = m.window_size
                nw = -(-Hp // wh) * -(-Wp // ww)
                assert not _use_flash(wh * ww, nw * heads, cuda), name
            else:
                hz = model.cfg.hyper_grid
                assert not _use_flash(hz[0] * hz[1], heads, cuda), name
    assert len(flash) == 7 and {h for _, h in flash} == {16 // tp}


@pytest.mark.parametrize("split", [(0, 3), (0, 1), (1, 1)])
def test_a_placed_dense_draws_its_shard_of_the_one_device_init(split):
    full = Dense(12, 36 if split == (0, 3) else 24)
    init_linear_(full, torch.Generator().manual_seed(9), 0.5)
    for r in range(2):
        dense = Dense(12, 36 if split == (0, 3) else 24)
        dense.weight.data = shard_tensor(dense.weight.data, split, r, 2)
        dense.parallel_(TPGroup(None, 2, r), split)
        dense.init_(torch.Generator().manual_seed(9), 0.5)
        assert torch.equal(dense.weight, shard_tensor(full.weight.detach(), split, r, 2))
        assert (dense.out_features, dense.in_features) == tuple(dense.weight.shape)


# ------------------------------------------------------------------ the world
@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX Trainer's init of vaeformer_tiny (saved by the JAX package
    as .msgpack, and as port tensors), a seeded batch of 2."""
    d = tmp_path_factory.mktemp("tp")
    cfg = j_tiny()
    x = np.random.default_rng(31).standard_normal((2, cfg.in_chans, *cfg.img_size)).astype(
        np.float32) * 0.5
    np.save(d / "batch.npy", x)
    jmodel = JVAEformer(cfg)
    mesh = j_make_mesh({"dp": 2, "tp": 2}, devices=jax.devices()[:4])
    jtr = JTrainer(jmodel, JTrainerConfig(**TCFG), mesh=mesh, seed=SEED)
    jstate = jtr.init_state(jtr.shard_batch(x))
    params = jax.device_get(jstate.params)
    j_save_variables(str(d / "vars.msgpack"), {"params": params})
    start = load_flax_variables(VAEformer(vaeformer_tiny(), device="cpu"), {"params": params})
    torch.save({k: p.detach() for k, p in start.named_parameters()}, d / "start.pt")
    return dict(dir=d, x=x, params=params, jtr=jtr, jstate=jstate, mesh=mesh)


@pytest.fixture(scope="module")
def procs(inputs):
    import inspect

    d = inputs["dir"]
    spec = dict(batch=str(d / "batch.npy"), vars=str(d / "vars.msgpack"),
                start=str(d / "start.pt"), rng=RNG, seed=SEED, steps=STEPS, tcfg=TCFG,
                noise_src="import numpy as np\n" + inspect.getsource(_shape_noise))
    (d / "w").mkdir()
    return _start(4, spec, d / "w")


@pytest.fixture(scope="module")
def jax_refs(inputs, procs):
    """While the ranks run: JAX's dp x tp forward, its Trainer's 3 steps
    under the noise patch, its tp codec's roundtrip."""
    x, params, mesh = inputs["x"], inputs["params"], inputs["mesh"]
    jmodel = JVAEformer(j_tiny())
    variables = {"params": params}
    with mesh:
        placed = j_shard_variables(mesh, variables)
        xb = jax.device_put(x, NamedSharding(mesh, P("dp")))
        forward = np.asarray(jax.jit(lambda v, b: jmodel.apply(v, b)["x_hat"])(placed, xb))
    codec = JCodec(jmodel, j_shard_variables(mesh, variables))
    codec.update()
    with mesh:
        enc = codec.compress(jax.device_put(x, NamedSharding(mesh, P("dp"))))
    decompress = np.asarray(codec.decompress(enc["strings"], enc["z_shape"])["x_hat"])

    def jq(values, mode, means=None, rng=None):
        if mode == "noise":
            return values + jnp.asarray(_shape_noise(values.shape)).astype(values.dtype)
        return j_ops.quantize(values, mode, means=means, rng=rng)

    mp = pytest.MonkeyPatch()
    for mod in (j_ebm, j_gcm):
        mp.setattr(mod, "quantize", jq)
    try:
        logs = []
        jstate = inputs["jtr"].fit([x] * STEPS, state=inputs["jstate"], num_steps=STEPS,
                                   log_fn=lambda s, m: logs.append(m))
        jstate = jax.device_get(jstate)
    finally:
        mp.undo()
    as_port = lambda tree: {k: p.detach() for k, p in load_flax_variables(
        VAEformer(vaeformer_tiny(), device="cpu"), {"params": tree}).named_parameters()}
    return dict(forward=forward, decompress=decompress, logs=logs, state=jstate,
                params=as_port(jstate.params), ema=as_port(jstate.ema.params))


@pytest.fixture(scope="module")
def ranks(inputs, procs, jax_refs):
    return _finish(procs, inputs["dir"] / "w")


@pytest.fixture(scope="module")
def one(inputs):
    """The one-process port from the same init: eval forward, gradients at
    the global batch, the codec's roundtrip."""
    model = load_flax_variables(VAEformer(vaeformer_tiny(), device="cpu"),
                                {"params": inputs["params"]})
    x = torch.from_numpy(inputs["x"])
    with torch.no_grad():
        forward = model(x)["x_hat"]
    out = model(x, training=True, generator=step_generator(RNG, 0, "cpu"))
    RateDistortionLoss()(out, x)["loss"].backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    codec = VAEformerCodec(model)
    codec.update()
    enc = codec.compress(x)
    return dict(forward=forward, grads=grads, codec_forward=codec.forward(x)["x_hat"],
                decompress=codec.decompress(enc["strings"], enc["z_shape"])["x_hat"])


def _by_dp(ranks, key):
    """The dp ranks' rows (from tp rank 0 of each) in dp order."""
    rows = sorted((r for r in ranks if r["tp"] == 0), key=lambda r: r["dp"])
    return torch.cat([r[key] for r in rows]).numpy()


def _tp_pairs(ranks):
    return [[r for r in ranks if r["dp"] == d] for d in (0, 1)]


def test_mesh_places_two_dp_rows_of_tp_pairs(ranks):
    assert sorted((r["dp"], r["tp"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    heads = ranks[0]["local_heads"]
    assert heads["g_a.blocks.1.attn"] == 1 and heads["h_s.blocks.0.attn"] == 1


def test_forward_matches_jax_dp_tp_forward(ranks, jax_refs):
    got = _by_dp(ranks, "forward")
    np.testing.assert_allclose(got, jax_refs["forward"], atol=2e-4, rtol=0)


def test_forward_matches_the_one_process_port(ranks, one):
    for pair in _tp_pairs(ranks):
        assert torch.equal(pair[0]["forward"], pair[1]["forward"])
    np.testing.assert_allclose(_by_dp(ranks, "forward"), one["forward"].numpy(), atol=2e-4,
                               rtol=0)


@pytest.mark.parametrize("which", ["dp2_tp2", "tp4"])
def test_gradients_match_the_one_process_port_leaf_by_leaf(ranks, one, which):
    """Averaged over dp and gathered over tp into the fused layout: every
    leaf within 1e-4 x max|ref| + 1e-7 (tests/test_parallel.py's bound)."""
    got = ranks[0]["grads" if which == "dp2_tp2" else "tp4_grads"]
    assert set(got) == set(one["grads"])
    for name, ref in one["grads"].items():
        scale = ref.abs().max().item() + 1e-8
        err = (got[name] - ref).abs().max().item()
        assert got[name].shape == ref.shape and err <= 1e-4 * scale + 1e-7, (name, err, scale)


def test_trajectory_losses_match_jax_trainer_on_the_same_mesh(ranks, jax_refs):
    """tests/test_torch_train.py's bound: every metric of the 3 steps
    within rtol 1e-3."""
    for r in ranks:
        assert len(r["logs"]) == len(jax_refs["logs"]) == STEPS
        for got, want in zip(r["logs"], jax_refs["logs"]):
            for k in want:
                if k != "steps_per_sec":
                    assert got[k] == pytest.approx(want[k], rel=1e-3), k


@pytest.mark.parametrize("tree", ["params", "ema"])
def test_trajectory_params_and_ema_match_jax(ranks, jax_refs, tree):
    """After 3 updates every gathered parameter and its EMA within 1e-3 of
    the leaf's largest entry (tests/test_torch_train.py's bound)."""
    for name, want in jax_refs[tree].items():
        got = ranks[0][tree][name]
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        assert got.shape == want.shape and err <= 1e-3 * scale, (name, err, scale)


def test_replicated_params_are_bitwise_equal_across_each_tp_pair(ranks):
    for pair in _tp_pairs(ranks):
        a, b = pair[0]["replicated"], pair[1]["replicated"]
        assert set(a) == set(b) and len(a) > 0
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_checkpoint_loads_into_a_one_process_trainer(ranks, inputs):
    """The tp run's files hold the one-process model's names and shapes;
    its state restores into a one-process Trainer, equal to the gathered
    state."""
    path = ranks[0]["ckpt"]
    assert all(r["ckpt"] == path for r in ranks)
    model = VAEformer(vaeformer_tiny(), device="cpu")
    saved = torch.load(path, weights_only=True)["params"]
    assert {k: tuple(v.shape) for k, v in saved.items()} == \
        {k: tuple(p.shape) for k, p in model.named_parameters()}
    tr = Trainer(model, TrainerConfig(**TCFG), seed=SEED)
    state = tr.restore(inputs["x"][:1], path=path.replace("step_", "state_"))
    assert state.step == STEPS and state.ema.steps == STEPS
    for k, p in state.params.items():
        assert torch.equal(p.detach(), ranks[0]["params"][k]), k
        assert torch.equal(state.ema.params[k], ranks[0]["ema"][k]), k


def test_checkpoint_loads_into_the_jax_package(ranks, inputs, jax_refs):
    d = inputs["dir"] / "w"
    variables = j_load_variables(str(d / "tp.msgpack"))
    got = {k: p.detach() for k, p in load_flax_variables(
        VAEformer(vaeformer_tiny(), device="cpu"), variables).named_parameters()}
    assert all(torch.equal(got[k], ranks[0]["params"][k]) for k in got)
    state = j_load_train_state(str(d / "tp_state.msgpack"), jax_refs["state"])
    assert int(state.step) == STEPS
    flat = jax.tree_util.tree_leaves(state.params)
    want = jax.tree_util.tree_leaves(variables["params"])
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(flat, want))


def test_resume_repeats_an_uninterrupted_run(ranks):
    for r in ranks:
        assert r["resumed_step"] == (2, 2)
        assert r["resume_equal"]


def test_codec_forward_matches_one_process(ranks, one):
    np.testing.assert_allclose(_by_dp(ranks, "codec_forward"), one["codec_forward"].numpy(),
                               atol=2e-4, rtol=0)


def test_codec_tp_ranks_write_identical_bytes(ranks):
    for pair in _tp_pairs(ranks):
        assert pair[0]["strings"] == pair[1]["strings"]
        assert all(len(s[0]) > 0 for s in pair[0]["strings"])


@pytest.mark.parametrize("ref", ["one_process", "jax_tp_codec"])
def test_codec_decompress_matches(ranks, one, jax_refs, ref):
    want = one["decompress"].numpy() if ref == "one_process" else jax_refs["decompress"]
    for pair in _tp_pairs(ranks):
        assert torch.equal(pair[0]["decompress"], pair[1]["decompress"])
    np.testing.assert_allclose(_by_dp(ranks, "decompress"), want, atol=2e-3, rtol=0)


def test_train_cli_with_a_dp_tp_mesh_writes_the_trainers_checkpoint(ranks):
    cli_path, own_path = ranks[0]["cli"]
    assert cli_path.endswith("step_2.pt") and own_path.endswith("step_2.pt")
    a = torch.load(cli_path, weights_only=True)["params"]
    b = torch.load(own_path, weights_only=True)["params"]
    assert set(a) == set(b) == set(dict(VAEformer(vaeformer_tiny(), device="cpu")
                                        .named_parameters()))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_tp4_keeps_two_head_attention_whole_and_splits_the_mlps(ranks, one):
    placement, heads = ranks[0]["tp4_placement"], ranks[0]["tp4_local_heads"]
    assert all(h == 2 for h in heads.values())
    assert all(v is None for k, v in placement.items() if ".attn." in k)
    assert placement["g_a.blocks.0.mlp.fc1.weight"] == (0, 1)
    assert placement["h_a.quan_mlp.fc2.weight"] == (1, 1)
    for r in ranks:
        np.testing.assert_allclose(r["tp4_forward"].numpy(), one["forward"].numpy(), atol=2e-4,
                                   rtol=0)
