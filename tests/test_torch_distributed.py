"""The port's data- and sequence-parallel paths on real gloo clusters.

2- and 4-process ``torch.distributed`` worlds (gloo, on the CPU) are
spawned on 127.0.0.1 at a free port, as ``tests/test_distributed.py``
spawns its JAX clusters; every ``communicate()`` has its own timeout, so a
hung rank fails the test instead of the suite. Each world runs every task
once (a module fixture) and rank 0 reports:

  - the dp train step (2 ranks at local batch 1) against the one-process
    step at the global batch 2;
  - ``tools/recompress.main`` at 2 and 4 ranks: every ``.bin`` byte for
    byte the one-process run's and the JAX package's ``recompress_batch``
    (float32 vaeformer_tiny, both from the JAX init, which the ranks read
    from the JAX package's ``.msgpack`` file);
  - ``decompress_batch`` against the one-process decompress;
  - ``ring_attention_sharded`` at sp = 2 and 4 against JAX's and the plain
    attention, within 2e-5;
  - 4 ranks on 2 files: the ranks with an empty work slice (rank 0, which
    hosts the store, among them) hold the finish barrier and all exit 0.

Then, in this process, ``init_distributed`` is a no-op without a cluster
and refuses an incomplete spec.
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

from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import VAEformerCodec as JCodec
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu.ops.attention import _reference_attention
from cra5_tpu.ops.ring_attention import ring_attention_sharded as j_ring
from cra5_tpu.parallel import make_mesh as j_make_mesh
from cra5_tpu.tools.recompress import recompress_batch as j_recompress_batch
from cra5_tpu.train.checkpoints import save_variables as j_save_variables
from cra5_tpu_torch.api.bitstream import load_bin
from cra5_tpu_torch.models.vaeformer import VAEformer, VAEformerCodec, vaeformer_tiny
from cra5_tpu_torch.parallel import init_distributed, process_count
from cra5_tpu_torch.tools import recompress
from cra5_tpu_torch.train import Trainer, TrainerConfig
from cra5_tpu_torch.train.checkpoints import load_variables

REPO = Path(__file__).resolve().parents[1]
N_FILES = 4
RING_SHAPE = (1, 2, 24, 16)  # N divides over 2 and 4 ranks
TIMEOUT = 240  # seconds for each rank's communicate()

WORKER = r'''
import json, os, pickle, sys
import numpy as np, torch
spec, out_dir = json.loads(sys.argv[1]), sys.argv[2]
from cra5_tpu_torch.parallel import init_distributed, make_mesh, process_index
from cra5_tpu_torch.tools import recompress
rank = init_distributed(device="cpu")
res = {}
if spec.get("dp_step"):
    from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_tiny
    from cra5_tpu_torch.train import Trainer, TrainerConfig
    x = np.load(spec["dp_step"])
    tr = Trainer(VAEformer(vaeformer_tiny(), device="cpu"), TrainerConfig(use_ema=False),
                 mesh=make_mesh({"dp": -1}, device_type="cpu"), seed=3)
    b = x.shape[0] // torch.distributed.get_world_size()
    batch = tr.shard_batch(x[rank * b:(rank + 1) * b])
    state = tr.init_state(batch)
    state, m = tr._step_fn(state, batch, 7)
    res["dp_metrics"] = {k: float(v) for k, v in m.items()}
    res["dp_params"] = {k: p.detach().clone() for k, p in state.params.items()}
    res["global_shape"] = tuple(batch.shape)
    from cra5_tpu_torch.parallel import fetch_tree
    res["fetched"] = fetch_tree({"x": batch})["x"]
for name, args in spec.get("recompress", {}).items():
    res[name] = recompress.main(args)
if spec.get("decompress"):
    from cra5_tpu_torch.api.bitstream import load_bin
    from cra5_tpu_torch.tools.recompress import build_codec, decompress_batch
    codec = build_codec("tiny", spec["decompress"]["checkpoint"], "cpu")
    bins = [load_bin(p) for p in spec["decompress"]["bins"]]
    strings = [[b[0][0][0] for b in bins], [b[0][1][0] for b in bins]]
    res["x_hat"] = decompress_batch(codec, make_mesh({"dp": -1}, device_type="cpu"),
                                    strings, bins[0][1])
if spec.get("ring"):
    from cra5_tpu_torch.ops.ring_attention import ring_attention_sharded
    q, k, v = (torch.from_numpy(a) for a in np.load(spec["ring"]))
    res["ring"] = ring_attention_sharded(q, k, v, make_mesh({"sp": -1}, device_type="cpu"))
if rank == 0:
    with open(os.path.join(out_dir, "rank0.pkl"), "wb") as f:
        pickle.dump(res, f)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cluster(n: int, spec: dict, out_dir: Path) -> dict:
    """Run WORKER on ``n`` gloo ranks; rank 0's results."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("CRA5_TPU_COORDINATOR", "CRA5_TPU_NUM_PROCESSES", "CRA5_TPU_PROCESS_ID",
                        "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", CRA5_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}",
               CRA5_TPU_NUM_PROCESSES=str(n),
               PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, json.dumps(spec), str(out_dir)],
                              env={**env, "CRA5_TPU_PROCESS_ID": str(r)}, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0, f"rank {r} of {n} exited {rc}:\n{err[-3000:]}"
    with open(out_dir / "rank0.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX init of vaeformer_tiny saved by the JAX package as
    .msgpack, N_FILES seeded timesteps, a batch of 2 and ring inputs."""
    d = tmp_path_factory.mktemp("dist")
    cfg = j_tiny()
    rng = np.random.default_rng(21)
    xs = rng.standard_normal((N_FILES, cfg.in_chans, *cfg.img_size)).astype(np.float32)
    (d / "in").mkdir()
    for i, x in enumerate(xs):
        np.save(d / "in" / f"ts{i}.npy", x)
    (d / "in2").mkdir()
    for i in range(2):
        np.save(d / "in2" / f"ts{i}.npy", xs[i])
    variables = jax.device_get(JVAEformer(cfg).init(jax.random.PRNGKey(4), jnp.asarray(xs[:1])))
    j_save_variables(str(d / "vars.msgpack"), variables)
    np.save(d / "batch.npy", xs[:2] * 0.5)
    np.save(d / "ring.npy", rng.standard_normal((3, *RING_SHAPE)).astype(np.float32))
    return dict(dir=d, xs=xs, variables=variables)


def _rc_args(inputs, src: str, out: str):
    d = inputs["dir"]
    return [str(d / src), "-o", str(d / out), "--config", "tiny", "--device", "cpu",
            "--batch", "1", "--checkpoint", str(d / "vars.msgpack")]


@pytest.fixture(scope="module")
def single(inputs):
    """The one-process runs: recompress.main in this process, and the
    decompress of its bins."""
    d = inputs["dir"]
    assert recompress.main(_rc_args(inputs, "in", "out1")) == 0
    assert process_count() == 1  # main joined no world here
    codec = recompress.build_codec("tiny", str(d / "vars.msgpack"), "cpu")
    bins = [load_bin(str(d / "out1" / f"ts{i}.bin")) for i in range(N_FILES)]
    strings = [[b[0][0][0] for b in bins[:2]], [b[0][1][0] for b in bins[:2]]]
    x_hat = recompress.decompress_batch(codec, None, strings, bins[0][1])
    return dict(x_hat=x_hat)


@pytest.fixture(scope="module")
def two(inputs):
    d = inputs["dir"]
    (d / "w2").mkdir()
    spec = dict(dp_step=str(d / "batch.npy"), ring=str(d / "ring.npy"),
                recompress={"rc": _rc_args(inputs, "in", "out2")},
                decompress=dict(checkpoint=str(d / "vars.msgpack"),
                                bins=[str(d / "out2" / f"ts{i}.bin") for i in range(2)]))
    return _cluster(2, spec, d / "w2")


@pytest.fixture(scope="module")
def four(inputs):
    d = inputs["dir"]
    (d / "w4").mkdir()
    spec = dict(ring=str(d / "ring.npy"),
                recompress={"rc": _rc_args(inputs, "in", "out4"),
                            "rc_short": _rc_args(inputs, "in2", "out4_short")})
    return _cluster(4, spec, d / "w4")


def test_dp_step_equals_the_one_process_step_at_the_global_batch(inputs, two):
    """2 ranks at local batch 1 against one process at batch 2, the same
    seeded init, rng and step: each rank draws the global batch's noise and
    keeps its rows, and the gradients are averaged before the clip. On the
    CPU in float32 only the row count of each matmul differs, so metrics
    agree within rtol 1e-5 and the updated params within 1e-6 (the first
    Adam update moves each by up to lr = 1e-4)."""
    x = np.load(inputs["dir"] / "batch.npy")
    tr = Trainer(VAEformer(vaeformer_tiny(), device="cpu"), TrainerConfig(use_ema=False), seed=3)
    batch = tr.shard_batch(x)
    state = tr.init_state(batch)
    init = {k: p.detach().clone() for k, p in state.params.items()}
    state, m = tr._step_fn(state, batch, 7)
    assert two["global_shape"] == tuple(batch.shape)
    assert torch.equal(two["fetched"], torch.from_numpy(x))  # fetch_tree all-gathers the rows
    assert set(two["dp_metrics"]) == set(m)
    for k, v in m.items():
        assert two["dp_metrics"][k] == pytest.approx(float(v), rel=1e-5), k
    for k, p in state.params.items():
        err = (two["dp_params"][k] - p.detach()).abs().max().item()
        assert err <= 1e-6, (k, err)
    assert not torch.equal(two["dp_params"]["quant_conv.weight"], init["quant_conv.weight"])


@pytest.mark.parametrize("ranks", [2, 4])
def test_recompressed_bins_equal_one_process_and_jax(inputs, single, two, four, ranks):
    """Every .bin of the 2- and 4-rank runs is byte for byte the
    one-process run's and holds the JAX package's recompress_batch strings
    over a dp mesh of 4 virtual devices (float32 tiny: symbols and indexes
    are exact across the packages)."""
    d = inputs["dir"]
    cluster = two if ranks == 2 else four
    assert cluster["rc"] == 0
    jcodec = JCodec(JVAEformer(j_tiny()), inputs["variables"])
    jcodec.update()
    jout = j_recompress_batch(jcodec, j_make_mesh({"dp": 4}), inputs["xs"])
    for i in range(N_FILES):
        one = (d / "out1" / f"ts{i}.bin").read_bytes()
        assert (d / f"out{ranks}" / f"ts{i}.bin").read_bytes() == one, i
        strings, _ = load_bin(str(d / "out1" / f"ts{i}.bin"))
        assert strings[0][0] == jout["strings"][0][i] and strings[1][0] == jout["strings"][1][i]


def test_dp_decompress_equals_single_device(single, two):
    """decompress_batch on 2 ranks (a row each, gathered) equals the
    one-process decompress of the same two bins: on the CPU the batch-2
    decode is bitwise two batch-1 decodes (tests/test_torch_codec.py)."""
    assert two["x_hat"].shape == single["x_hat"].shape
    np.testing.assert_array_equal(two["x_hat"], single["x_hat"])


@pytest.mark.parametrize("ranks", [2, 4])
def test_ring_attention_matches_jax_and_plain(inputs, two, four, ranks):
    q, k, v = np.load(inputs["dir"] / "ring.npy")
    got = (two if ranks == 2 else four)["ring"].numpy()
    want = np.asarray(j_ring(*(jnp.asarray(a) for a in (q, k, v)),
                             j_make_mesh({"sp": ranks}), "sp"))
    plain = np.asarray(_reference_attention(*(jnp.asarray(a) for a in (q, k, v)), 16 ** -0.5))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, plain, atol=2e-5, rtol=0)


def test_ranks_with_an_empty_work_slice_hold_the_barrier(inputs, four):
    """2 files on 4 ranks: ranks 0 and 2 own no file, return through the
    finish barrier, and every rank exits 0 with both bins written and equal
    to the one-process run's."""
    d = inputs["dir"]
    assert four["rc_short"] == 0
    for i in range(2):
        assert (d / "out4_short" / f"ts{i}.bin").read_bytes() == \
            (d / "out1" / f"ts{i}.bin").read_bytes()


def test_init_distributed_is_a_noop_single_process(monkeypatch):
    for k in ("CRA5_TPU_COORDINATOR", "CRA5_TPU_DISTRIBUTED", "MASTER_ADDR", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed(device="cpu") == 0
    assert init_distributed(num_processes=1, process_id=0, coordinator="127.0.0.1:1",
                            device="cpu") == 0
    assert process_count() == 1 and not torch.distributed.is_initialized()


def test_init_distributed_refuses_an_incomplete_spec(monkeypatch):
    for k in ("CRA5_TPU_NUM_PROCESSES", "CRA5_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="num_processes"):
        init_distributed(coordinator="127.0.0.1:1", device="cpu")
    monkeypatch.setenv("CRA5_TPU_DISTRIBUTED", "1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_distributed(device="cpu")


def test_msgpack_variables_load_into_the_port(inputs):
    """The ranks' weights: the JAX package's .msgpack file through the
    port's reader and the model's layout gives the flax init's values."""
    model = VAEformer(vaeformer_tiny(), device="cpu")
    params = load_variables(str(inputs["dir"] / "vars.msgpack"), model=model)
    qkv = np.asarray(inputs["variables"]["params"]["g_a"]["blocks_1"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(params["g_a.blocks.1.attn.qkv.weight"].numpy(), qkv.T)
    with pytest.raises(ValueError, match="needs the model"):
        load_variables(str(inputs["dir"] / "vars.msgpack"))
