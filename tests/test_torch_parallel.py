"""The port's mesh resolution, Megatron specs and work split against the
JAX package's (``cra5_tpu/parallel``), on the 8 virtual CPU devices of
``tests/conftest.py``; and the tensor-parallel placement cut to each tp
rank's shards (the ranks themselves: tests/test_torch_tensor_parallel.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import cra5_tpu.parallel.distributed as j_dist
from cra5_tpu.models.vaeformer import VAEformer as JVAEformer
from cra5_tpu.models.vaeformer import vaeformer_tiny as j_tiny
from cra5_tpu.parallel import make_mesh as j_make_mesh
from cra5_tpu.parallel import mesh_param_specs as j_mesh_param_specs
from cra5_tpu.parallel import vaeformer_param_specs as j_vaeformer_param_specs
from cra5_tpu_torch.convert import flax_layout
from cra5_tpu_torch.models.vaeformer import VAEformer, vaeformer_tiny
from cra5_tpu_torch.parallel import (batch_sharding, distributed, local_work_slice, make_mesh,
                                     mesh_param_specs, replicate, shard_variables,
                                     vaeformer_param_specs)
from cra5_tpu_torch.parallel.mesh import mesh_axes

MESHES = [None, {}, {"dp": -1}, {"dp": 4}, {"dp": 2, "tp": 4}, {"dp": -1, "tp": 2},
          {"tp": -1, "dp": 2}, {"dp": 3}, {"sp": 8}, {"dp": 2, "sp": -1},
          {"dp": 1, "tp": 1}]
BAD = [{"dp": -1, "tp": -1}, {"dp": -1, "tp": 3}, {"dp": 16}, {"dp": 4, "tp": 4}]


@pytest.mark.parametrize("axes", MESHES, ids=str)
def test_mesh_axes_resolve_as_jax_make_mesh(axes):
    want = j_make_mesh(axes)
    assert len(jax.devices()) == 8
    assert mesh_axes(axes, 8) == dict(want.shape)
    assert list(mesh_axes(axes, 8)) == list(want.axis_names)


@pytest.mark.parametrize("axes", BAD, ids=str)
def test_mesh_axes_refuse_what_jax_refuses(axes):
    with pytest.raises(ValueError) as want:
        j_make_mesh(axes)
    with pytest.raises(ValueError) as got:
        mesh_axes(axes, 8)
    assert str(got.value) == str(want.value)


def test_make_mesh_over_a_world_of_one_rank():
    """A single process joins a world of one rank (an in-process store):
    the default mesh is dp over it, batches are Shard(0) over dp."""
    from torch.distributed.tensor import Replicate, Shard

    try:
        mesh = make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("dp",) and mesh.size() == 1
        assert batch_sharding(mesh) == [Shard(0)] and replicate(mesh) == [Replicate()]
        mesh2 = make_mesh({"dp": -1, "sp": 1}, device_type="cpu")
        assert batch_sharding(mesh2) == [Shard(0), Replicate()]
        assert local_work_slice(5) == slice(0, 5)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def params():
    cfg = j_tiny()
    x = jnp.zeros((1, cfg.in_chans, *cfg.img_size), jnp.float32)
    jparams = jax.device_get(JVAEformer(cfg).init(jax.random.PRNGKey(0), x)["params"])
    model = VAEformer(vaeformer_tiny(), device="cpu")
    return jparams, model


def _jax_spec_at(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tuple(tree)


@pytest.mark.parametrize("mesh", [None, {"dp": 8}, {"dp": 4, "tp": 2}, {"dp": 2, "tp": 4},
                                  {"tp": 8}], ids=str)
def test_param_specs_match_jax_name_by_name(params, mesh):
    """Every port parameter's spec is the JAX spec at its flax path (a
    Linear weight's reversed: the port stores the kernel transposed), the
    Megatron split and the replicate-where-it-does-not-divide rule alike."""
    jparams, model = params
    named = dict(model.named_parameters())
    if mesh is None:
        want, got = j_vaeformer_param_specs(jparams), vaeformer_param_specs(named)
    else:
        want, got = j_mesh_param_specs(j_make_mesh(mesh), jparams), mesh_param_specs(mesh, named)
    assert set(got) == set(named)
    split = 0
    for name, (path, layout) in flax_layout(model).items():
        spec = _jax_spec_at(want, path)
        assert got[name] == (spec[::-1] if layout == "dense" else spec), name
        split += any(a is not None for a in spec)
    assert split > 0 if mesh in (None, {"dp": 4, "tp": 2}, {"dp": 2, "tp": 4}, {"tp": 8}) \
        else split == 0


@pytest.mark.parametrize("procs", range(1, 9))
def test_local_work_slice_matches_jax(monkeypatch, procs):
    for pid in range(procs):
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        monkeypatch.setattr(jax, "process_count", lambda: procs)
        monkeypatch.setattr(distributed, "process_index", lambda pid=pid: pid)
        monkeypatch.setattr(distributed, "process_count", lambda: procs)
        for n in range(18):
            assert local_work_slice(n) == j_dist.local_work_slice(n), (pid, procs, n)


def test_shard_variables_and_put_tree_give_each_tp_rank_its_shards(monkeypatch):
    """Each rank of a tp axis of 2 (its index stood in for the mesh's)
    takes its shards of the split parameters, which join back to the full
    tensors, and the replicated ones as they are; put_tree (a world of one:
    no broadcast) places the same shards."""
    from cra5_tpu_torch.parallel import gather_tensor, mesh
    from cra5_tpu_torch.parallel.tensor_parallel import model_placement

    model = VAEformer(vaeformer_tiny(), device="cpu").reset_parameters(0)
    full = {k: p.detach() for k, p in model.named_parameters()}
    placement = model_placement(model, 2)
    assert sum(v is not None for v in placement.values()) > 0
    shards = []
    for r in range(2):
        monkeypatch.setattr(mesh, "axis_group", lambda m, axis, r=r: (None, 2, r))
        shards.append(shard_variables(None, full, placement))
        put = distributed.put_tree(None, dict(full), placement)
        assert all(torch.equal(put[k], shards[r][k]) for k in full)
    for k, v in full.items():
        if placement[k] is None:
            assert shards[0][k] is v and shards[1][k] is v
        else:
            assert shards[0][k].numel() * 2 == v.numel()
        assert torch.equal(gather_tensor([s[k] for s in shards], placement[k]), v), k
