"""The port's logical-axis sharding (`repro_torch.sharding`, the models'
spec hooks, context-parallel attention, restore onto a mesh) against the
JAX package's.

Specs: on the production meshes, (16, 16) and (2, 16, 16), as the
reference's `jax.sharding.AbstractMesh` and the port's `MeshSpec`, with and
without `SERVING_RULES`, every param spec (`param_pspecs`, shape-fitted)
and the unfitted spec of every param's logical tuple, of all ten configs
at full width, every cache spec and every input spec of the four SHAPES
equal the reference's exactly (`tuple(spec)`); so does `heads_shardable`.

Numbers: the context-parallel branch (GQA scores and output over the key
sequence, K/V not repeated) runs in the reference under the rules of a
real (1, 1) CPU mesh, where `heads_shardable` is False, and in the port
under a (1, 1) `MeshSpec`; on `reduced()` gemma (MQA) and qwen3 (GQA,
2 query heads a K/V head) in float32, the reference's weights carried
across, prefill logits and the loss agree at 1e-5 of the largest logit
(measured well under it), and each equals the port's own head-parallel
branch at the same tolerance.  A checkpoint saved unsharded restores as
DTensors on a (1, 1) DeviceMesh of a one-rank gloo group, values equal,
as the reference's `test_elastic_reshard_on_restore`.
"""
import os
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro import sharding as RS
from repro.configs import arch_ids as r_arch_ids
from repro.configs import get_config as r_get_config
from repro.models import SHAPES as R_SHAPES
from repro.models import attention as RA
from repro.models import build_model as r_build_model
from repro.launch.mesh import make_mesh
from repro_torch import sharding
from repro_torch.configs import arch_ids, get_config
from repro_torch.launch.mesh import MeshSpec, device_mesh
from repro_torch.models import SHAPES, build_model
from repro_torch.models import attention as TA

from torch_lm_ref import (batch_for, carry, close_scaled, one_torch_thread,
                          port_prefill, to_jax, to_torch)  # noqa: F401

MESHES = {"single": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"default": None, "serving": RS.SERVING_RULES}
TOL = 1e-5


@pytest.fixture(autouse=True)
def no_group_left():
    """No test leaves a default process group up."""
    yield
    assert not dist.is_initialized()


def _meshes(name):
    dims, axes = MESHES[name]
    return AbstractMesh(dims, axes), MeshSpec(dims, axes)


def _tuples(tree):
    """A tree of specs (dicts, tuples of dicts) with every spec, the
    reference's PartitionSpec or the port's tuple, as a plain tuple."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        return tuple(_tuples(t) for t in tree)
    return tuple(tree)


def test_rule_tables_equal():
    assert sharding.DEFAULT_RULES == RS.DEFAULT_RULES
    assert sharding.SERVING_RULES == RS.SERVING_RULES
    assert arch_ids() == r_arch_ids()


@pytest.mark.parametrize("arch", r_arch_ids())
@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_specs_equal_reference(mesh, rules, arch):
    r_mesh, t_mesh = _meshes(mesh)
    r_model = r_build_model(r_get_config(arch))
    model = build_model(get_config(arch))
    with RS.use_mesh_rules(r_mesh, RULES[rules]), \
            sharding.use_mesh_rules(t_mesh, RULES[rules]):
        want = {k: tuple(v) for k, v in r_model.param_pspecs().items()}
        got = model.param_pspecs()
        assert got == want
        for path, d in model.param_defs().items():
            assert sharding.spec_for(d.logical) == tuple(
                RS.spec_for(d.logical)), path
        assert _tuples(model.cache_pspecs()) == _tuples(
            r_model.cache_pspecs())
        for name in SHAPES:
            got = model.input_pspecs(SHAPES[name])
            want = r_model.input_pspecs(R_SHAPES[name])
            assert set(got) == set(want)
            for k in want:
                assert _tuples(got[k]) == _tuples(want[k]), (name, k)
            specs = model.input_specs(SHAPES[name])
            r_specs = r_model.input_specs(R_SHAPES[name])
            for k in ("tokens", "labels", "frames", "patches"):
                if k in r_specs:
                    assert tuple(specs[k].shape) == r_specs[k].shape, k
    # outside the contexts: no mesh, empty specs
    assert sharding.current_mesh() is None
    assert sharding.spec_for(("batch", "seq")) == ()


def test_sanitize_and_placements():
    mesh = MeshSpec((2, 16, 16), ("pod", "data", "model"))
    r_mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    for spec, shape in [((("pod", "data"), "model"), (64, 56)),
                        ((("pod", "data"), None), (16, 8)),
                        (("model", "model"), (32, 32))]:
        assert sharding.sanitize_spec(spec, shape, mesh) == tuple(
            RS.sanitize_spec(jax.sharding.PartitionSpec(*spec), shape,
                             r_mesh))
    from torch.distributed.tensor import Replicate, Shard
    assert sharding.placements_for((("pod", "data"), None, "model"),
                                   mesh) == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements_for((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())


def test_constrain_without_mesh_is_identity():
    x = torch.randn(4, 8, 2)
    assert sharding.constrain(x, "batch", "seq", None) is x
    # a plain tensor under a mesh context passes through unchanged
    with sharding.use_mesh_rules(MeshSpec((16, 16), ("data", "model"))):
        assert sharding.constrain(x, "batch", "seq", None) is x
    assert sharding.sharding_for(("batch",)) is None


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_heads_shardable_equal_reference(mesh):
    r_mesh, t_mesh = _meshes(mesh)
    seen = set()
    for arch in r_arch_ids():
        with RS.use_mesh_rules(r_mesh), sharding.use_mesh_rules(t_mesh):
            want = RA.heads_shardable(r_get_config(arch))
            assert TA.heads_shardable(get_config(arch)) == want, arch
        seen.add(want)
    assert seen == {True, False}      # both branches are exercised
    assert TA.heads_shardable(get_config("gemma-2b"))   # no mesh: head TP


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-1.7b"])
def test_context_parallel_branch_equals_reference(arch):
    r_model, r_params, model, params = carry(arch)
    assert model.cfg.n_heads > model.cfg.n_kv          # GQA / MQA
    batch = batch_for(model.cfg, 3)
    r_mesh = make_mesh((1, 1), ("data", "model"))
    t_mesh = MeshSpec((1, 1), ("data", "model"))
    head_tp = port_prefill(model, params, batch)
    with RS.use_mesh_rules(r_mesh):
        assert not RA.heads_shardable(r_model.cfg)
        want = np.asarray(r_model.prefill(r_params, to_jax(
            {k: v for k, v in batch.items() if k != "labels"})))
        r_loss = float(r_model.loss(r_params, to_jax(batch)))
    with sharding.use_mesh_rules(t_mesh):
        assert not TA.heads_shardable(model.cfg)
        got = port_prefill(model, params, batch)
        with torch.inference_mode():
            loss = float(model.loss(params, to_torch(batch)))
    close_scaled(got, want, TOL)
    close_scaled(got, head_tp, TOL)
    np.testing.assert_allclose(loss, r_loss, rtol=TOL)


def test_restore_with_placements():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.checkpoint.manager import CheckpointManager
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(os.path.join(d, "ckpt"))
        tree = {"w": torch.arange(16.0).reshape(4, 4),
                "b": {"c": torch.ones(4, dtype=torch.int32)}}
        mgr.save(1, tree)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = device_mesh(MeshSpec((1, 1), ("data", "model")))
            want = {"w": (Shard(0), Replicate()), "b": {"c": None}}
            got, _ = mgr.restore(1, tree, mesh=mesh, placements=want)
            assert isinstance(got["w"], DTensor)
            assert tuple(got["w"].placements) == want["w"]
            np.testing.assert_array_equal(got["w"].full_tensor().numpy(),
                                          tree["w"].numpy())
            assert type(got["b"]["c"]) is torch.Tensor
            step, got2, _ = mgr.restore_latest(tree, mesh=mesh,
                                               placements=want)
            assert step == 1 and isinstance(got2["w"], DTensor)
        finally:
            dist.destroy_process_group()
