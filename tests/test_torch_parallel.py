"""The port's mesh vocabulary (ray_tpu_torch.parallel) against the JAX
package's (ray_tpu.parallel) on the CPU.

- ``ShardingRules.mesh_axes`` for every leaf of nano GPT, nano Llama (GQA)
  and nano MoE GPT, on the meshes of ``tests/test_models.py`` (``{data 2,
  tensor 4}``, ``{fsdp 8}``, ``{data 2, pipeline 2, tensor 2}``, ``{pipeline
  2, context 2, tensor 2}``), ``{tensor 4}`` (2 heads: replicated) and the
  expert meshes ``{data 2, expert 2}`` and ``{expert 2, tensor 2}``: the
  specs must be equal, entry for entry. The JAX side runs on the 8 virtual
  devices ``tests/conftest.py`` gives it.
- ``MeshSpec``'s shape and axis order, and a wrong device count raising.
- The DTensor placements a spec becomes.
- The pipeline's ``to_stages`` against the JAX package's on the same
  arrays, and its microbatch counts: the reference's default M and its
  split over batch shards.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from ray_tpu.models import gpt as jgpt, llama as jllama
from ray_tpu.parallel import MeshSpec as JMeshSpec, ShardingRules as JRules
from ray_tpu_torch.models import gpt as tgpt, llama as tllama
from ray_tpu_torch.parallel import AXIS_ORDER, MeshSpec, ShardingRules
from ray_tpu_torch.parallel.mesh import spec_placements

MESHES = {
    "data2_tensor4": dict(data=2, tensor=4),
    "fsdp8": dict(fsdp=8),
    "data2_pipeline2_tensor2": dict(data=2, pipeline=2, tensor=2),
    "pipeline2_context2_tensor2": dict(pipeline=2, context=2, tensor=2),
    "tensor4": dict(tensor=4),
    "data2_expert2": dict(data=2, expert=2),
    "expert2_tensor2": dict(expert=2, tensor=2),
}
MODELS = {
    "gpt_nano": ((jgpt, jgpt.GPTConfig.nano(dtype=jnp.float32)),
                 (tgpt, tgpt.GPTConfig.nano(dtype=torch.float32))),
    "llama_nano_gqa": ((jllama, jllama.LlamaConfig.nano(dtype=jnp.float32)),
                       (tllama, tllama.LlamaConfig.nano(dtype=torch.float32))),
    "moe_gpt_nano": ((jgpt, jgpt.GPTConfig.nano(dtype=jnp.float32, moe_experts=4)),
                     (tgpt, tgpt.GPTConfig.nano(dtype=torch.float32, moe_experts=4))),
}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _leaves(sub, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def _axes_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _axes_leaves(sub, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("model_name", list(MODELS))
def test_mesh_axes_equal_the_jax_packages(model_name, mesh_name):
    (jmod, jcfg), (tmod, tcfg) = MODELS[model_name]
    sizes = MESHES[mesh_name]
    jspec = JMeshSpec(**sizes)
    jmesh = jspec.build(jax.devices()[: jspec.num_devices])
    shapes = _leaves(jax.eval_shape(lambda: jmod.init_params(jcfg, jax.random.PRNGKey(0))))
    tshapes = {k: tuple(v.shape) for k, v in _leaves(tmod.init_params(tcfg, 0, "meta")).items()}
    assert {k: tuple(v.shape) for k, v in shapes.items()} == tshapes
    jaxes = _axes_leaves(jmod.param_logical_axes(jcfg))
    taxes = _axes_leaves(tmod.param_logical_axes(tcfg))
    assert jaxes == taxes
    jrules, trules = JRules(), ShardingRules()
    got = {name: trules.mesh_axes(ax, mesh=MeshSpec(**sizes), shape=tshapes[name])
           for name, ax in taxes.items()}
    want = {name: tuple(jrules.mesh_axes(ax, mesh=jmesh, shape=shapes[name].shape))
            for name, ax in jaxes.items()}
    assert got == want
    if model_name == "moe_gpt_nano" and "expert2" in mesh_name:
        # The experts split over expert; their hidden dim over tensor.
        tensor = "tensor" if "tensor2" in mesh_name else None
        assert got["blocks.moe.fc_w"] == (None, "expert", None, tensor)
        assert got["blocks.moe.proj_w"] == (None, "expert", tensor, None)
        assert got["blocks.moe.router_w"] == (None, None, None)
    if mesh_name == "tensor4" and model_name == "gpt_nano":
        # 2 heads on tensor=4: replicated; the 256-wide MLP still splits.
        assert got["blocks.qkv_w"] == (None, None, None, None, None)
        assert got["blocks.fc_w"] == (None, None, "tensor")
    # The batch and the rules without a mesh.
    for axes in (("batch", "sequence", "embed"), ("embed", "mlp"), ("batch", None, "embed")):
        assert trules.mesh_axes(axes) == tuple(jrules.mesh_axes(axes))


def test_mesh_spec_shape_order_and_placements():
    spec = MeshSpec(data=2, tensor=4)
    assert AXIS_ORDER == ("data", "fsdp", "pipeline", "expert", "context", "tensor")
    assert spec.shape == tuple(JMeshSpec(data=2, tensor=4).shape) == (2, 1, 1, 1, 1, 4)
    assert spec.num_devices == 8
    assert MeshSpec.from_dict({"fsdp": 4}) == MeshSpec(fsdp=4) == MeshSpec().replace(fsdp=4)
    assert MeshSpec.for_data_parallel(4) == MeshSpec(data=4)
    from torch.distributed.tensor import Replicate, Shard

    # (batch over (data, fsdp), sequence over context): dim 0 split over
    # data then fsdp, as the JAX PartitionSpec tuple splits it.
    assert spec_placements((("data", "fsdp"), "context")) == [
        Shard(0), Shard(0), Replicate(), Replicate(), Shard(1), Replicate()]
    rules = ShardingRules()
    mesh = MeshSpec(fsdp=2, tensor=2)
    assert rules.placements(("layers", "embed", None, "heads", None), mesh, (2, 64, 3, 2, 32)) == [
        Replicate(), Shard(1), Replicate(), Replicate(), Replicate(), Shard(3)]
    with pytest.raises(ValueError, match="not in AXIS_ORDER"):
        spec_placements((("fsdp", "data"),))


def test_param_shardings_are_the_rules_placements_of_each_leaf():
    from ray_tpu_torch.models import param_shardings

    from torch.distributed.tensor import Replicate, Shard

    cfg = tllama.LlamaConfig.nano(dtype=torch.float32)
    mesh = MeshSpec(fsdp=2, tensor=2)
    got = param_shardings(cfg, mesh)
    # (L, d, kv heads, hd): embed over fsdp, kv heads over tensor.
    assert got["blocks"]["wk"] == [Replicate(), Shard(1), Replicate(), Replicate(), Replicate(),
                                   Shard(2)]
    assert got["final_norm"] == [Replicate()] * 6
    shapes = _leaves(tllama.init_params(cfg, 0, "meta"))
    axes = _axes_leaves(tllama.param_logical_axes(cfg))
    flat = _leaves(got)
    for name in shapes:
        assert flat[name] == ShardingRules().placements(axes[name], mesh, shapes[name].shape)


def test_mesh_spec_wrong_device_count():
    # No process group: a world of one, which a 3-device mesh cannot take.
    with pytest.raises(ValueError, match="wants 3 devices"):
        MeshSpec(data=3).build(device="cpu")
    jspec = dataclasses.replace(JMeshSpec(), data=3)
    with pytest.raises(ValueError):
        jspec.build()  # 8 virtual devices


def test_to_stages_matches_the_jax_packages():
    import numpy as np

    from ray_tpu.parallel.pipeline import to_stages as j_to_stages
    from ray_tpu_torch.parallel.pipeline import to_stages

    blocks = {"w": np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3, 2),
              "moe": {"b": np.arange(8, dtype=np.float32).reshape(4, 2)}}
    want = j_to_stages(jax.tree.map(jnp.asarray, blocks), 2)
    got = to_stages({"w": torch.as_tensor(blocks["w"]),
                     "moe": {"b": torch.as_tensor(blocks["moe"]["b"])}}, 2)
    assert torch.equal(got["w"], torch.as_tensor(np.asarray(want["w"])))
    assert torch.equal(got["moe"]["b"], torch.as_tensor(np.asarray(want["moe"]["b"])))
    with pytest.raises(ValueError, match="not divisible"):
        to_stages({"w": torch.zeros(3, 2)}, 2)


def test_microbatches_default_and_split_over_batch_shards():
    from types import SimpleNamespace

    from ray_tpu_torch.parallel.pipeline import default_microbatches, microbatches

    assert default_microbatches(16, 2) == 4 and default_microbatches(4, 4) == 4
    assert default_microbatches(6, 2) == 2
    # B 64 over 2 data ranks, 2 stages: M 4, two microbatches per shard.
    assert microbatches(SimpleNamespace(batch_shards=2, pp=2), 32) == (4, 2)
    assert microbatches(SimpleNamespace(batch_shards=1, pp=2), 16, 8) == (8, 8)
    with pytest.raises(ValueError, match="does not split over 4 batch shards"):
        microbatches(SimpleNamespace(batch_shards=4, pp=2), 2, 2)
    with pytest.raises(ValueError, match="do not divide its 6 rows"):
        microbatches(SimpleNamespace(batch_shards=1, pp=2), 6, 4)
