"""The port's Switch MoE (ray_tpu_torch.models.moe, and GPT-2 with
``moe_experts > 0``) against the JAX package's on the CPU: the MoE layer alone
on numpy inputs, with a capacity that drops tokens and one that drops none,
and ``GPTConfig.nano(moe_experts=4)`` end to end, aux loss included. JAX
initializes the weights and ``params_from_numpy`` carries them across.

Tolerances are tests/test_torch_gpt.py's: in f32, outputs, logits and loss
rtol 1e-5 (atol 1e-6 near 0), every gradient leaf atol 1e-5; in bf16 the loss
within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import moe as jmoe
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

E = 4
REMAT = [(True, "save_attn"), (True, "dots"), (False, None)]


def _configs(dtype="f32", **kw):
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jgpt.GPTConfig.nano(dtype=jd, moe_experts=E, **kw),
            tgpt.GPTConfig.nano(dtype=td, moe_experts=E, **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _configs()
    return jax.tree.map(np.asarray, jgpt.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 256, (2, 33)).astype(np.int32)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _layer_inputs(seed=0, B=2, S=16, D=32, F=64):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)  # noqa: E731
    return [f(B, S, D), f(D, E, s=0.5), f(E, D, F, s=0.1), f(E, F, s=0.1), f(E, F, D, s=0.1),
            f(E, D, s=0.1)]


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
def test_moe_layer_matches_jax(capacity_factor):
    arrays = _layer_inputs()
    ours = [torch.tensor(a, requires_grad=True) for a in arrays]
    out, aux = tmoe.moe_mlp(*ours, capacity_factor=capacity_factor)

    def ref_fn(*xs):
        return jmoe.moe_mlp(*xs, capacity_factor=capacity_factor)

    ref_out, ref_aux = ref_fn(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(ref_aux), rtol=1e-5)
    # Gradients of a scalar that reads both outputs.
    probe = np.random.default_rng(1).standard_normal(arrays[0].shape).astype(np.float32)
    grads = torch.autograd.grad((out * torch.as_tensor(probe)).sum() + aux, ours)
    ref_grads = jax.grad(lambda *xs: (ref_fn(*xs)[0] * probe).sum() + ref_fn(*xs)[1],
                         argnums=tuple(range(6)))(*map(jnp.asarray, arrays))
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, err_msg=f"arg {i}")


def test_capacity_drops_tokens_as_jax_does():
    x, router_w = (torch.as_tensor(a) for a in _layer_inputs()[:2])
    r = tmoe.route(x, router_w, 0.5)
    assert r.capacity == tmoe.moe_capacity(16, E, 0.5) == 2
    # Each row keeps at most C tokens per expert, the first ones in order.
    for b in range(x.shape[0]):
        for e in range(E):
            mine = (r.expert_idx[b] == e).nonzero()[:, 0]
            assert r.keep[b, mine].tolist() == [i < r.capacity for i in range(len(mine))]
            assert r.slot[b, mine[: r.capacity]].tolist() == list(range(min(len(mine), r.capacity)))
    assert 0 < (~r.keep).sum() < r.keep.numel()


def test_router_tie_takes_the_first_expert():
    x = torch.ones((1, 3, 4))
    router_w = torch.zeros((4, E))  # every expert ties
    assert tmoe.route(x, router_w, 1.0).expert_idx.tolist() == [[0, 0, 0]]
    assert np.asarray(jnp.argmax(jnp.zeros((1, 3, E)), axis=-1)).tolist() == [[0, 0, 0]]


@pytest.mark.parametrize("remat,remat_policy", REMAT)
def test_logits_aux_and_loss_match(weights, tokens, remat, remat_policy):
    jcfg, tcfg = _configs(remat=remat, remat_policy=remat_policy)
    params = params_from_numpy(weights, "cpu")
    logits, aux = tgpt.forward(params, torch.as_tensor(tokens[:, :-1]), tcfg, return_aux=True)
    ref, ref_aux = jgpt.forward(weights, jnp.asarray(tokens[:, :-1]), jcfg, return_aux=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(ref_aux), rtol=1e-5)
    assert aux.item() > 0

    loss = tgpt.loss_fn(params, {"tokens": torch.as_tensor(tokens)}, tcfg)
    ref_loss = jgpt.loss_fn(weights, {"tokens": jnp.asarray(tokens)}, jcfg)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)


@pytest.mark.parametrize("remat,remat_policy", REMAT)
def test_gradients_match(weights, tokens, remat, remat_policy):
    jcfg, tcfg = _configs(remat=remat, remat_policy=remat_policy)
    params = params_from_numpy(weights, "cpu", requires_grad=True)
    flat = _flatten(params)
    loss = tgpt.loss_fn(params, {"tokens": torch.as_tensor(tokens)}, tcfg)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    ref = _flatten(jax.grad(jgpt.loss_fn)(weights, {"tokens": jnp.asarray(tokens)}, jcfg))
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[name]), atol=1e-5, err_msg=name)


def test_bf16_loss_close(weights, tokens):
    jcfg, tcfg = _configs("bf16")
    loss = tgpt.loss_fn(params_from_numpy(weights, "cpu"), {"tokens": torch.as_tensor(tokens)}, tcfg)
    ref = jgpt.loss_fn(weights, {"tokens": jnp.asarray(tokens)}, jcfg)
    assert abs(loss.item() - float(ref)) < 2e-2


def test_init_params_layout_matches(weights):
    _, tcfg = _configs()
    ours, ref = _flatten(params_to_numpy(tgpt.init_params(tcfg, 0, device="cpu"))), _flatten(weights)
    assert ours.keys() == ref.keys()
    for name in ref:
        assert ours[name].shape == ref[name].shape and ours[name].dtype == ref[name].dtype, name
    for name in ("blocks.moe.router_w", "blocks.moe.fc_w", "blocks.moe.proj_w"):
        np.testing.assert_allclose(ours[name].std(), ref[name].std(), rtol=0.1, err_msg=name)


@pytest.mark.parametrize("preset,experts", [("nano", 4), ("gpt2_small", 8), ("gpt2_medium", 16)])
def test_param_and_flop_counts_match(preset, experts):
    jcfg = getattr(jgpt.GPTConfig, preset)(moe_experts=experts)
    tcfg = getattr(tgpt.GPTConfig, preset)(moe_experts=experts)
    assert tgpt.num_params(tcfg) == jgpt.num_params(jcfg)
    assert tgpt.train_flops_per_token(tcfg, 1024) == jgpt.train_flops_per_token(jcfg, 1024)
