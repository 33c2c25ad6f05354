"""The port's GPT-2 (ray_tpu_torch.models.gpt) against the JAX package's on the
CPU: JAX initializes the weights, ``params_from_numpy`` carries them across,
and both sides run the same batch (numpy, fixed seed).

Tolerances: in f32, logits and loss rtol 1e-5 (atol 1e-6 for logits near 0),
every gradient leaf atol 1e-5; in bf16, where the two frameworks round at
different places, the loss within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

REMAT = [(True, "save_attn"), (True, None), (False, None)]


def _configs(dtype="f32", **kw):
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jgpt.GPTConfig.nano(dtype=jd, **kw), tgpt.GPTConfig.nano(dtype=td, **kw)


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


@pytest.mark.parametrize("remat,remat_policy", REMAT)
def test_logits_and_loss_match(weights, tokens, remat, remat_policy):
    jcfg, tcfg = _configs(remat=remat, remat_policy=remat_policy)
    params = params_from_numpy(weights, "cpu")
    logits = tgpt.forward(params, torch.as_tensor(tokens[:, :-1]), tcfg)
    ref = jgpt.forward(weights, jnp.asarray(tokens[:, :-1]), jcfg)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)

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
    params = params_to_numpy(tgpt.init_params(tcfg, 0, device="cpu"))
    ours, ref = _flatten(params), _flatten(weights)
    assert ours.keys() == ref.keys()
    for name in ref:
        assert ours[name].shape == ref[name].shape and ours[name].dtype == ref[name].dtype, name
    # Same init scales: N(0, 0.02) embeddings, 1/sqrt(2L)-scaled projections.
    for name in ("wte", "blocks.qkv_w", "blocks.out_w", "blocks.proj_w"):
        np.testing.assert_allclose(ours[name].std(), ref[name].std(), rtol=0.1, err_msg=name)


@pytest.mark.parametrize("preset", ["nano", "gpt2_small", "gpt2_medium"])
def test_param_and_flop_counts_match(preset):
    jcfg, tcfg = getattr(jgpt.GPTConfig, preset)(), getattr(tgpt.GPTConfig, preset)()
    assert tgpt.num_params(tcfg) == jgpt.num_params(jcfg)
    assert tgpt.train_flops_per_token(tcfg, 1024) == jgpt.train_flops_per_token(jcfg, 1024)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_matches_jax_in_distribution(rate):
    # The two sides draw their masks from different generators, so they are
    # compared in distribution on one large input: the kept fraction lies
    # within 5 binomial standard deviations of 1 - rate on each side, the
    # two fractions differ by no more than that, and every kept value is
    # exactly x / (1 - rate).
    x = np.ones((256, 1024), np.float32)
    bound = 5 * np.sqrt(rate * (1 - rate) / x.size)
    ours = tgpt._dropout(torch.as_tensor(x), rate, 0).numpy()
    ref = np.asarray(jgpt._dropout(jnp.asarray(x), rate, jax.random.PRNGKey(0)))
    fractions = []
    for out in (ours, ref):
        kept = out != 0
        fractions.append(kept.mean())
        assert abs(fractions[-1] - (1 - rate)) <= bound
        np.testing.assert_array_equal(out[kept], np.float32(1) / np.float32(1 - rate))
    assert abs(fractions[0] - fractions[1]) <= bound


def test_dropout_is_seeded_and_survives_recompute(weights, tokens):
    # Masks come from torch generators, not jax.random, so only their effect
    # is checked (as tests/test_ops.py::test_dropout_applied_and_deterministic_eval
    # checks the JAX side): eval is deterministic, a seed fixes the mask, and a
    # checkpointed block redraws the same mask when the backward recomputes it.
    inp = torch.as_tensor(tokens[:, :-1])
    grads = []
    for remat, policy in REMAT:
        _, tcfg = _configs(dropout=0.5, remat=remat, remat_policy=policy)
        params = params_from_numpy(weights, "cpu", requires_grad=True)
        flat = list(_flatten(params).values())
        eval1, eval2 = (tgpt.forward(params, inp, tcfg) for _ in range(2))
        torch.testing.assert_close(eval1, eval2, rtol=0, atol=0)
        tr1, tr1_again, tr2 = (tgpt.forward(params, inp, tcfg, dropout_seed=s) for s in (1, 1, 2))
        torch.testing.assert_close(tr1, tr1_again, rtol=0, atol=0)
        assert (tr1 - tr2).abs().max() > 1e-6 and (tr1 - eval1).abs().max() > 1e-6
        grads.append(torch.autograd.grad(tr1.square().mean(), flat))
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("call", ["positional", "keyword"])
def test_reference_signature(weights, tokens, call):
    # The JAX package's forward/loss_fn signature, shared by every model
    # family: (..., attention_fn, dropout, mesh, num_microbatches, return_aux).
    jcfg, tcfg = _configs()
    params = params_from_numpy(weights, "cpu")
    x, jx = torch.as_tensor(tokens[:, :-1]), jnp.asarray(tokens[:, :-1])
    if call == "positional":
        logits, aux = tgpt.forward(params, x, tcfg, None, None, None, 1, True)
        ref, ref_aux = jgpt.forward(weights, jx, jcfg, None, None, None, 1, True)
        loss = tgpt.loss_fn(params, {"tokens": torch.as_tensor(tokens)}, tcfg, None, None, None, 1)
        ref_loss = jgpt.loss_fn(weights, {"tokens": jnp.asarray(tokens)}, jcfg, None, None, None, 1)
        # num_microbatches binds before return_aux: (2, False) gives logits alone.
        alone = tgpt.forward(params, x, tcfg, None, None, None, 2, False)
        assert isinstance(alone, torch.Tensor)
        np.testing.assert_allclose(alone.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    else:
        kw = dict(attention_fn=None, mesh=None, num_microbatches=1)
        logits, aux = tgpt.forward(params, x, tcfg, return_aux=True, dropout_seed=None, **kw)
        ref, ref_aux = jgpt.forward(weights, jx, jcfg, return_aux=True, dropout_rng=None, **kw)
        loss = tgpt.loss_fn(params, {"tokens": torch.as_tensor(tokens)}, tcfg, **kw)
        ref_loss = jgpt.loss_fn(weights, {"tokens": jnp.asarray(tokens)}, jcfg, **kw)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert aux.shape == np.shape(ref_aux) == () and aux.dtype == torch.float32
    np.testing.assert_allclose(aux.item(), float(ref_aux), atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5)
