"""The port's Llama (ray_tpu_torch.models.llama) against the JAX package's on
the CPU, at nano size, with grouped-query attention (4 query heads over 2 kv
heads) and without (4 over 4): JAX initializes the weights,
``params_from_numpy`` carries them across, and both sides run the same batch
(numpy, fixed seed). JAX's "auto" attention is XLA off the TPU; the port's is
the kernels' plain versions on the CPU.

Also here, because the JAX policy is defined beside Llama's forward: the
``dots`` remat policy, whose gradients must equal no remat's and whose saved
bytes must lie strictly between full remat's and no remat's.

Tolerances are tests/test_torch_gpt.py's: in f32, logits and loss rtol 1e-5
(atol 1e-6 for logits near 0), every gradient leaf atol 1e-5; in bf16 the loss
within 2e-2; the train step's params atol 1e-5 and Adam moments rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu.models import create_train_state as j_create
from ray_tpu.models import default_optimizer as j_optimizer
from ray_tpu.models import llama as jllama
from ray_tpu.models import make_train_step as j_step
from ray_tpu_torch.models import TrainState, default_optimizer, gpt as tgpt, llama as tllama
from ray_tpu_torch.models import make_train_step
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

REMAT = [(True, "save_attn"), (True, "dots"), (True, None), (False, None)]
HEADS = {"gqa": {}, "mha": {"n_kv_head": 4}}
PRESETS = ["nano", "llama2_7b", "llama2_13b", "llama3_8b"]


def _configs(heads="gqa", dtype="f32", **kw):
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    # Both nano presets fix their head counts, so the MHA variant is built
    # from the dataclass.
    jcfg = dataclasses.replace(jllama.LlamaConfig.nano(dtype=jd, **kw), **HEADS[heads])
    return jcfg, dataclasses.replace(tllama.LlamaConfig.nano(dtype=td, **kw), **HEADS[heads])


@pytest.fixture(scope="module")
def weights():
    return {h: jax.tree.map(np.asarray, jllama.init_params(_configs(h)[0], jax.random.PRNGKey(0)))
            for h in HEADS}


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


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("remat,remat_policy", REMAT)
def test_logits_and_loss_match(weights, tokens, heads, remat, remat_policy):
    jcfg, tcfg = _configs(heads, remat=remat, remat_policy=remat_policy)
    w = weights[heads]
    params = params_from_numpy(w, "cpu")
    logits = tllama.forward(params, torch.as_tensor(tokens[:, :-1]), tcfg)
    ref = jllama.forward(w, jnp.asarray(tokens[:, :-1]), jcfg)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)

    loss = tllama.loss_fn(params, {"tokens": torch.as_tensor(tokens)}, tcfg)
    ref_loss = jllama.loss_fn(w, {"tokens": jnp.asarray(tokens)}, jcfg)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("remat,remat_policy", REMAT)
def test_gradients_match(weights, tokens, heads, remat, remat_policy):
    jcfg, tcfg = _configs(heads, remat=remat, remat_policy=remat_policy)
    w = weights[heads]
    params = params_from_numpy(w, "cpu", requires_grad=True)
    flat = _flatten(params)
    loss = tllama.loss_fn(params, {"tokens": torch.as_tensor(tokens)}, tcfg)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    ref = _flatten(jax.grad(jllama.loss_fn)(w, {"tokens": jnp.asarray(tokens)}, jcfg))
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[name]), atol=1e-5, err_msg=name)


def test_bf16_loss_close(weights, tokens):
    jcfg, tcfg = _configs("gqa", "bf16")
    w = weights["gqa"]
    loss = tllama.loss_fn(params_from_numpy(w, "cpu"), {"tokens": torch.as_tensor(tokens)}, tcfg)
    ref = jllama.loss_fn(w, {"tokens": jnp.asarray(tokens)}, jcfg)
    assert abs(loss.item() - float(ref)) < 2e-2


def test_rope_tables_match_at_llama3_length():
    # Llama 3 8B's tables: S 8192, head_dim 128, theta 500000.
    cos, sin = tllama.rope_tables(8192, 128, 500000.0)
    jcos, jsin = jllama.rope_tables(8192, 128, 500000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5)


def test_init_params_layout_matches(weights):
    _, tcfg = _configs("gqa")
    ours = _flatten(params_to_numpy(tllama.init_params(tcfg, 0, device="cpu")))
    ref = _flatten(weights["gqa"])
    assert ours.keys() == ref.keys()
    for name in ref:
        assert ours[name].shape == ref[name].shape and ours[name].dtype == ref[name].dtype, name
    for name in ("embed", "blocks.wq", "blocks.wo", "blocks.w_down", "lm_head"):
        np.testing.assert_allclose(ours[name].std(), ref[name].std(), rtol=0.1, err_msg=name)


@pytest.mark.parametrize("preset", PRESETS)
def test_param_and_flop_counts_match(preset):
    jcfg, tcfg = getattr(jllama.LlamaConfig, preset)(), getattr(tllama.LlamaConfig, preset)()
    for field in dataclasses.fields(tcfg):
        if field.name not in ("dtype", "param_dtype"):
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    assert tllama.num_params(tcfg) == jllama.num_params(jcfg)
    for seq in (1024, 8192):
        assert tllama.train_flops_per_token(tcfg, seq) == jllama.train_flops_per_token(jcfg, seq)


def test_llama3_8b_depth_cut():
    cfg = dataclasses.replace(tllama.LlamaConfig.llama3_8b(), n_layer=4)
    assert (cfg.n_layer, cfg.d_model, cfg.n_head, cfg.n_kv_head, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.rope_theta) == (4, 4096, 32, 8, 128, 14336, 128256, 500000.0)
    assert tllama.num_params(cfg) == 1_923_125_248  # 2 * V * d + 4 * 218_112_000 + d


def test_train_step_matches_jax():
    jcfg, cfg = _configs("gqa")
    jopt, opt = j_optimizer(learning_rate=1e-3), default_optimizer(learning_rate=1e-3)
    jstate = j_create(jcfg, jax.random.PRNGKey(0), jopt)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu", requires_grad=True)
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 33)).astype(np.int32)
    jstate, jm = j_step(jcfg, jopt, donate=False)(jstate, {"tokens": jnp.asarray(tokens)})
    state, m = make_train_step(cfg, opt)(state, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    adam = jstate.opt_state[1][0]
    for ours, ref, tol in ((state.params, jstate.params, dict(atol=1e-5)),
                           (state.opt_state["mu"], adam.mu, dict(atol=1e-8, rtol=1e-4)),
                           (state.opt_state["nu"], adam.nu, dict(atol=1e-12, rtol=1e-4))):
        ours, ref = _flatten(ours), _flatten(ref)
        assert ours.keys() == ref.keys()
        for name in ref:
            np.testing.assert_allclose(ours[name].detach().numpy(), np.asarray(ref[name]),
                                       err_msg=name, **tol)


# --------------------------------------------------------------------------- dots remat
MODELS = {
    "gpt": (tgpt, lambda **kw: tgpt.GPTConfig.nano(dtype=torch.float32, **kw)),
    "llama": (tllama, lambda **kw: tllama.LlamaConfig.nano(dtype=torch.float32, **kw)),
}


def _saved_bytes_and_grads(model, cfg, params, batch):
    """Bytes the forward leaves allocated for the backward (allocations less
    frees while the loss is taken, the graph kept), and the gradients."""
    leaves = list(_flatten(params).values())
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        loss = model.loss_fn(params, batch, cfg)
    held = sum(e.self_cpu_memory_usage for e in prof.key_averages())
    return held, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_dots_remat_saves_between_full_and_none(name, tokens):
    model, make = MODELS[name]
    params = model.init_params(make(), 0, device="cpu")
    for leaf in _flatten(params).values():
        leaf.requires_grad_(True)
    batch = {"tokens": torch.as_tensor(tokens)}
    held = {}
    for label, kw in (("none", dict(remat=False)), ("full", dict(remat=True, remat_policy=None)),
                      ("dots", dict(remat=True, remat_policy="dots"))):
        held[label], grads = _saved_bytes_and_grads(model, make(**kw), params, batch)
        if label == "none":
            ref = grads
        for a, b in zip(grads, ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=label)
    assert held["full"] < held["dots"] < held["none"], held


@pytest.mark.parametrize("call", ["positional", "keyword"])
def test_reference_signature(weights, tokens, call):
    # The JAX package's forward/loss_fn signature, shared by every model
    # family: (..., attention_fn, dropout, mesh, num_microbatches, return_aux).
    jcfg, tcfg = _configs()
    w = weights["gqa"]
    params = params_from_numpy(w, "cpu")
    x, jx = torch.as_tensor(tokens[:, :-1]), jnp.asarray(tokens[:, :-1])
    if call == "positional":
        logits, aux = tllama.forward(params, x, tcfg, None, None, None, 1, True)
        ref, ref_aux = jllama.forward(w, jx, jcfg, None, None, None, 1, True)
        loss = tllama.loss_fn(params, {"tokens": torch.as_tensor(tokens)}, tcfg, None, None, None, 1)
        ref_loss = jllama.loss_fn(w, {"tokens": jnp.asarray(tokens)}, jcfg, None, None, None, 1)
    else:
        kw = dict(attention_fn=None, mesh=None, num_microbatches=1)
        logits, aux = tllama.forward(params, x, tcfg, return_aux=True, dropout_seed=None, **kw)
        ref, ref_aux = jllama.forward(w, jx, jcfg, return_aux=True, dropout_rng=None, **kw)
        loss = tllama.loss_fn(params, {"tokens": torch.as_tensor(tokens)}, tcfg, **kw)
        ref_loss = jllama.loss_fn(w, {"tokens": jnp.asarray(tokens)}, jcfg, **kw)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert aux.shape == np.shape(ref_aux) == () and aux.dtype == torch.float32
    np.testing.assert_allclose(aux.item(), float(ref_aux), atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5)
