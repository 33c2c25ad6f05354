"""The port's ResNet (ray_tpu_torch.models.resnet) against the JAX package's
on the CPU: ``ResNetConfig.nano`` (basic blocks) on 32x32 and 33x33 images,
which exercises XLA's "SAME" padding on even sizes (asymmetric at stride 2)
and odd ones, and a two-stage bottleneck config. JAX initializes the weights
and ``params_from_numpy`` carries them across (``stage<i>`` is a list of block
dicts); images and labels come from a numpy seed.

Tolerances are tests/test_torch_gpt.py's: in f32, logits and loss rtol 1e-5
(atol 1e-6 near 0), every gradient leaf atol 1e-5; in bf16 the loss within
2e-2, and within 1e-4 at init (both keep each conv output in f32 up to the
GroupNorm; what is left is the two frameworks' summation orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import resnet as jresnet
from ray_tpu_torch.models import resnet as tresnet
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

KINDS = ["basic", "bottleneck"]
SIZES = [32, 33]


def _configs(kind, dtype="f32"):
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg, tcfg = jresnet.ResNetConfig.nano(dtype=jd), tresnet.ResNetConfig.nano(dtype=td)
    if kind == "bottleneck":
        jcfg = dataclasses.replace(jcfg, bottleneck=True)
        tcfg = dataclasses.replace(tcfg, bottleneck=True)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    out = {}
    for kind in KINDS:
        p = jresnet.init_params(_configs(kind)[0], jax.random.PRNGKey(0))
        # Random norm scales and biases in place of the init's ones and zeros
        # (the last norm of each block starts at zero), so every leaf's
        # gradient is exercised.
        leaves, tree = jax.tree.flatten(p)
        rng = np.random.default_rng(1)
        leaves = [np.asarray(x) if x.ndim > 1 else
                  (1 + 0.3 * rng.standard_normal(x.shape)).astype(np.float32) for x in leaves]
        out[kind] = jax.tree.unflatten(tree, leaves)
    return out


def _batch(size, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((2, size, size, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, (2,)).astype(np.int32)}


def _flatten(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES)
def test_logits_and_loss_match(weights, kind, size):
    jcfg, tcfg = _configs(kind)
    batch = _batch(size)
    params = params_from_numpy(weights[kind], "cpu")
    logits = tresnet.forward(params, torch.as_tensor(batch["images"]), tcfg)
    ref = jresnet.forward(weights[kind], jnp.asarray(batch["images"]), jcfg)
    assert logits.dtype == torch.float32 and logits.shape == (2, 10)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    loss = tresnet.loss_fn(params, {k: torch.as_tensor(v) for k, v in batch.items()}, tcfg)
    ref_loss = jresnet.loss_fn(weights[kind], jax.tree.map(jnp.asarray, batch), jcfg)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES)
def test_gradients_match(weights, kind, size):
    jcfg, tcfg = _configs(kind)
    batch = _batch(size)
    params = params_from_numpy(weights[kind], "cpu", requires_grad=True)
    flat = _flatten(params)
    loss = tresnet.loss_fn(params, {k: torch.as_tensor(v) for k, v in batch.items()}, tcfg)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    ref = _flatten(jax.grad(jresnet.loss_fn)(weights[kind], jax.tree.map(jnp.asarray, batch), jcfg))
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[name]), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_loss_close(weights, kind):
    jcfg, tcfg = _configs(kind, "bf16")
    batch = _batch(32)
    loss = tresnet.loss_fn(params_from_numpy(weights[kind], "cpu"),
                           {k: torch.as_tensor(v) for k, v in batch.items()}, tcfg)
    ref = jresnet.loss_fn(weights[kind], jax.tree.map(jnp.asarray, batch), jcfg)
    assert abs(loss.item() - float(ref)) < 2e-2


@pytest.mark.parametrize("size,k,stride,pads", [
    (224, 7, 2, (2, 3)),  # the stem on ImageNet
    (112, 3, 2, (0, 1)),  # the stem's max-pool
    (56, 3, 1, (1, 1)),
    (33, 7, 2, (3, 3)),
    (56, 1, 2, (0, 0)),
])
def test_same_padding_is_xlas(size, k, stride, pads):
    assert tresnet._same_pads(size, k, stride) == pads
    x = jnp.zeros((1, size, size, 1))
    w = jnp.zeros((k, k, 1, 1))
    out = jax.lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert out.shape[1] == (size + sum(pads) - k) // stride + 1


def test_group_norm_falls_back_to_a_divisor():
    x = np.random.default_rng(0).standard_normal((2, 3, 3, 12)).astype(np.float32)
    scale, bias = np.full(12, 1.5, np.float32), np.full(12, 0.25, np.float32)
    ours = tresnet._group_norm(*map(torch.as_tensor, (x, scale, bias)), 5)  # 5 -> 4 groups
    ref = jresnet._group_norm(*map(jnp.asarray, (x, scale, bias)), 5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_init_params_layout_matches(weights):
    for kind in KINDS:
        _, tcfg = _configs(kind)
        ours = _flatten(params_to_numpy(tresnet.init_params(tcfg, 0, device="cpu")))
        ref = _flatten(jax.tree.map(np.asarray, jresnet.init_params(_configs(kind)[0],
                                                                    jax.random.PRNGKey(0))))
        assert ours.keys() == ref.keys()
        for name in ref:
            assert ours[name].shape == ref[name].shape and ours[name].dtype == ref[name].dtype
            if name.endswith(("_scale", "_bias", ".b")):
                np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)


@pytest.mark.parametrize("preset", ["nano", "resnet18", "resnet34", "resnet50", "resnet101"])
def test_param_counts_match(preset):
    jcfg, tcfg = getattr(jresnet.ResNetConfig, preset)(), getattr(tresnet.ResNetConfig, preset)()
    assert tresnet.num_params(tcfg) == jresnet.num_params(jcfg)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_conv_output_rounding_gap(kind):
    # At init weights: both keep each conv output in f32 up to the GroupNorm
    # (preferred_element_type=f32 in JAX), so in bf16 the gap is only the two
    # frameworks' summation orders and the activations they round alike.
    # Printed with -s.
    losses = {}
    for dtype in ("f32", "bf16"):
        jcfg, tcfg = _configs(kind, dtype)
        w = jax.tree.map(np.asarray, jresnet.init_params(jcfg, jax.random.PRNGKey(0)))
        batch = _batch(32)
        losses[f"jax_{dtype}"] = float(jresnet.loss_fn(w, jax.tree.map(jnp.asarray, batch), jcfg))
        losses[f"port_{dtype}"] = tresnet.loss_fn(
            params_from_numpy(w, "cpu"), {k: torch.as_tensor(v) for k, v in batch.items()},
            tcfg).item()
    gap = losses["port_bf16"] - losses["jax_bf16"]
    print(f"resnet nano {kind} bf16 loss gap port - jax: {gap:.3e} {losses}")
    np.testing.assert_allclose(losses["port_f32"], losses["jax_f32"], rtol=1e-5)
    assert abs(gap) < 1e-4


@pytest.mark.parametrize("call", ["positional", "keyword"])
def test_reference_signature(weights, call):
    # The JAX package's forward/loss_fn signature, which ResNet shares with
    # the LM families: num_microbatches is ignored, return_aux gives a zero.
    jcfg, tcfg = _configs("basic")
    batch = _batch(32)
    params = params_from_numpy(weights["basic"], "cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if call == "positional":
        logits, aux = tresnet.forward(params, tb["images"], tcfg, None, None, None, 2, True)
        ref, ref_aux = jresnet.forward(weights["basic"], jb["images"], jcfg, None, None, None, 2, True)
        loss = tresnet.loss_fn(params, tb, tcfg, None, None, None, 2)
        ref_loss = jresnet.loss_fn(weights["basic"], jb, jcfg, None, None, None, 2)
    else:
        kw = dict(attention_fn=None, mesh=None, num_microbatches=2)
        logits, aux = tresnet.forward(params, tb["images"], tcfg, return_aux=True, **kw)
        ref, ref_aux = jresnet.forward(weights["basic"], jb["images"], jcfg, return_aux=True, **kw)
        loss = tresnet.loss_fn(params, tb, tcfg, **kw)
        ref_loss = jresnet.loss_fn(weights["basic"], jb, jcfg, **kw)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert aux.shape == np.shape(ref_aux) == () and aux.item() == float(ref_aux) == 0.0
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5)


def test_init_shapes_match(weights):
    shapes = tresnet.init_shapes(_configs("basic")[1])
    flat, ref = _flatten(shapes), _flatten(jresnet.init_shapes(_configs("basic")[0]))
    assert sorted(flat) == sorted(ref)
    for name, leaf in flat.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(ref[name].shape) and leaf.dtype == torch.float32
