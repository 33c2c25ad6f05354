"""The port's train step (ray_tpu_torch.models.training) against the JAX
package's ``make_train_step`` on the CPU: nano GPT in f32, the same weights
(carried across from JAX) and batch, three steps, with the constant learning
rate and with warmup-cosine. Global-norm clipping is active: the nano model's
gradient norm is above 1 at these weights.

Tolerances: every leaf of params atol 1e-5; Adam mu and nu rtol 1e-4 (with
atol 1e-8 for mu and 1e-12 for nu, the square of a gradient, where a value is
near 0); loss and grad_norm rtol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import GPTConfig as JGPTConfig
from ray_tpu.models import create_train_state as j_create
from ray_tpu.models import default_optimizer as j_optimizer
from ray_tpu.models import make_train_step as j_step
from ray_tpu_torch.models import GPTConfig, TrainState, default_optimizer, make_train_step
from ray_tpu_torch.models.convert import params_from_numpy

STEPS = 3
LR = 1e-3
SCHEDULES = {
    "constant": dict(learning_rate=LR),
    "warmup_cosine": dict(learning_rate=LR, warmup_steps=2, total_steps=6),
}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _compare(ours, ref, what, **tol):
    ours, ref = _flatten(ours), _flatten(ref)
    assert ours.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(ours[name], ref[name], err_msg=f"{what} {name}", **tol)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_train_steps_match_jax(schedule):
    import jax.numpy as jnp

    jcfg = JGPTConfig.nano(dtype=jnp.float32)
    cfg = GPTConfig.nano(dtype=torch.float32)
    jopt = j_optimizer(**SCHEDULES[schedule])
    opt = default_optimizer(**SCHEDULES[schedule])

    jstate = j_create(jcfg, jax.random.PRNGKey(0), jopt)
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu", requires_grad=True)
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    jstep, step = j_step(jcfg, jopt, donate=False), make_train_step(cfg, opt)

    tokens = np.random.default_rng(0).integers(0, 256, (2, 33)).astype(np.int32)
    for i in range(STEPS):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": torch.as_tensor(tokens)})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        assert m["step"] == int(jm["step"]) == i + 1

    adam = jstate.opt_state[1][0]
    assert state.opt_state["count"] == int(adam.count) == STEPS
    _compare(state.params, jstate.params, "params", atol=1e-5)
    _compare(state.opt_state["mu"], adam.mu, "mu", atol=1e-8, rtol=1e-4)
    _compare(state.opt_state["nu"], adam.nu, "nu", atol=1e-12, rtol=1e-4)


def test_warmup_cosine_lr_matches_optax():
    import optax

    ref = optax.warmup_cosine_decay_schedule(0.0, LR, 2, 6)
    opt = default_optimizer(learning_rate=LR, warmup_steps=2, total_steps=6)
    for count in range(9):
        np.testing.assert_allclose(opt.lr(count), float(ref(count)), rtol=1e-6, atol=1e-12)
    assert opt.lr(0) == 0.0  # with warmup the first update moves nothing but decay
