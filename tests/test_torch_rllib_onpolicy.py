"""The port's on-policy RLlib algorithms (A2C, PG, IMPALA, APPO) against the
JAX package's, on the CPU, in f32, with inputs from a numpy seed.

- Each loss: one JAX module's weights carried across, one numpy batch; the
  loss, every aux value and every gradient within 1e-5 (absolute plus
  relative, ``torch_rllib_parity.ATOL``/``RTOL``).
- V-trace: with behavior == target policy and no dones it reduces to the
  n-step return (the case of tests/test_rllib.py:392).
- One ``training_step`` of each against the JAX package's, through the same
  stub runners (``torch_rllib_parity``): weights, APPO's target network and
  KL coefficient within 1e-5 after the step.
- Through the port's runtime (learner on the CPU, ``num_gpus_per_learner=0``):
  A2C learns CartPole by the JAX test's bar (tests/test_rllib.py:610-632);
  PG, IMPALA and APPO run one iteration each.
"""

import numpy as np
import pytest

from ray_tpu.rllib.algorithms import a2c as ja2c
from ray_tpu.rllib.algorithms import appo as jappo
from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu.rllib.algorithms import pg as jpg
from ray_tpu.rllib.core import rl_module as jrl
from ray_tpu_torch.rllib.algorithms import a2c as ta2c
from ray_tpu_torch.rllib.algorithms import appo as tappo
from ray_tpu_torch.rllib.algorithms import impala as timpala
from ray_tpu_torch.rllib.algorithms import pg as tpg
from ray_tpu_torch.rllib.core import rl_module as trl
from torch_rllib_parity import (  # noqa: F401 (one_thread is an autouse fixture)
    assert_loss_matches,
    assert_trees_close,
    build_both,
    jax_numpy,
    one_thread,
)

OBS, ACT, HID = 4, 2, (8, 8)
T, N = 16, 4


def _modules(seed=0):
    import jax

    jm, tm = jrl.MLPModule(OBS, ACT, HID), trl.MLPModule(OBS, ACT, HID)
    return jm, tm, jax_numpy(jm.init(jax.random.PRNGKey(seed)))


def _flat_batch(seed, rows=64):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((rows, OBS)).astype(np.float32),
            "actions": rng.integers(0, ACT, rows),
            "advantages": rng.standard_normal(rows).astype(np.float32),
            "value_targets": rng.standard_normal(rows).astype(np.float32),
            "returns": rng.standard_normal(rows).astype(np.float32)}


def _env_major_batch(seed, n=N, t=T):
    """An (N, T) batch as IMPALA's and APPO's losses take it: episode ends,
    truncations with their final observations, and behavior log-probs."""
    rng = np.random.default_rng(seed)
    dones = (rng.random((n, t)) < 0.15).astype(np.float32)
    terms = (dones * (rng.random((n, t)) < 0.6)).astype(np.float32)
    truncs = dones - terms
    return {"obs": rng.standard_normal((n, t, OBS)).astype(np.float32),
            "actions": rng.integers(0, ACT, (n, t)),
            "logp": np.log(rng.uniform(0.2, 0.8, (n, t))).astype(np.float32),
            "rewards": rng.standard_normal((n, t)).astype(np.float32),
            "dones": dones, "terminateds": terms, "truncateds": truncs,
            "final_obs": (rng.standard_normal((n, t, OBS)) * truncs[..., None]).astype(np.float32),
            "last_obs": rng.standard_normal((n, OBS)).astype(np.float32),
            "kl_coeff": np.full(n, 0.7, np.float32)}


LOSSES = ["a2c", "pg", "impala", "impala-clipped", "appo", "appo-kl"]


@pytest.mark.parametrize("case", LOSSES)
def test_loss_matches_jax(case):
    jm, tm, w = _modules()
    extra = None
    if case == "a2c":
        cfgs = [m.A2CConfig().training(entropy_coeff=0.05) for m in (ja2c, ta2c)]
        losses = [m.make_a2c_loss(c) for m, c in zip((ja2c, ta2c), cfgs)]
        batch = _flat_batch(1)
    elif case == "pg":
        cfgs = [m.PGConfig().training(entropy_coeff=0.05) for m in (jpg, tpg)]
        losses = [m.make_pg_loss(c) for m, c in zip((jpg, tpg), cfgs)]
        batch = _flat_batch(2)
    elif case.startswith("impala"):
        # "clipped": thresholds below 1, so the rho and c clips bind.
        kw = dict(vtrace_clip_rho_threshold=0.8, vtrace_clip_c_threshold=0.9,
                  vtrace_clip_pg_rho_threshold=0.7) if case.endswith("clipped") else {}
        cfgs = [m.ImpalaConfig().training(gamma=0.9, **kw) for m in (jimpala, timpala)]
        losses = [m.make_impala_loss(c) for m, c in zip((jimpala, timpala), cfgs)]
        batch = _env_major_batch(3)
    else:
        cfgs = [m.APPOConfig().training(use_kl_loss=case.endswith("kl"), clip_param=0.2)
                for m in (jappo, tappo)]
        losses = [m.make_appo_loss(c) for m, c in zip((jappo, tappo), cfgs)]
        batch = _env_major_batch(4)
        import jax

        extra = jax_numpy(jm.init(jax.random.PRNGKey(1)))  # a target apart from the params
    loss = assert_loss_matches(*losses, jm, tm, w, batch, extra)
    assert np.isfinite(loss)


class _ValueIsFirstObs:
    """V(s) = s[..., 0]; uniform logits, so target logp == behavior logp."""

    def forward(self, params, obs):
        import torch

        return torch.zeros(obs.shape[:-1] + (2,)), obs[..., 0]


def test_vtrace_on_policy_reduces_to_n_step_return():
    # tests/test_rllib.py:392 on the port: with rho = c = 1 and no dones, vs_t
    # is the n-step TD(lambda=1) return sum gamma^k r + gamma^n V(last).
    import torch

    cfg = timpala.ImpalaConfig()
    cfg.gamma, cfg.entropy_coeff, cfg.vf_loss_coeff = 0.9, 0.0, 1.0
    loss_fn = timpala.make_impala_loss(cfg)
    n, t = 2, 4
    rng = np.random.default_rng(0)
    values = rng.standard_normal((n, t)).astype(np.float32)
    last_v = rng.standard_normal((n,)).astype(np.float32)
    rewards = rng.standard_normal((n, t)).astype(np.float32)
    zeros = np.zeros((n, t), np.float32)
    batch = {"obs": values[..., None], "actions": np.zeros((n, t), np.int64),
             "logp": np.full((n, t), np.log(0.5), np.float32), "rewards": rewards,
             "terminateds": zeros, "dones": zeros, "truncateds": zeros,
             "final_obs": np.zeros((n, t, 1), np.float32), "last_obs": last_v[..., None]}
    _, aux = loss_fn(_ValueIsFirstObs(), {}, {k: torch.tensor(v) for k, v in batch.items()})
    g = cfg.gamma
    vs_manual = np.zeros((n, t), np.float32)
    for i in range(t):
        acc = np.zeros(n, np.float32)
        for k in range(i, t):
            acc += g ** (k - i) * rewards[:, k]
        vs_manual[:, i] = acc + g ** (t - i) * last_v
    expected_vf = 0.5 * np.mean((vs_manual - values) ** 2)
    np.testing.assert_allclose(float(aux["vf_loss"]), expected_vf, rtol=1e-5)
    assert float(aux["mean_rho"]) == pytest.approx(1.0)


# ------------------------------------------------------------------ training_step
def _rollout(seed, value_extras):
    """One runner's (T, N) fragment on CartPole's shapes."""
    rng = np.random.default_rng(seed)
    dones = (rng.random((T, N)) < 0.1).astype(np.float32)
    terms = (dones * (rng.random((T, N)) < 0.7)).astype(np.float32)
    truncs = dones - terms
    ro = {"obs": rng.standard_normal((T, N, OBS)).astype(np.float32),
          "actions": rng.integers(0, ACT, (T, N)),
          "rewards": np.ones((T, N), np.float32), "dones": dones, "terminateds": terms,
          "truncateds": truncs, "logp": np.log(rng.uniform(0.3, 0.7, (T, N))).astype(np.float32),
          "final_obs": (rng.standard_normal((T, N, OBS)) * truncs[..., None]).astype(np.float32),
          "last_obs": rng.standard_normal((N, OBS)).astype(np.float32)}
    if value_extras:
        ro.update(values=rng.standard_normal((T, N)).astype(np.float32),
                  bootstrap_values=rng.standard_normal((T, N)).astype(np.float32),
                  last_values=rng.standard_normal(N).astype(np.float32))
    return ro


STEPS = {
    "a2c": (ja2c.A2CConfig, ta2c.A2CConfig, dict(lr=1e-3, lambda_=0.95)),
    "pg": (jpg.PGConfig, tpg.PGConfig, dict(lr=4e-3, entropy_coeff=0.01)),
    "impala": (jimpala.ImpalaConfig, timpala.ImpalaConfig, dict(lr=5e-4)),
    "appo": (jappo.APPOConfig, tappo.APPOConfig, dict(lr=5e-4, tau=0.5)),
    "appo-kl": (jappo.APPOConfig, tappo.APPOConfig, dict(lr=5e-4, use_kl_loss=True,
                                                        kl_target=1e-4)),
}


@pytest.mark.parametrize("algo", sorted(STEPS))
def test_training_step_matches_jax(monkeypatch, algo):
    jcfg, tcfg, opts = STEPS[algo]
    model = {"hiddens": HID}
    ja, ta = build_both(monkeypatch,
                        jcfg().environment("CartPole-v1").training(model=model, **opts),
                        tcfg().environment("CartPole-v1").training(model=model, **opts),
                        [_rollout(s, algo == "a2c") for s in (1, 2)])
    for _ in range(2):
        jm, tm = ja.training_step(), ta.training_step()
    assert_trees_close(ta.learner_group.get_weights(), ja.learner_group.get_weights())
    assert tm["num_env_steps_sampled"] == jm["num_env_steps_sampled"]
    for k in ("total_loss", "grad_norm", "policy_loss", "entropy", "vf_loss", "mean_rho",
              "mean_kl", "mean_is_ratio"):
        if k in jm:
            assert tm[k] == pytest.approx(jm[k], rel=1e-5, abs=1e-5), k
    assert tm["learn_time_s"] > 0 and tm["num_learner_updates"] == 1
    if algo.startswith("appo"):
        assert tm["num_target_updates"] == jm["num_target_updates"] == 1
        assert_trees_close(ta.learner_group.get_extra(), ja.learner_group.get_extra())
        assert ta.kl_coeff == ja.kl_coeff
        if algo == "appo-kl":  # the coefficient adapted
            assert tm["kl_coeff"] == jm["kl_coeff"] == ta.kl_coeff != 1.0


# ------------------------------------------------------------------ through the runtime
@pytest.fixture(scope="module")
def port():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_a2c_cartpole_improves(port):
    from ray_tpu_torch.rllib import A2CConfig

    algo = (A2CConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_runner=8, rollout_fragment_length=32)
            .training(lr=1e-3, entropy_coeff=0.01, lambda_=0.95)
            .learners(num_gpus_per_learner=0).build())
    try:
        best = 0.0
        for _ in range(40):
            m = algo.train()
            best = max(best, m.get("episode_return_mean", 0.0))
            if best >= 60.0:
                break
        assert best >= 60.0, f"best return {best}"
        assert np.isfinite(m["vf_loss"])
    finally:
        algo.stop()


@pytest.mark.parametrize("name", ["PG", "IMPALA", "APPO"])
def test_one_iteration_through_the_runtime(port, name):
    import ray_tpu_torch.rllib as rllib

    algo = (getattr(rllib, f"{name}Config")().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_runner=4, rollout_fragment_length=32)
            .learners(num_gpus_per_learner=0).build())
    try:
        m = algo.train()
        assert np.isfinite(m["total_loss"]) and m["sample_time_s"] > 0
        assert {"IMPALA": "mean_rho", "APPO": "mean_is_ratio"}.get(name, "entropy") in m
    finally:
        algo.stop()
