"""The port's online off-policy RLlib algorithms (SAC, TD3/DDPG, Ape-X DQN)
against the JAX package's, on the CPU, in f32, with inputs from a numpy seed.

- Each loss: one JAX module's weights and targets carried across, one numpy
  batch with the noise the algorithm pre-draws on the host; the loss, every
  aux value and every gradient within 1e-5 (absolute plus relative).
- One ``training_step`` of each against the JAX package's through the same
  stub runners (and, for Ape-X, the same stub replay shards and a ``wait``
  that returns the first pending fragment): weights, target networks, the
  shards' priorities and the counters within 1e-5 after the step (SAC's
  policy tower 3e-5: see the test).
- ``chip_smoke.Pendulum`` against gymnasium's ``Pendulum-v1``: 200 steps of
  observations and rewards within 1e-6 from one seed.
- Through the port's runtime (learner on the CPU): one ``train()`` iteration
  each of SAC, TD3 and Ape-X DQN (they learn on the card, in chip_smoke.py).
"""

import os
import sys

import gymnasium as gym
import jax
import numpy as np
import pytest

from ray_tpu.rllib.algorithms import apex_dqn as japex
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.algorithms import td3 as jtd3
from ray_tpu.rllib.core import rl_module as jrl
from ray_tpu_torch.rllib.algorithms import apex_dqn as tapex
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.algorithms import td3 as ttd3
from ray_tpu_torch.rllib.core import rl_module as trl
from torch_rllib_parity import (  # noqa: F401 (one_thread is an autouse fixture)
    assert_loss_matches,
    assert_trees_close,
    build_both,
    jax_numpy,
    one_thread,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

OBS, HID, ROWS = 3, (8, 8), 32
LOW, HIGH = np.array([-2.0, -1.0], np.float32), np.array([2.0, 3.0], np.float32)


def _modules(kind):
    cls = "SquashedGaussianModule" if kind == "sac" else "DeterministicContinuousModule"
    jm, tm = (getattr(m, cls)(OBS, LOW, HIGH, HID) for m in (jrl, trl))
    w = jax_numpy(jm.init(jax.random.PRNGKey(0)))
    target = jax_numpy(jm.init(jax.random.PRNGKey(1)))
    return jm, tm, w, target


def _batch(seed, rows=ROWS):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((rows, OBS)).astype(np.float32),
            "actions": rng.uniform(LOW, HIGH, (rows, 2)).astype(np.float32),
            "rewards": rng.standard_normal(rows).astype(np.float32),
            "next_obs": rng.standard_normal((rows, OBS)).astype(np.float32),
            "terminateds": (rng.random(rows) < 0.2).astype(np.float32),
            "noise_next": rng.standard_normal((rows, 2)).astype(np.float32),
            "noise_pi": rng.standard_normal((rows, 2)).astype(np.float32),
            "target_noise": (0.2 * rng.standard_normal((rows, 2))).astype(np.float32)}


@pytest.mark.parametrize("case", ["sac", "sac-weighted", "td3-actor", "td3-critic", "ddpg"])
def test_loss_matches_jax(case):
    kind = case.split("-")[0]
    jm, tm, w, target = _modules("sac" if kind == "sac" else "td3")
    batch = _batch(1)
    if kind == "sac":
        if case.endswith("weighted"):  # rows whose TD target is invalid weigh 0
            batch["loss_weight"] = np.random.default_rng(2).uniform(0, 1, ROWS).astype(np.float32)
            batch["loss_weight"][::5] = 0.0
        cfgs = [m.SACConfig().training(gamma=0.95) for m in (jsac, tsac)]
        losses = [m.make_sac_loss(c, -2.0) for m, c in zip((jsac, tsac), cfgs)]
        w["log_alpha"] = np.float32(-0.3)
        extra = {"q1": target["q1"], "q2": target["q2"]}
    else:
        make = "DDPGConfig" if kind == "ddpg" else "TD3Config"
        cfgs = [getattr(m, make)() for m in (jtd3, ttd3)]
        losses = [m.make_td3_loss(c) for m, c in zip((jtd3, ttd3), cfgs)]
        batch["actor_weight"] = np.full(ROWS, 0.0 if case == "td3-critic" else 1.0, np.float32)
        extra = target
    assert np.isfinite(assert_loss_matches(*losses, jm, tm, w, batch, extra))


def test_box_module_makes_its_bounds_once_per_device_and_pickles_without_them():
    import pickle

    import torch

    _, tm, w, _ = _modules("td3")
    from ray_tpu_torch.models.convert import params_from_numpy

    params, obs = params_from_numpy(w, "cpu"), torch.zeros(2, OBS)
    tm.pi(params, obs)
    first = tm._t("scale", obs)
    assert tm._t("scale", obs) is first and set(tm._bounds_on) == {
        ("center", obs.device), ("scale", obs.device)}
    again = pickle.loads(pickle.dumps(tm))
    assert "_bounds_on" not in again.__dict__
    torch.testing.assert_close(again.pi(params, obs), tm.pi(params, obs))


# ------------------------------------------------------------------ training_step
T, N = 32, 4


def _rollout(seed, obs_dim, act_dim):
    """One runner's (T, N) fragment as a replay algorithm takes it: episode
    ends, truncations with their final observations."""
    rng = np.random.default_rng(seed)
    dones = (rng.random((T, N)) < 0.08).astype(np.float32)
    terms = (dones * (rng.random((T, N)) < 0.5)).astype(np.float32)
    truncs = dones - terms
    act = (rng.uniform(-2, 2, (T, N, act_dim)).astype(np.float32) if act_dim
           else rng.integers(0, 2, (T, N)))
    return {"obs": rng.standard_normal((T, N, obs_dim)).astype(np.float32), "actions": act,
            "rewards": rng.standard_normal((T, N)).astype(np.float32), "dones": dones,
            "terminateds": terms, "truncateds": truncs,
            "final_obs": rng.standard_normal((T, N, obs_dim)).astype(np.float32),
            "last_obs": rng.standard_normal((N, obs_dim)).astype(np.float32)}


@pytest.mark.parametrize("algo", ["sac", "td3", "ddpg"])
def test_training_step_matches_jax(monkeypatch, algo):
    jmod, tmod = (jsac, tsac) if algo == "sac" else (jtd3, ttd3)
    cls = {"sac": "SACConfig", "td3": "TD3Config", "ddpg": "DDPGConfig"}[algo]
    opts = dict(lr=1e-3, learning_starts=128, train_batch_size=32, updates_per_iteration=4,
                model={"hiddens": HID})
    ja, ta = build_both(monkeypatch,
                        getattr(jmod, cls)().environment("Pendulum-v1").training(**opts),
                        getattr(tmod, cls)().environment("Pendulum-v1").training(**opts),
                        [_rollout(s, 3, 1) for s in (1, 2)])
    jm, tm = ja.training_step(), ta.training_step()
    assert ta.num_updates == ja.num_updates == 4 and ta.env_steps == ja.env_steps
    assert tm["buffer_size"] == jm["buffer_size"] and tm["num_learner_updates"] == 4
    ours, theirs = ta.learner_group.get_weights(), ja.learner_group.get_weights()
    if algo == "sac":
        # SAC's actor gradient runs through log(1 - tanh(u)^2 + 1e-6), which
        # loses digits where tanh saturates (test_torch_rllib.py's squashed-
        # Gaussian test); Adam's normalized steps carry that into the policy
        # tower: 3e-5 there after 4 updates (1e-6 after one), 1e-5 elsewhere.
        assert_trees_close(ours.pop("pi"), theirs.pop("pi"), atol=3e-5)
    assert_trees_close(ours, theirs)
    assert_trees_close(ta.learner_group.get_extra(), ja.learner_group.get_extra())
    # The step's mean metrics. SAC's actor and critic losses hold
    # log(1 - tanh(u)^2 + 1e-6) of rows where tanh saturates, where one ulp
    # of tanh (XLA's and PyTorch's differ there) moves the term by percents:
    # 1e-3 for SAC's means over its 4 updates (the loss test holds every term
    # to 1e-5 at init), 1e-5 for TD3's and DDPG's.
    rel = 1e-3 if algo == "sac" else 1e-5
    for k in ("total_loss", "critic_loss", "actor_loss", "q_mean", "alpha"):
        if k in jm:
            assert tm[k] == pytest.approx(jm[k], rel=rel, abs=1e-5), k


def test_apex_training_step_matches_jax(monkeypatch):
    opts = dict(lr=1e-3, learning_starts=256, train_batch_size=32, updates_per_iteration=8,
                target_network_update_freq=3, buffer_capacity=4000, model={"hiddens": (8, 8)})
    ja, ta = build_both(monkeypatch,
                        japex.ApexDQNConfig().environment("CartPole-v1").training(**opts),
                        tapex.ApexDQNConfig().environment("CartPole-v1").training(**opts),
                        [_rollout(s, 4, 0) for s in (1, 2)])
    ta._sync_target()
    assert ta.worker_epsilons() == ja.worker_epsilons() == [0.4, 0.4 ** 8]
    for _ in range(2):
        jm, tm = ja.training_step(), ta.training_step()
    assert tm["fragments_pushed"] == jm["fragments_pushed"] == 8
    assert tm["replay_shard_sizes"] == jm["replay_shard_sizes"]
    assert ta.num_updates == ja.num_updates == 16 and ta.env_steps == ja.env_steps
    assert tm["beta"] == jm["beta"] and tm["num_learner_updates"] == 8
    assert_trees_close(ta.learner_group.get_weights(), ja.learner_group.get_weights())
    assert_trees_close(ta.target_params, ja.target_params)
    for ts, js in zip(ta.replay_shards, ja.replay_shards):
        theirs, ours = js._obj.buf, ts._obj.buf
        np.testing.assert_allclose(ours.stats()["priority_total"], theirs.stats()["priority_total"],
                                   rtol=1e-5)
        assert ours.stats()["max_priority"] == pytest.approx(theirs.stats()["max_priority"],
                                                             rel=1e-5)


def test_apex_rejects_what_it_owns():
    from ray_tpu_torch.rllib import ApexDQNConfig

    with pytest.raises(ValueError, match="per-worker epsilon"):
        ApexDQNConfig().environment("CartPole-v1").exploration(
            exploration_config={"type": "EpsilonGreedy"}).build()
    with pytest.raises(ValueError, match="sharded prioritized replay"):
        ApexDQNConfig().environment("CartPole-v1").training(
            replay_buffer_config={"type": "PrioritizedReplayBuffer"}).build()


# ------------------------------------------------------------------ the numpy Pendulum
def test_numpy_pendulum_equals_gymnasium():
    ours, theirs = chip_smoke.Pendulum(), gym.make("Pendulum-v1")
    o1, _ = ours.reset(seed=3)
    o2, _ = theirs.reset(seed=3)
    np.testing.assert_allclose(o1, o2, rtol=0, atol=1e-6)
    rng = np.random.default_rng(0)
    for step in range(1, 201):
        act = rng.uniform(-2.5, 2.5, (1,)).astype(np.float32)  # clipped to +-2 by both
        a, b = ours.step(act), theirs.step(act)
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-6)
        assert a[0].dtype == b[0].dtype == np.float32
        assert abs(a[1] - b[1]) <= 1e-6 and a[2:4] == b[2:4] == (False, step == 200)
    o1, o2 = ours.reset()[0], theirs.reset()[0]  # the generator carries on
    np.testing.assert_allclose(o1, o2, rtol=0, atol=1e-6)
    for space in ("observation_space", "action_space"):
        mine, gyms = getattr(ours, space), getattr(theirs, space)
        assert mine.shape == gyms.shape and mine.dtype == gyms.dtype
        np.testing.assert_array_equal(mine.low, gyms.low)
        np.testing.assert_array_equal(mine.high, gyms.high)


# ------------------------------------------------------------------ through the runtime
@pytest.fixture(scope="module")
def port():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.mark.parametrize("name", ["SAC", "TD3"])
def test_one_iteration_through_the_runtime(port, name):
    import ray_tpu_torch.rllib as rllib

    algo = (getattr(rllib, f"{name}Config")().environment(chip_smoke.Pendulum)
            .env_runners(num_env_runners=1, num_envs_per_runner=2, rollout_fragment_length=32)
            .training(learning_starts=32, train_batch_size=32, updates_per_iteration=4,
                      model={"hiddens": (16, 16)})
            .learners(num_gpus_per_learner=0).build())
    try:
        m = algo.train()
        assert m["num_learner_updates"] == 4 and np.isfinite(m["critic_loss"])
        assert m["buffer_size"] == 64 and (name == "TD3" or m["alpha"] > 0)
        runners = port.get([r.placement.remote() for r in algo.env_runners])
        assert [r["cuda_visible_devices"] for r in runners] == [""]
    finally:
        algo.stop()


def test_apex_dqn_distributed_replay(port):
    # tests/test_rllib_exploration.py:286 on the port: the shards fill, the
    # per-worker epsilons follow the power schedule, learner updates run and
    # refresh the shards' priorities.
    from ray_tpu_torch.rllib import ApexDQNConfig

    algo = (ApexDQNConfig().environment(chip_smoke.CartPole)
            .training(train_batch_size=32, learning_starts=96, updates_per_iteration=6,
                      buffer_capacity=4000)
            .env_runners(num_env_runners=2, num_envs_per_runner=2, rollout_fragment_length=32)
            .learners(num_gpus_per_learner=0).build())
    try:
        eps = algo.worker_epsilons()
        assert len(eps) == 2 and eps[0] > eps[1]
        for _ in range(6):
            res = algo.train()
            if "td_error_mean" in res:
                break
        assert "td_error_mean" in res, res
        assert len(res["replay_shard_sizes"]) == 2 and sum(res["replay_shard_sizes"]) >= 96
        stats = port.get([s.stats.remote() for s in algo.replay_shards])
        assert any(s["max_priority"] != 1.0 for s in stats)
        shards = port.get([s.placement.remote() for s in algo.replay_shards])
        assert [s["cuda_visible_devices"] for s in shards] == ["", ""]
    finally:
        algo.stop()
