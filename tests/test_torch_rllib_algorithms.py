"""The RLlib slice as a whole: PPO and DQN through the port's Algorithm, on
the CPU (``num_gpus_per_learner=0``).

- One ``training_step`` of each against the JAX package's on the same
  rollouts (made with numpy from a seed and fed to both through runners
  stubbed the same way), from the same weights: weights after the step 1e-5
  absolute, PPO's ``kl_coeff`` equal, DQN's target network equal.
- Through the port's runtime: PPO and DQN learn CartPole by the JAX tests'
  bars (tests/test_rllib.py:45-65, :291-305), save and restore round-trip, and
  two remote learners keep equal weights.
"""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.rllib import DQNConfig as JaxDQNConfig
from ray_tpu.rllib import PPOConfig as JaxPPOConfig
from ray_tpu_torch.models.training import tree_leaves, tree_map
from ray_tpu_torch.rllib import DQNConfig, PPOConfig

T, N, OBS = 64, 4, 4


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread in this process for each test, as the port's RL
    actors run (the learners here are tiny; many threads per process under
    the suite's parallel workers only spin)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Call:
    def __init__(self, fn):
        self.remote = fn


class _StubRunner:
    """An env runner whose ``sample`` returns a fixed rollout: its methods'
    ``.remote`` return values, which the patched ``get`` passes through."""

    def __init__(self, rollout):
        self.set_weights = _Call(lambda w: None)
        self.set_exploration = _Call(lambda v: None)
        self.sample = _Call(lambda explore=None: rollout)
        self.episode_stats = _Call(lambda clear=True: {"episodes": 0})


def _rollout(seed, algo):
    rng = np.random.default_rng(seed)
    dones = (rng.random((T, N)) < 0.08).astype(np.float32)
    terms = (dones * (rng.random((T, N)) < 0.7)).astype(np.float32)
    ro = {"obs": rng.standard_normal((T, N, OBS)).astype(np.float32),
          "actions": rng.integers(0, 2, (T, N)),
          "rewards": np.ones((T, N), np.float32), "dones": dones, "terminateds": terms,
          "truncateds": dones - terms,
          "last_obs": rng.standard_normal((N, OBS)).astype(np.float32)}
    if algo == "ppo":
        logits = (0.1 * rng.standard_normal((T, N, 2))).astype(np.float32)
        logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        ro.update(behavior_logits=logits,
                  logp=np.take_along_axis(logp, ro["actions"][..., None], -1)[..., 0],
                  values=rng.standard_normal((T, N)).astype(np.float32),
                  bootstrap_values=rng.standard_normal((T, N)).astype(np.float32),
                  last_values=rng.standard_normal(N).astype(np.float32))
    else:
        ro["final_obs"] = rng.standard_normal((T, N, OBS)).astype(np.float32)
    return ro


def _pass_through(refs):
    return refs


def _both(monkeypatch, jax_cfg, cfg, algo):
    """The JAX and the port's algorithm, built without runners, given the
    same stub runners and the JAX learner's weights."""
    monkeypatch.setattr(ray_tpu, "get", _pass_through)
    monkeypatch.setattr(ray_tpu_torch, "get", _pass_through)
    ja = jax_cfg.env_runners(num_env_runners=0).build()
    ta = cfg.env_runners(num_env_runners=0).learners(num_gpus_per_learner=0).build()
    ta.learner_group.set_weights(ja.learner_group.get_weights())
    for a in (ja, ta):
        a.env_runners = [_StubRunner(_rollout(s, algo)) for s in (1, 2)]
    return ja, ta


def _assert_trees_close(ours, theirs, atol):
    theirs = tree_map(lambda _, t: np.asarray(t), ours, theirs)  # the JAX tree's keys, sorted
    for a, b in zip(tree_leaves(ours), tree_leaves(theirs)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_ppo_training_step_matches_jax(monkeypatch):
    opts = dict(lr=3e-4, minibatch_size=128, num_epochs=4, entropy_coeff=0.01, kl_target=0.002)
    ja, ta = _both(monkeypatch, JaxPPOConfig().environment("CartPole-v1").training(**opts),
                   PPOConfig().environment("CartPole-v1").training(**opts), "ppo")
    jm, tm = ja.training_step(), ta.training_step()
    assert tm["num_learner_updates"] == 16
    _assert_trees_close(ta.learner_group.get_weights(), ja.learner_group.get_weights(), 1e-5)
    assert ta.kl_coeff == ja.kl_coeff
    for k in ("total_loss", "policy_loss", "vf_loss", "entropy", "grad_norm"):
        assert tm[k] == pytest.approx(jm[k], rel=1e-5, abs=1e-6), k


@pytest.mark.parametrize("n_step,replay", [(1, None), (3, None),
                                           (1, {"type": "PrioritizedReplayBuffer"})])
def test_dqn_training_step_matches_jax(monkeypatch, n_step, replay):
    opts = dict(lr=1e-3, learning_starts=256, train_batch_size=32, updates_per_iteration=8,
                target_network_update_freq=3, n_step=n_step, replay_buffer_config=replay)
    ja, ta = _both(monkeypatch, JaxDQNConfig().environment("CartPole-v1").training(**opts),
                   DQNConfig().environment("CartPole-v1").training(**opts), "dqn")
    ta._sync_target()
    jm, tm = ja.training_step(), ta.training_step()
    assert tm["num_learner_updates"] == 8 and ta.num_updates == ja.num_updates == 8
    _assert_trees_close(ta.learner_group.get_weights(), ja.learner_group.get_weights(), 1e-5)
    _assert_trees_close(ta.target_params, ja.target_params, 1e-5)
    assert tm["epsilon"] == jm["epsilon"] and tm["buffer_size"] == jm["buffer_size"]


# ------------------------------------------------------------------ through the runtime
@pytest.fixture(scope="module")
def port():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _ppo_config():
    return (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_runner=4, rollout_fragment_length=64)
            .training(lr=3e-4, gamma=0.99, lambda_=0.95, minibatch_size=128, num_epochs=4,
                      entropy_coeff=0.01)
            .learners(num_gpus_per_learner=0))


def _dqn_config():
    return (DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_runner=4, rollout_fragment_length=64)
            .training(lr=1e-3, gamma=0.99, learning_starts=500, train_batch_size=64,
                      updates_per_iteration=48, target_network_update_freq=100,
                      epsilon_decay_steps=6000)
            .learners(num_gpus_per_learner=0))


def test_ppo_cartpole_improves(port):
    algo = _ppo_config().build()
    try:
        first, best = None, -np.inf
        for _ in range(12):
            result = algo.train()
            ret = result.get("episode_return_mean")
            if ret is not None:
                first = ret if first is None else first
                best = max(best, ret)
        assert first is not None, "no episodes completed"
        assert best > first + 30, f"no learning: first={first:.1f} best={best:.1f}"
        assert result["training_iteration"] == 12 and np.isfinite(result["total_loss"])
        placement = algo.learner_group.placement()
        assert [p["device"] for p in placement] == ["cpu"]
        runners = port.get([r.placement.remote() for r in algo.env_runners])
        assert all(r["cuda_visible_devices"] == "" and r["device"] == "cpu"
                   and r["num_threads"] == 1 for r in runners)
    finally:
        algo.stop()


def test_dqn_cartpole_improves(port):
    algo = _dqn_config().build()
    try:
        best = 0.0
        for _ in range(25):
            m = algo.train()
            best = max(best, m.get("episode_return_mean", 0.0))
            if best >= 60.0:
                break
        assert best >= 60.0, f"best return {best}"
        assert m["epsilon"] < 1.0 and m["buffer_size"] > 0
    finally:
        algo.stop()


@pytest.mark.parametrize("make", [_ppo_config, _dqn_config])
def test_save_restore_round_trips(port, tmp_path, make):
    algo = make().build()
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
        restored = make().build()
        try:
            restored.restore(path)
            assert restored.iteration == algo.iteration == 1
            for a, b in zip(tree_leaves(algo.learner_group.state()),
                            tree_leaves(restored.learner_group.state())):
                np.testing.assert_array_equal(a, b)
            assert restored._extra_state().keys() == algo._extra_state().keys()
            for a, b in zip(tree_leaves(algo._extra_state()), tree_leaves(restored._extra_state())):
                np.testing.assert_array_equal(a, b)
            restored.train()
        finally:
            restored.stop()
    finally:
        algo.stop()


def test_two_learners_keep_equal_weights(port):
    algo = _ppo_config().learners(num_learners=2).build()
    try:
        for _ in range(2):
            assert np.isfinite(algo.train()["total_loss"])
            w = port.get([lr.get_weights.remote() for lr in algo.learner_group._remote])
            for a, b in zip(tree_leaves(w[0]), tree_leaves(w[1])):
                np.testing.assert_array_equal(a, b)
        assert [p["cuda_visible_devices"] for p in algo.learner_group.placement()] == ["", ""]
    finally:
        algo.stop()


def test_what_is_not_ported_raises(monkeypatch):
    # Multi-agent training (ROADMAP.md item 7d) is ported now: the shared
    # replay iteration runs on a stub algorithm (tests/test_torch_rllib_
    # multiagent.py holds it against the JAX package's).
    # Offline input from a Data Dataset (known by its iter_batches) is
    # ported too (item 11): it resolves to a DatasetReader.
    from ray_tpu_torch.rllib.offline import DatasetReader

    dataset = type("Dataset", (), {"iter_batches": lambda self, **kw: iter(())})()
    reader = PPOConfig().offline_data(input_=dataset).build_input_reader(batch_size=8)
    assert isinstance(reader, DatasetReader) and reader.dataset is dataset
    with pytest.raises(ValueError, match="torch"):
        PPOConfig().framework("jax")
    import types

    from ray_tpu_torch.rllib.algorithms.dqn import replay_ma_training_step
    from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer

    monkeypatch.setattr(ray_tpu_torch, "get", _pass_through)

    class _Group:
        def __init__(self):
            self.batches = []

        def get_weights(self):
            return {"w": np.zeros(2, np.float32)}

        def update(self, batch):
            self.batches.append(batch)
            return {"total_loss": 1.0, "td_abs": np.zeros(len(batch["rewards"]))}

    rng = np.random.default_rng(0)
    cols = {"obs": rng.standard_normal((8, OBS)).astype(np.float32),
            "actions": rng.integers(0, 2, 8), "rewards": np.ones(8, np.float32),
            "next_obs": rng.standard_normal((8, OBS)).astype(np.float32),
            "terminateds": np.zeros(8, np.float32), "loss_weight": np.ones(8, np.float32)}
    algo = types.SimpleNamespace(
        config=DQNConfig().training(learning_starts=4, train_batch_size=4,
                                    updates_per_iteration=2),
        learner_groups={"p0": _Group()}, env_runners=[_StubRunner({"p0": cols})],
        buffers={"p0": ReplayBuffer(100)}, env_steps=0, num_updates=0, _rng=rng,
        collect_episode_metrics=lambda out: out)
    algo.policy_weights = lambda: {p: g.get_weights() for p, g in algo.learner_groups.items()}
    out = replay_ma_training_step(algo, exploration=0.5)
    assert out["policy_p0/total_loss"] == 1.0 and out["epsilon"] == 0.5
    assert algo.num_updates == 2 and algo.env_steps == 8 and out["policy_p0/buffer_size"] == 8
    assert [len(b["rewards"]) for b in algo.learner_groups["p0"].batches] == [4, 4]


def test_exports_are_the_jax_packages_less_multi_agent():
    # The name is kept from when multi-agent training was not ported: the
    # exports are now the JAX package's, with TorchLearner for JaxLearner.
    import ray_tpu.rllib as jax_rllib
    import ray_tpu_torch.rllib as rllib

    want = set(jax_rllib.__all__) - {"JaxLearner"} | {"TorchLearner"}
    assert set(rllib.__all__) == want and len(rllib.__all__) == len(jax_rllib.__all__)
    assert {"MultiAgentEnv", "make_multi_agent", "MultiAgentEnvRunner"} <= set(rllib.__all__)
    assert all(hasattr(rllib, name) for name in rllib.__all__)
    import ray_tpu.rllib.offline as jax_offline
    import ray_tpu_torch.rllib.offline as offline

    # DatasetReader came with Data: offline's exports are the JAX package's.
    assert offline.__all__ == jax_offline.__all__
