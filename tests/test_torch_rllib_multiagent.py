"""Multi-agent RLlib in the port against the JAX package's, on the CPU.

- The env protocol: one numpy env class (``chip_smoke.CartPole``, with a short
  time limit so agents terminate and truncate) through both packages'
  ``make_multi_agent``: the same obs, rewards and terminated/truncated dicts
  (with ``"__all__"``) over 200 steps, exactly.
- ``MultiAgentEnvRunner`` with the JAX runner's weights carried over and
  ``explore=False``: per-policy actions and rewards exactly, obs, logp,
  logits, ``advantages`` and ``value_targets`` within 1e-5; the replay mode's
  transition columns the same way, for Q modules on CartPole and SAC's module
  on the numpy Pendulum.
- One multi-agent ``training_step`` each of PPO, DQN and SAC against the JAX
  package's on the same per-policy rollouts (stub runners,
  ``tests/torch_rllib_parity.py``): per-policy weights, targets and counters
  within 1e-5, each policy's learner given the same batches row for row.
  SAC's policy tower drifts further from the JAX package's through its
  near-saturated tanh's log-Jacobian (ROADMAP.md Queue 3): 2e-3, and bit for
  bit against the port's own single-policy learner on the same batches.
- The ``ValueError``s of the policy map, word for word the JAX package's,
  ``policies_to_train``, save/restore, the runner's callback hooks, and a
  short multi-agent PPO run through the port's runtime.
"""

import os
import sys

import numpy as np
import pytest
import torch

import ray_tpu.rllib as jrl
import ray_tpu_torch
import ray_tpu_torch.rllib as trl
from ray_tpu.rllib.env.multi_agent_env_runner import MultiAgentEnvRunner as JaxRunner
from ray_tpu_torch.models.training import tree_leaves
from ray_tpu_torch.rllib.env.multi_agent_env_runner import MultiAgentEnvRunner
from torch_rllib_parity import (  # noqa: F401 (one_thread is an autouse fixture)
    FixedRunner,
    Stub,
    assert_trees_close,
    jax_numpy,
    one_thread,
    patch_runtimes,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

ATOL = 1e-5
SAC_PI_ATOL = 2e-3  # 2 lr: see test_training_step_matches_jax


def two_policies(aid):
    return "p0" if aid == "0" else "p1"


def short_cartpole():
    return chip_smoke.CartPole(max_episode_steps=30)


def short_pendulum():
    return chip_smoke.Pendulum(max_episode_steps=40)


# ------------------------------------------------------------------ the env protocol
@pytest.mark.parametrize("source", ["numpy", "gymnasium id"])
def test_env_protocol_matches_jax(source):
    env_of = short_cartpole if source == "numpy" else "CartPole-v1"
    envs = [pkg.make_multi_agent(env_of)({"num_agents": 3}) for pkg in (jrl, trl)]
    assert [set(e.observation_space) for e in envs] == [{"0", "1", "2"}] * 2
    resets = [e.reset(seed=0)[0] for e in envs]
    rng = np.random.default_rng(0)
    obs, done, ends = resets[0], set(), 0
    for a, b in zip(*resets):
        np.testing.assert_array_equal(resets[0][a], resets[1][b])
    for _ in range(200):
        actions = {aid: int(rng.integers(0, 2)) for aid in obs if aid not in done}
        steps = [e.step(dict(actions)) for e in envs]
        (jo, jr, jte, jtr, _), (to, tr, tte, ttr, _) = steps
        assert jo.keys() == to.keys() and jr == tr and jte == tte and jtr == ttr
        for aid in jo:
            np.testing.assert_array_equal(jo[aid], to[aid])
        assert "__all__" in tte and "__all__" in ttr
        for aid in tr:
            if tte[aid] or ttr[aid]:
                done.add(aid)
                assert aid in to  # the final obs is still reported
        obs = to
        if tte["__all__"] or ttr["__all__"]:
            assert done == {"0", "1", "2"}
            ends += 1
            resets = [e.reset()[0] for e in envs]
            for aid in resets[0]:
                np.testing.assert_array_equal(resets[0][aid], resets[1][aid])
            obs, done = resets[1], set()
    assert ends >= 2
    for e in envs:
        e.close()


# ------------------------------------------------------------------ the runner
def _runners(env, jax_modules, torch_modules, **kw):
    """The JAX and the port's runner on the same env class and seed, the
    port's given the JAX runner's initial weights."""
    kw = dict(num_envs=2, rollout_length=48, seed=3, **kw)
    creator = [pkg.make_multi_agent(env) for pkg in (jrl, trl)]
    jr = JaxRunner(lambda: creator[0]({"num_agents": 3}), jax_modules, two_policies, **kw)
    tr = MultiAgentEnvRunner(lambda: creator[1]({"num_agents": 3}), torch_modules, two_policies,
                             **kw)
    tr.set_weights(jax_numpy(jr._params))
    return jr, tr


def _assert_batches_match(jb, tb, exact=("actions", "rewards", "terminateds", "loss_weight")):
    assert jb.keys() == tb.keys() == {"p0", "p1"}
    for pid in jb:
        assert jb[pid].keys() == tb[pid].keys()
        for k in jb[pid]:
            a, b = np.asarray(tb[pid][k]), np.asarray(jb[pid][k])
            assert a.shape == b.shape, (pid, k)
            if k in exact and a.dtype.kind in "iu":
                np.testing.assert_array_equal(a, b, err_msg=f"{pid}/{k}")
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=f"{pid}/{k}")


def test_runner_gae_columns_match_jax():
    jm = {p: jrl.MLPModule(4, 2) for p in ("p0", "p1")}
    tm = {p: trl.MLPModule(4, 2) for p in ("p0", "p1")}
    jr, tr = _runners(short_cartpole, jm, tm, gamma=0.97, lambda_=0.9)
    for _ in range(2):  # the second fragment continues open trajectories
        jb, tb = jr.sample(explore=False), tr.sample(explore=False)
        _assert_batches_match(jb, tb)
        assert set(tb["p0"]) == {"obs", "actions", "logp", "behavior_logits", "advantages",
                                 "value_targets"}
        # p1 holds two agents of each env's three.
        assert len(tb["p1"]["actions"]) > len(tb["p0"]["actions"])
        assert jr.episode_stats() == tr.episode_stats()
    assert tr.placement()["device"] == "cpu"


@pytest.mark.parametrize("kind", ["q", "squashed_gaussian"])
def test_runner_replay_columns_match_jax(kind):
    if kind == "q":
        env, make = short_cartpole, lambda pkg: pkg.ModelCatalog.get_module(
            "q", 4, __import__("types").SimpleNamespace(n=2), {"hiddens": (32, 32)})
    else:
        space = chip_smoke.Pendulum().action_space
        env, make = short_pendulum, lambda pkg: pkg.SquashedGaussianModule(
            3, space.low, space.high, hiddens=(32, 32))
    jr, tr = _runners(env, {p: make(jrl) for p in ("p0", "p1")},
                      {p: make(trl) for p in ("p0", "p1")})
    assert jr.value_based and tr.value_based
    for _ in range(2):
        jb, tb = jr.sample(explore=False), tr.sample(explore=False)
        _assert_batches_match(jb, tb)
        assert set(tb["p0"]) == {"obs", "actions", "rewards", "next_obs", "terminateds",
                                 "loss_weight"}
    if kind == "q":  # some agents terminated and some fragment tails stayed open
        terms = np.concatenate([tb[p]["terminateds"] for p in tb])
        assert 0 < terms.sum() < len(terms)


def test_runner_fires_the_callbacks_hooks():
    seen = []

    class Hooks(trl.DefaultCallbacks):
        def on_episode_end(self, *, episode, **kw):
            seen.append(("ep", episode.episode_return, episode.episode_length))

        def on_sample_end(self, *, samples, **kw):
            seen.append(("sample", sorted(samples)))

    runner = MultiAgentEnvRunner(lambda: trl.make_multi_agent(short_cartpole)({"num_agents": 2}),
                                 {"shared": trl.MLPModule(4, 2)}, lambda aid: "shared",
                                 num_envs=1, rollout_length=64, callbacks=Hooks)
    runner.sample()
    assert ("sample", ["shared"]) in seen
    eps = [s for s in seen if s[0] == "ep"]
    # Two 30-step-limited cartpoles: episodes ended, each worth at most 60.
    assert eps and all(0 < ret <= 60 and 0 < n <= 30 for _, ret, n in eps)


# ------------------------------------------------------------------ one training step
def _ma(cfg, env):
    return (cfg.environment(lambda c=None: env({"num_agents": 2}))
            .multi_agent(policies=["p0", "p1"], policy_mapping_fn=two_policies))


def _pg_batch(rng, n):
    logits = (0.1 * rng.standard_normal((n, 2))).astype(np.float32)
    actions = rng.integers(0, 2, n)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32), "actions": actions,
            "logp": np.take_along_axis(logp, actions[:, None], -1)[:, 0],
            "behavior_logits": logits,
            "advantages": rng.standard_normal(n).astype(np.float32),
            "value_targets": rng.standard_normal(n).astype(np.float32)}


def _replay_batch(rng, n, obs_dim, continuous):
    actions = (rng.uniform(-2, 2, (n, 1)).astype(np.float32) if continuous
               else rng.integers(0, 2, n))
    return {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32), "actions": actions,
            "rewards": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "terminateds": (rng.random(n) < 0.1).astype(np.float32),
            "loss_weight": (rng.random(n) < 0.95).astype(np.float32)}


def _samples(kind, seed):
    """One runner fragment: per-policy batches, p1 twice p0's rows."""
    rng = np.random.default_rng(seed)
    make = {"ppo": lambda n: _pg_batch(rng, n),
            "dqn": lambda n: _replay_batch(rng, n, 4, False),
            "sac": lambda n: _replay_batch(rng, n, 3, True)}[kind]
    return {"p0": make(96), "p1": make(192)}


def _configs(kind):
    """(JAX config, port config) of ``kind``'s policy map: the JAX side on
    gymnasium's env (its algorithm reads gymnasium spaces), the port's on the
    numpy one (spaces read by attribute)."""
    if kind == "ppo":
        opts = dict(lr=3e-4, minibatch_size=64, num_epochs=2, entropy_coeff=0.01)
        return (_ma(jrl.PPOConfig().training(**opts), jrl.make_multi_agent("CartPole-v1")),
                _ma(trl.PPOConfig().training(**opts), trl.make_multi_agent(chip_smoke.CartPole)))
    if kind == "dqn":
        opts = dict(lr=1e-3, learning_starts=128, train_batch_size=32, updates_per_iteration=4,
                    target_network_update_freq=3, model={"hiddens": (32, 32)})
        return (_ma(jrl.DQNConfig().training(**opts), jrl.make_multi_agent("CartPole-v1")),
                _ma(trl.DQNConfig().training(**opts), trl.make_multi_agent(chip_smoke.CartPole)))
    # SAC at tests/test_torch_rllib_offpolicy.py's parity size (hiddens 8, 8).
    opts = dict(lr=1e-3, learning_starts=128, train_batch_size=32, updates_per_iteration=4,
                model={"hiddens": (8, 8)})
    return (_ma(jrl.SACConfig().training(**opts), jrl.make_multi_agent("Pendulum-v1")),
            _ma(trl.SACConfig().training(**opts), trl.make_multi_agent(chip_smoke.Pendulum)))


def _build_both(monkeypatch, kind, **ma):
    """Both packages' policy map, no runners built, then the same stub runners
    (two fragments) and the JAX learners' weights and targets."""
    patch_runtimes(monkeypatch)
    jcfg, tcfg = _configs(kind)
    if ma:
        jcfg, tcfg = jcfg.multi_agent(**ma), tcfg.multi_agent(**ma)
    ja = jcfg.env_runners(num_env_runners=0).build()
    ta = tcfg.env_runners(num_env_runners=0).learners(num_gpus_per_learner=0).build()
    assert set(ta.learner_groups) == set(ja.learner_groups) == {"p0", "p1"}
    for pid, lg in ta.learner_groups.items():
        lg.set_weights(jax_numpy(ja.learner_groups[pid].get_weights()))
        extra = ja.learner_groups[pid].get_extra()
        if extra is not None and kind == "sac":
            lg.set_extra(jax_numpy(extra))
    if kind == "dqn":
        ta._sync_target()
    for a in (ja, ta):
        a.env_runners = [Stub(FixedRunner(_samples(kind, s))) for s in (1, 2)]
    return ja, ta


def _capture_updates(algo):
    """Record every batch each policy's learner group is given."""
    seen = {pid: [] for pid in algo.learner_groups}
    for pid, lg in algo.learner_groups.items():
        def update(batch, _orig=lg.update, _seen=seen[pid]):
            _seen.append({k: np.array(v) for k, v in batch.items()})
            return _orig(batch)

        lg.update = update
    return seen


def _replay_alone(ta, pid, weights, extra, batches):
    """The port's single-policy learner from ``weights``/``extra`` over
    ``batches``: what policy ``pid``'s learner in the map must have done."""
    from ray_tpu_torch.rllib.core.learner import TorchLearner

    lr = TorchLearner(ta.modules[pid], ta.make_loss(), optimizer=ta.make_optimizer(),
                      extra_update_fn=ta.make_extra_update(), device="cpu")
    lr.set_weights(weights)
    lr.set_extra(extra)
    metrics = [lr.update(b) for b in batches]
    means = {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}
    return lr.get_weights(), lr.get_extra(), means


@pytest.mark.parametrize("kind", ["ppo", "dqn", "sac"])
def test_training_step_matches_jax(monkeypatch, kind):
    ja, ta = _build_both(monkeypatch, kind)
    start = {pid: (lg.get_weights(), lg.get_extra()) for pid, lg in ta.learner_groups.items()}
    jseen, tseen = _capture_updates(ja), _capture_updates(ta)
    jm, tm = ja.training_step(), ta.training_step()
    # Each policy's learner got the same batches, row for row (the replay
    # maps' rows and SAC's host-drawn noise included).
    for pid in ("p0", "p1"):
        assert len(tseen[pid]) == len(jseen[pid]) > 0
        for tb, jb in zip(tseen[pid], jseen[pid]):
            assert tb.keys() == jb.keys()
            for k in tb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=f"{pid}/{k}")
    # SAC's means hold log(1 - tanh(u)^2 + 1e-6) of near-saturated rows,
    # where XLA's and PyTorch's f32 tanh differ by an ulp and 1 - tanh^2
    # keeps few digits, over updates whose policy towers drift apart (below):
    # 1e-2 relative and absolute (logp_pi_mean sums rows of both signs to
    # near 0; the single-agent step's 4 updates hold 1e-3 relative,
    # tests/test_torch_rllib_offpolicy.py), and exactly the port's own
    # single-policy learner's below.
    tol = dict(rel=1e-2, abs=1e-2) if kind == "sac" else dict(rel=1e-4, abs=1e-5)
    for k, v in jm.items():
        assert k in tm, k
        if k.startswith("policy_"):
            assert tm[k] == pytest.approx(v, **tol), k
    assert tm["num_env_steps_sampled"] == jm["num_env_steps_sampled"]
    for pid in ("p0", "p1"):
        tw, jw = ta.learner_groups[pid].get_weights(), ja.learner_groups[pid].get_weights()
        if kind == "sac":
            # The policy tower's gradient runs through that log-Jacobian, and
            # Adam's first steps (about lr per element whatever the gradient's
            # size) carry its last digits into the weights: here up to 1.4e-3
            # after 4 updates at lr 1e-3 (ROADMAP.md Queue 3). The tower is
            # held to the JAX package's within 2 lr, and bit for bit to the
            # port's own single-policy learner on the same batches.
            assert_trees_close(tw.pop("pi"), jw.pop("pi"), SAC_PI_ATOL)
            alone, alone_extra, means = _replay_alone(ta, pid, *start[pid], tseen[pid])
            assert {k: tm[f"policy_{pid}/{k}"] for k in means} == means
            for a, b in zip(tree_leaves(alone), tree_leaves(ta.learner_groups[pid].get_weights())):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(tree_leaves(alone_extra),
                            tree_leaves(ta.learner_groups[pid].get_extra())):
                np.testing.assert_array_equal(a, b)
            assert_trees_close(ta.learner_groups[pid].get_extra(),
                               jax_numpy(ja.learner_groups[pid].get_extra()), ATOL)
        assert_trees_close(tw, jw, ATOL)
    if kind == "ppo":
        assert ta.kl_coeff == ja.kl_coeff and set(ta.kl_coeff) == {"p0", "p1"}
        assert tm["num_learner_updates"] == 2 * (3 + 6)  # 2 epochs of 192 and 384 rows
    else:
        assert ta.num_updates == ja.num_updates == 8 and ta.env_steps == ja.env_steps == 576
        assert {p: b.size for p, b in ta.buffers.items()} == \
            {p: b.size for p, b in ja.buffers.items()} == {"p0": 192, "p1": 384}
    if kind == "dqn":
        # Target syncs at updates 3 and 6: p0's at its third, p1's at its second.
        assert tm["epsilon"] == jm["epsilon"] == 1.0
        for pid in ("p0", "p1"):
            assert_trees_close(ta.target_params[pid], ja.target_params[pid], ATOL)


def test_log_jacobian_gradient_where_tanh_nears_saturation():
    # What SAC's policy tower drifts by above: d/du log(1 - tanh(u)^2 + 1e-6)
    # agrees in both frameworks where tanh is far from 1, loses digits near
    # it, and where one framework's f32 tanh has rounded to 1 and the other's
    # not (u 8.5 here) is 0 in one and about -0.21 in the other.
    import jax
    import jax.numpy as jnp

    u = np.array([3.0, 6.0, 8.5], np.float32)
    jg = np.asarray(jax.grad(lambda x: jnp.sum(jnp.log(1.0 - jnp.tanh(x) ** 2 + 1e-6)))(
        jnp.asarray(u)))
    t = torch.tensor(u, requires_grad=True)
    tg, = torch.autograd.grad(torch.log(1.0 - torch.tanh(t) ** 2 + 1e-6).sum(), t)
    tg = tg.numpy()
    assert tg[0] == pytest.approx(jg[0], rel=1e-5)
    assert abs(tg[1] - jg[1]) > 1e-4 * abs(jg[1])
    assert abs(tg[2] - jg[2]) > 0.1


def test_policies_to_train_freezes_the_others(monkeypatch):
    _, ta = _build_both(monkeypatch, "ppo", policies=["p0", "p1"],
                        policy_mapping_fn=two_policies, policies_to_train=["p0"])
    before = {pid: lg.get_weights() for pid, lg in ta.learner_groups.items()}
    m = ta.train()
    after = {pid: lg.get_weights() for pid, lg in ta.learner_groups.items()}
    for a, b in zip(tree_leaves(before["p1"]), tree_leaves(after["p1"])):
        np.testing.assert_array_equal(a, b)
    assert max(float(np.abs(a - b).max())
               for a, b in zip(tree_leaves(before["p0"]), tree_leaves(after["p0"]))) > 0
    assert "policy_p0/total_loss" in m and "policy_p1/total_loss" not in m


@pytest.mark.parametrize("kind", ["ppo", "dqn", "sac"])
def test_save_restore_round_trips_every_policy(monkeypatch, tmp_path, kind):
    _, ta = _build_both(monkeypatch, kind)
    ta.train()
    if kind == "ppo":
        ta.kl_coeff["p1"] = 0.456
    path = ta.save(str(tmp_path / "ck"))
    _, tb = _build_both(monkeypatch, kind)
    tb.restore(path)
    assert tb.iteration == 1
    for pid in ("p0", "p1"):
        for a, b in zip(tree_leaves(ta.learner_groups[pid].state()),
                        tree_leaves(tb.learner_groups[pid].state())):
            np.testing.assert_array_equal(a, b)
    extra_a, extra_b = ta._extra_state(), tb._extra_state()
    assert extra_a.keys() == extra_b.keys()
    for a, b in zip(tree_leaves(extra_a), tree_leaves(extra_b)):
        np.testing.assert_array_equal(a, b)
    if kind == "ppo":
        assert tb.kl_coeff["p1"] == pytest.approx(0.456)
    tb.train()  # trains on after the restore


# ------------------------------------------------------------------ the policy map's errors
def _err(cfg):
    with pytest.raises(ValueError) as e:
        cfg.build()
    return str(e.value)


@pytest.mark.parametrize("case", ["algorithm", "exploration", "no mapping", "outside the map",
                                  "unmapped policy", "dqn knobs"])
def test_policy_map_errors_match_jax(monkeypatch, case):
    patch_runtimes(monkeypatch)
    got = []
    for pkg, env in ((jrl, "CartPole-v1"), (trl, chip_smoke.CartPole)):
        creator = pkg.make_multi_agent(env)
        cfg = {"algorithm": pkg.TD3Config, "dqn knobs": pkg.DQNConfig}.get(case, pkg.PPOConfig)()
        cfg = cfg.environment(lambda c=None, m=creator: m({"num_agents": 2})).env_runners(
            num_env_runners=0)
        if pkg is trl:
            cfg = cfg.learners(num_gpus_per_learner=0)
        ma = {"policies": ["p0", "p1"], "policy_mapping_fn": two_policies}
        if case == "exploration":
            cfg = cfg.exploration(exploration_config={"type": "EpsilonGreedy"})
        elif case == "no mapping":
            ma.pop("policy_mapping_fn")
        elif case == "outside the map":
            ma["policy_mapping_fn"] = lambda aid: "p0" if aid == "0" else "p9"
        elif case == "unmapped policy":
            ma["policies"] = ["p0", "p1", "p2"]
        elif case == "dqn knobs":
            cfg = cfg.training(n_step=3)
        got.append(_err(cfg.multi_agent(**ma)))
    assert got[0] == got[1]
    assert {"algorithm": "does not support multi-agent", "exploration": "single-agent only",
            "no mapping": "policy_mapping_fn is required", "outside the map": "'p9'",
            "unmapped policy": "no agent maps to policies ['p2']",
            "dqn knobs": "single-agent DQN knobs"}[case] in got[1]


def test_remote_learners_beyond_the_cluster_gpus_raise(monkeypatch):
    # Two policies, one remote learner each at the default 1 GPU, on a
    # one-GPU cluster: the second group's actor would wait forever.
    monkeypatch.setattr(ray_tpu_torch, "cluster_resources", lambda: {"CPU": 8.0, "GPU": 1.0})
    cfg = _configs("ppo")[1].env_runners(num_env_runners=0).learners(num_learners=1)
    with pytest.raises(ValueError, match=r"ask for 2\.0 GPU, but the cluster has 1\.0"):
        cfg.build()


# ------------------------------------------------------------------ through the runtime
def test_multi_agent_ppo_runs_through_the_runtime(tmp_path):
    marker = str(tmp_path / "hooks.log")

    class Hooks(trl.DefaultCallbacks):
        def on_episode_end(self, *, episode, **kw):
            with open(marker, "a") as f:
                f.write(f"ep {episode.episode_return}\n")

        def on_sample_end(self, *, samples, **kw):
            with open(marker, "a") as f:
                f.write(f"sample {sorted(samples)}\n")

    creator = trl.make_multi_agent(chip_smoke.CartPole)
    cfg = (trl.PPOConfig().environment(lambda c=None: creator({"num_agents": 2}))
           .env_runners(num_env_runners=2, num_envs_per_runner=2, rollout_fragment_length=64)
           .training(lr=3e-4, minibatch_size=128, num_epochs=2, entropy_coeff=0.01)
           # A lambda: the runner actors cannot import this test module.
           .multi_agent(policies=["p0", "p1"],
                        policy_mapping_fn=lambda aid: "p0" if aid == "0" else "p1")
           .evaluation(evaluation_duration=2)
           .callbacks(Hooks)
           .learners(num_gpus_per_learner=0))
    ray_tpu_torch.init(num_cpus=4)
    try:
        algo = cfg.build()
        try:
            for _ in range(3):
                m = algo.train()
                for pid in ("p0", "p1"):
                    assert np.isfinite(m[f"policy_{pid}/total_loss"])
            assert m["training_iteration"] == 3 and m["num_env_steps_sampled"] > 0
            ev = algo.evaluate()["evaluation"]
            assert ev["num_episodes"] >= 2 and ev["num_env_steps_sampled"] > 0
            assert [p["device"] for lg in algo.learner_groups.values()
                    for p in lg.placement()] == ["cpu", "cpu"]
            runners = ray_tpu_torch.get([r.placement.remote() for r in algo.env_runners])
            assert all(r["cuda_visible_devices"] == "" and r["device"] == "cpu"
                       and r["num_threads"] == 1 for r in runners)
        finally:
            algo.stop()
    finally:
        ray_tpu_torch.shutdown()
    lines = open(marker).read().splitlines()
    assert any(line == "sample ['p0', 'p1']" for line in lines), lines
    assert any(line.startswith("ep ") for line in lines)
