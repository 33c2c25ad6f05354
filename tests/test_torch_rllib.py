"""The port's RLlib pieces (ray_tpu_torch.rllib) against the JAX package's
(ray_tpu.rllib) on the CPU, in f32, with inputs from a numpy seed.

JAX initializes the weights and ``params_from_numpy`` carries them across
(lists of ``{"w", "b"}`` layers, as in the JAX trees). Tolerances: module
forwards 1e-6 absolute; losses and their gradients 1e-5 relative (to each
leaf's largest value); learners' params after 5 updates 1e-5 absolute;
numpy-only code (GAE, n-step columns, replay buffers, env stepping) equal.
The two packages draw their random numbers from different generators
(``jax.random`` keys, ``torch.Generator``s), so sampled actions are held
against their distribution, not against JAX's draws.
"""

import os
import sys

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.core import distributional as jdist
from ray_tpu.rllib.core import rl_module as jrl
from ray_tpu.rllib.core.learner import JaxLearner
from ray_tpu.rllib.env.env_runner import EnvRunner as JaxEnvRunner
from ray_tpu.rllib.utils import replay_buffers as jbuf
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.training import tree_leaves, tree_map
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.core import distributional as tdist
from ray_tpu_torch.rllib.core import rl_module as trl
from ray_tpu_torch.rllib.core.learner import TorchLearner, adam
from ray_tpu_torch.rllib.env.env_runner import EnvRunner, VectorEnv
from ray_tpu_torch.rllib.utils import replay_buffers as tbuf

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

OBS, ACT, ROWS = 4, 3, 16


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread in this process for each test, as the port's RL
    actors run (the learners here are tiny; many threads per process under
    the suite's parallel workers only spin)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
HID = (8, 8)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _obs(seed=0, rows=ROWS, dim=OBS):
    return np.random.default_rng(seed).standard_normal((rows, dim)).astype(np.float32)


def _modules(kind, activation="tanh"):
    """The JAX and the port's module of one kind, at nano widths."""
    if kind == "mlp":
        return (jrl.MLPModule(OBS, ACT, HID, activation), trl.MLPModule(OBS, ACT, HID, activation))
    if kind == "q":
        return jrl.QMLPModule(OBS, ACT, HID, activation), trl.QMLPModule(OBS, ACT, HID, activation)
    if kind == "dueling":
        return (jdist.DuelingQMLPModule(OBS, ACT, HID, activation),
                tdist.DuelingQMLPModule(OBS, ACT, HID, activation))
    if kind.startswith("c51"):
        kw = dict(num_atoms=11, v_min=-5.0, v_max=5.0, dueling=kind == "c51_dueling")
        return (jdist.DistributionalQModule(OBS, ACT, HID, activation, **kw),
                tdist.DistributionalQModule(OBS, ACT, HID, activation, **kw))
    low, high = np.array([-2.0, -1.0], np.float32), np.array([2.0, 3.0], np.float32)
    if kind == "squashed":
        return (jrl.SquashedGaussianModule(OBS, low, high, HID, activation),
                trl.SquashedGaussianModule(OBS, low, high, HID, activation))
    return (jrl.DeterministicContinuousModule(OBS, low, high, HID, activation),
            trl.DeterministicContinuousModule(OBS, low, high, HID, activation))


def _pair(kind, activation="tanh", seed=0):
    jm, tm = _modules(kind, activation)
    w = _numpy(jm.init(jax.random.PRNGKey(seed)))
    return jm, tm, w, params_from_numpy(w, "cpu")


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


# ------------------------------------------------------------------ modules
KINDS = ["mlp", "q", "dueling", "c51", "c51_dueling", "squashed", "deterministic"]


@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(kind):
    jm, tm, w, tw = _pair(kind)
    obs = _obs()
    ja, jb = jm.forward(w, jnp.asarray(obs))
    ta, tb = tm.forward(tw, torch.as_tensor(obs))
    _close(ta, ja, 1e-6)
    _close(tb, jb, 1e-6)


@pytest.mark.parametrize("activation", ["tanh", "relu", "silu", "swish", "elu", "gelu"])
def test_activations_match_jax(activation):
    jm, tm, w, tw = _pair("mlp", activation)
    obs = _obs(1)
    for a, b in zip(tm.forward(tw, torch.as_tensor(obs)), jm.forward(w, jnp.asarray(obs))):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("kind", ["c51", "c51_dueling"])
def test_distributional_logits_and_probs_match_jax(kind):
    jm, tm, w, tw = _pair(kind)
    obs = _obs(2)
    _close(tm.dist_logits(tw, torch.as_tensor(obs)), jm.dist_logits(w, jnp.asarray(obs)), 1e-6)
    _close(tm.dist_probs(tw, torch.as_tensor(obs)), jm.dist_probs(w, jnp.asarray(obs)), 1e-6)


def test_squashed_gaussian_sample_and_q_match_jax():
    jm, tm, w, tw = _pair("squashed")
    obs = _obs(3)
    noise = np.random.default_rng(4).standard_normal((ROWS, 2)).astype(np.float32)
    ja, jlogp = jm.sample(w, jnp.asarray(obs), jnp.asarray(noise))
    ta, tlogp = tm.sample(tw, torch.as_tensor(obs), torch.as_tensor(noise))
    _close(ta, ja, 1e-6)
    # logp's tanh Jacobian, log(1 - tanh(u)^2 + 1e-6), loses digits where
    # tanh saturates: one f32 ulp of tanh(u) moves it by 2 ulp / (1 - tanh^2).
    # Held to a few ulps of that per action dim, plus 1e-5 for the sums.
    a_raw = (np.asarray(ja) - jm.center) / jm.scale
    ulps = 8 * np.finfo(np.float32).eps / (1 - a_raw ** 2 + 1e-6)
    assert np.all(np.abs(tlogp.numpy() - np.asarray(jlogp)) <= 1e-5 + ulps.sum(-1))
    _close(tm.q_values(tw["q2"], torch.as_tensor(obs), ta), jm.q_values(w["q2"], obs, ja), 1e-6)
    assert tw["log_alpha"].shape == () and float(tw["log_alpha"]) == float(w["log_alpha"])


@pytest.mark.parametrize("kind", KINDS)
def test_init_has_the_jax_tree(kind):
    jm, tm, w, _ = _pair(kind)
    ours = trl.as_generator(0)
    mine = tm.init(ours, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(w)[0]
    assert len(tree_leaves(mine)) == len(flat_j)
    for path, leaf in flat_j:
        node = mine
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32


def test_init_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trl.MLPModule(OBS, ACT).init(0)
    assert tree_leaves(trl.MLPModule(OBS, ACT).init(0, device="cpu"))[0].device.type == "cpu"


# ------------------------------------------------------------------ sampling
def _peaked_pair():
    """An MLP whose policy head gives a non-uniform distribution."""
    jm, tm, w, _ = _pair("mlp")
    w["pi"][-1]["w"] = w["pi"][-1]["w"] * 150.0
    return jm, tm, w, params_from_numpy(w, "cpu")


def test_action_dist_greedy_equals_jax():
    jm, tm, w, tw = _peaked_pair()
    obs = _obs(5)
    ja, jlogp, jv, jlogits = jm.action_dist(w, jnp.asarray(obs), jax.random.PRNGKey(0), False)
    ta, tlogp, tv, tlogits = tm.action_dist(tw, torch.as_tensor(obs), torch.Generator(), False)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for a, b in ((tlogp, jlogp), (tv, jv), (tlogits, jlogits)):
        _close(a, b, 1e-6)


def test_action_dist_samples_softmax():
    _, tm, _, tw = _peaked_pair()
    n = 100_000
    obs = torch.as_tensor(np.repeat(_obs(6, rows=1), n, axis=0))
    action, logp, _, logits = tm.action_dist(tw, obs, torch.Generator().manual_seed(0), True)
    p = torch.softmax(logits[0].double(), -1).numpy()
    assert p.min() < 0.2 and p.max() > 0.4  # a peaked distribution
    freq = np.bincount(action.numpy(), minlength=ACT) / n
    sigma = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 4 * sigma), (freq, p)
    expected = torch.log_softmax(logits, -1).gather(-1, action[:, None])[:, 0]
    _close(logp, expected, 1e-6)


def test_epsilon_greedy_matches_jax_and_dithers():
    jm, tm, w, tw = _pair("q")
    obs = _obs(7)
    ja, _, jv, jq = jm.epsilon_greedy(w, jnp.asarray(obs), jax.random.PRNGKey(0), False, 0.3)
    ta, tz, tv, tq = tm.epsilon_greedy(tw, torch.as_tensor(obs), torch.Generator(), False, 0.3)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _close(tv, jv, 1e-6)
    _close(tq, jq, 1e-6)
    assert not tz.any()
    n, eps = 100_000, 0.3
    obs = torch.as_tensor(np.repeat(_obs(8, rows=1), n, axis=0))
    action, _, _, q = tm.epsilon_greedy(tw, obs, torch.Generator().manual_seed(1), True, eps)
    p = np.full(ACT, eps / ACT)
    p[int(q[0].argmax())] += 1 - eps
    freq = np.bincount(action.numpy(), minlength=ACT) / n
    assert np.all(np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / n)), (freq, p)


# ------------------------------------------------------------------ losses
def _ppo_batch(seed=0, rows=ROWS):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((rows, ACT)).astype(np.float32)
    actions = rng.integers(0, ACT, rows)
    logp = jax.nn.log_softmax(logits)[np.arange(rows), actions]
    return {"obs": _obs(seed, rows), "actions": actions, "logp": np.asarray(logp, np.float32),
            "behavior_logits": logits, "advantages": rng.standard_normal(rows).astype(np.float32),
            "value_targets": rng.standard_normal(rows).astype(np.float32),
            "kl_coeff": np.full(rows, 0.2, np.float32)}


def _dqn_batch(seed=0, rows=ROWS, n_step=False):
    rng = np.random.default_rng(seed)
    b = {"obs": _obs(seed, rows), "actions": rng.integers(0, ACT, rows),
         "rewards": rng.standard_normal(rows).astype(np.float32),
         "next_obs": _obs(seed + 100, rows),
         "terminateds": (rng.random(rows) < 0.25).astype(np.float32),
         "loss_weight": rng.uniform(0.5, 1.0, rows).astype(np.float32)}
    if n_step:
        b["discount"] = (0.99 ** rng.integers(1, 4, rows)).astype(np.float32)
    return b


def _loss_case(case):
    """(jax module, port module, jax loss, port loss, batch, target params?)"""
    kind, algo, *opts = case.split("-")
    jm, tm, w, tw = _pair(kind)
    if algo == "ppo":
        jcfg, tcfg = jppo.PPOConfig(), tppo.PPOConfig()
        for c in (jcfg, tcfg):
            c.training(entropy_coeff=0.01, vf_clip_param=1.0)
        return jm, tm, w, tw, jppo.make_ppo_loss(jcfg), tppo.make_ppo_loss(tcfg), _ppo_batch(1), None
    jcfg, tcfg = jdqn.DQNConfig(), tdqn.DQNConfig()
    for c in (jcfg, tcfg):
        c.training(double_q="single" not in opts)
    make = "make_c51_loss" if kind.startswith("c51") else "make_dqn_loss"
    target = _numpy(jm.init(jax.random.PRNGKey(1)))
    batch = _dqn_batch(2, n_step="nstep" in opts)
    return (jm, tm, w, tw, getattr(jdqn, make)(jcfg), getattr(tdqn, make)(tcfg), batch,
            {"target_params": target})


LOSS_CASES = ["mlp-ppo", "q-dqn-double", "q-dqn-single", "q-dqn-double-nstep",
              "dueling-dqn-double", "c51-c51-double", "c51-c51-single",
              "c51_dueling-c51-double-nstep"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-12))


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_and_gradients_match_jax(case):
    jm, tm, w, tw, jloss, tloss, batch, extra = _loss_case(case)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}

    def jf(p):
        return jloss(jm, p, jbatch, extra) if extra else jloss(jm, p, jbatch)

    (jl, jaux), jg = jax.value_and_grad(jf, has_aux=True)(w)
    for leaf in tree_leaves(tw):
        leaf.requires_grad_(True)
    if extra:
        textra = {"target_params": params_from_numpy(extra["target_params"], "cpu")}
        tl, taux = tloss(tm, tw, tbatch, textra)
    else:
        tl, taux = tloss(tm, tw, tbatch)
    tg = torch.autograd.grad(tl, tree_leaves(tw))
    assert _rel(tl.item(), jl) <= 1e-5
    assert taux.keys() == jaux.keys()
    for k in jaux:
        assert _rel(taux[k].detach(), jaux[k]) <= 1e-5, k
    grads = _unflatten(tw, tg)
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        node = grads
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        assert _rel(node, g) <= 1e-5, (case, path)


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# ------------------------------------------------------------------ learners
@pytest.mark.parametrize("case,grad_clip", [("mlp-ppo", 0.5), ("mlp-ppo", None),
                                             ("q-dqn-double", 0.5), ("c51-c51-double", 0.5)])
def test_torch_learner_matches_jax_learner(case, grad_clip):
    jm, tm, w, _, jloss, tloss, _, extra = _loss_case(case)
    lr = 1e-3
    if grad_clip is None:  # each learner's default: adam(learning_rate), no clipping
        jl = JaxLearner(jm, jloss, learning_rate=lr)
        tl = TorchLearner(tm, tloss, learning_rate=lr, device="cpu")
    else:
        jl = JaxLearner(jm, jloss, optimizer=optax.chain(optax.clip_by_global_norm(grad_clip),
                                                          optax.adam(lr)))
        tl = TorchLearner(tm, tloss, optimizer=adam(lr, grad_clip), device="cpu")
    jl.set_weights(jax.tree.map(jnp.asarray, w))
    jl.opt_state = jl.optimizer.init(jl.params)
    tl.set_weights(w)
    if extra:
        jl.set_extra(jax.tree.map(jnp.asarray, extra))
        tl.set_extra(extra)
    make = _ppo_batch if case == "mlp-ppo" else _dqn_batch
    for i in range(5):
        batch = make(10 + i)
        jm_ = jl.update(batch)
        tm_ = tl.update(batch)
        assert jm_.keys() == tm_.keys()
        for k in jm_:
            assert _rel(tm_[k], jm_[k]) <= 1e-5, (i, k)
    ours = tl.get_weights()
    for a, b in zip(tree_leaves(ours), tree_leaves(_reorder(ours, _numpy(jl.get_weights())))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def _reorder(ours, theirs):
    """``theirs`` (a JAX tree, keys sorted) in the key order of ``ours``."""
    return tree_map(lambda _, t: t, ours, theirs)


def test_torch_learner_state_round_trips_and_mesh_raises():
    _, tm, w, _, _, tloss, batch, _ = _loss_case("mlp-ppo")
    a = TorchLearner(tm, tloss, optimizer=adam(1e-3, 0.5), device="cpu")
    before = a.get_weights()
    kept = [x.copy() for x in tree_leaves(before)]
    a.update(batch)
    # get_weights copies: what it returned (e.g. DQN's target) stays put.
    for x, y in zip(tree_leaves(before), kept):
        np.testing.assert_array_equal(x, y)
    b = TorchLearner(tm, tloss, optimizer=adam(1e-3, 0.5), device="cpu", seed=7)
    b.load_state(a.state())
    ma, mb = a.update(batch), b.update(batch)
    assert ma == mb
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 3"):
        TorchLearner(tm, tloss, mesh=object(), device="cpu")


# ------------------------------------------------------------------ numpy code
def test_compute_gae_and_n_step_columns_equal_jax():
    rng = np.random.default_rng(0)
    T, N = 32, 4
    dones = (rng.random((T, N)) < 0.1).astype(np.float32)
    terms = dones * (rng.random((T, N)) < 0.5)
    ro = {"rewards": rng.standard_normal((T, N)).astype(np.float32),
          "values": rng.standard_normal((T, N)).astype(np.float32), "dones": dones,
          "terminateds": terms.astype(np.float32),
          "bootstrap_values": rng.standard_normal((T, N)).astype(np.float32),
          "last_values": rng.standard_normal(N).astype(np.float32)}
    for k, v in jppo.compute_gae(ro, 0.99, 0.95).items():
        np.testing.assert_array_equal(tppo.compute_gae(ro, 0.99, 0.95)[k], v)
    for n in (1, 3):
        for a, b in zip(tdqn.n_step_columns(ro["rewards"], dones, n, 0.9),
                        jdqn.n_step_columns(ro["rewards"], dones, n, 0.9)):
            np.testing.assert_array_equal(a, b)


def _transitions(seed, n):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, OBS)).astype(np.float32),
            "actions": rng.integers(0, ACT, n), "rewards": rng.standard_normal(n).astype(np.float32),
            "loss_weight": np.ones(n, np.float32)}


def test_replay_buffers_sample_as_jax():
    for cls in ("ReplayBuffer", "PrioritizedReplayBuffer"):
        ours, theirs = getattr(tbuf, cls)(100), getattr(jbuf, cls)(100)
        r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
        for i in range(4):
            batch = _transitions(i, 40)
            ours.add(batch)
            theirs.add(batch)
            a, b = ours.sample(16, r1), theirs.sample(16, r2)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
            if cls == "PrioritizedReplayBuffer":
                td = np.random.default_rng(i).random(16)
                ours.update_priorities(a["batch_indexes"], td)
                theirs.update_priorities(b["batch_indexes"], td)


# ------------------------------------------------------------------ env stepping
def _cartpole(max_steps):
    return lambda: gym.make("CartPole-v1", max_episode_steps=max_steps)


def test_vector_env_matches_sync_vector_env_same_step():
    n = 4
    ours = VectorEnv([_cartpole(10)] * n)
    theirs = gym.vector.SyncVectorEnv([_cartpole(10)] * n,
                                      autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)
    o1, _ = ours.reset(seed=5)
    o2, _ = theirs.reset(seed=5)
    np.testing.assert_array_equal(o1, o2)
    rng = np.random.default_rng(0)
    finals = 0
    for _ in range(200):
        act = rng.integers(0, 2, n)
        a, b = ours.step(act), theirs.step(act)
        for x, y in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        assert ("final_obs" in a[4]) == ("final_obs" in b[4])
        if "final_obs" in b[4]:
            finals += 1
            np.testing.assert_array_equal(a[4]["_final_obs"], b[4]["_final_obs"])
            for f1, f2 in zip(a[4]["final_obs"], b[4]["final_obs"]):
                assert (f1 is None) == (f2 is None)
                if f2 is not None:
                    np.testing.assert_array_equal(f1, f2)
    assert finals > 20  # truncations at 10 steps and terminations both seen


@pytest.mark.parametrize("kind", ["mlp", "q"])
def test_env_runner_deterministic_rollout_matches_jax(kind):
    jm = jrl.MLPModule(OBS, 2, HID) if kind == "mlp" else jrl.QMLPModule(OBS, 2, HID)
    tm = trl.MLPModule(OBS, 2, HID) if kind == "mlp" else trl.QMLPModule(OBS, 2, HID)
    w = _numpy(jm.init(jax.random.PRNGKey(3)))
    kw = dict(num_envs=3, rollout_length=48, seed=11, record_final_obs=True)
    ours = EnvRunner(_cartpole(20), tm, **kw)
    theirs = JaxEnvRunner(_cartpole(20), jm, **kw)
    ours.set_weights(w)
    theirs.set_weights(jax.tree.map(jnp.asarray, w))
    for _ in range(2):  # across a fragment boundary
        a, b = ours.sample(explore=False), theirs.sample(explore=False)
        assert a.keys() == b.keys()
        for k in b:
            if k in ("values", "behavior_logits", "bootstrap_values", "last_values", "logp"):
                _close(a[k], b[k], 1e-6)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert b["truncateds"].any() and b["dones"].any()
    assert ours.episode_stats() == theirs.episode_stats()


STRATEGIES = [("q", {"type": "EpsilonGreedy"}), ("q", {"type": "SoftQ", "temperature": 0.5}),
              ("mlp", {"type": "Random"}), ("mlp", {"type": "StochasticSampling"}),
              ("mlp", {"type": "ParameterNoise", "stddev": 0.1}),
              ("deterministic", {"type": "GaussianNoise", "random_timesteps": 100}),
              ("deterministic", {"type": "OrnsteinUhlenbeckNoise"}),
              ("squashed", {"type": "Random"})]


@pytest.mark.parametrize("kind,strategy", STRATEGIES)
def test_exploration_strategies_match_jax_when_greedy(kind, strategy):
    env = "Pendulum-v1" if kind in ("deterministic", "squashed") else "CartPole-v1"
    jm, tm = _modules(kind)
    if env == "Pendulum-v1":
        jm, tm = (type(m)(3, np.array([-2.0], np.float32), np.array([2.0], np.float32), HID)
                  for m in (jm, tm))
    else:
        jm, tm = type(jm)(OBS, 2, HID), type(tm)(OBS, 2, HID)
    w = _numpy(jm.init(jax.random.PRNGKey(4)))
    kw = dict(num_envs=2, rollout_length=16, seed=5, exploration=strategy)
    ours = EnvRunner(lambda: gym.make(env, max_episode_steps=12), tm, **kw)
    theirs = JaxEnvRunner(lambda: gym.make(env, max_episode_steps=12), jm, **kw)
    ours.set_weights(w)
    theirs.set_weights(jax.tree.map(jnp.asarray, w))
    a, b = ours.sample(explore=False), theirs.sample(explore=False)
    for k in b:
        _close(a[k], b[k], 1e-5)
    explored = ours.sample(explore=True)["actions"]
    if env == "Pendulum-v1":
        assert np.all(np.abs(explored) <= 2.0)
    else:
        assert set(np.unique(explored)) <= {0, 1}


def test_numpy_cartpole_equals_gymnasium():
    ours, theirs = chip_smoke.CartPole(), gym.make("CartPole-v1")
    o1, _ = ours.reset(seed=0)
    o2, _ = theirs.reset(seed=0)
    np.testing.assert_array_equal(o1, o2)
    rng = np.random.default_rng(0)
    dones = 0
    for _ in range(2000):
        act = int(rng.integers(0, 2))
        a, b = ours.step(act), theirs.step(act)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].dtype == b[0].dtype and a[1:4] == b[1:4]
        if a[2] or a[3]:
            dones += 1
            np.testing.assert_array_equal(ours.reset()[0], theirs.reset()[0])
    assert dones > 50
    assert ours.observation_space.shape == theirs.observation_space.shape
    np.testing.assert_array_equal(ours.observation_space.high, theirs.observation_space.high)
    assert ours.action_space.n == theirs.action_space.n
