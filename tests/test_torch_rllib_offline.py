"""The port's offline RLlib (JSON input, MARWIL, BC, CQL) against the JAX
package's, on the CPU, in f32, with inputs from a numpy seed.

- ``JsonWriter``/``JsonReader`` across the two packages: the same batches
  give byte-identical files, and each package's reader serves the other's
  files as its own, batch for batch from one seed.
- Each loss (MARWIL with beta 1, BC, CQL): one JAX module's weights carried
  across, one numpy batch; loss, aux and gradients within 1e-5 (absolute plus
  relative).
- One ``training_step`` of each against the JAX package's, both reading one
  JSON file, written once by the JAX package's writer and once by the
  port's: weights within 1e-5, MARWIL's advantage norm and the counters.
- A Dataset as input: ``build_input_reader`` gives a ``DatasetReader``,
  which cycles the same batches as the JAX package's over the same rows.
- Through the port's runtime (learner on the CPU): BC learns CartPole from
  expert JSON (tests/test_rllib_offline.py:124's bar), CQL learns the one-step
  task (tests/test_rllib_extras.py:344's bar), MARWIL's state round-trips.
"""

import os
import sys

import jax
import numpy as np
import pytest

from ray_tpu.rllib.algorithms import bc as jbc
from ray_tpu.rllib.algorithms import cql as jcql
from ray_tpu.rllib.algorithms import marwil as jmarwil
from ray_tpu.rllib.core import rl_module as jrl
from ray_tpu.rllib.offline import JsonReader as JaxJsonReader
from ray_tpu.rllib.offline import JsonWriter as JaxJsonWriter
from ray_tpu_torch.rllib.algorithms import bc as tbc
from ray_tpu_torch.rllib.algorithms import cql as tcql
from ray_tpu_torch.rllib.algorithms import marwil as tmarwil
from ray_tpu_torch.rllib.core import rl_module as trl
from ray_tpu_torch.rllib.offline import DatasetReader, InputReader, JsonReader, JsonWriter
from torch_rllib_parity import (  # noqa: F401 (one_thread is an autouse fixture)
    assert_loss_matches,
    assert_trees_close,
    build_both,
    jax_numpy,
    one_thread,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

HID = (8, 8)


def _expert(obs):
    # Push toward the pole's lean: near-perfect CartPole play.
    return int(obs[2] + 0.5 * obs[3] > 0)


def _episodes(n, seed0=0, random_odd=False):
    """Episodes of the scripted expert on the numpy CartPole (random actions
    on odd ones with ``random_odd``), as JsonWriter's per-episode columns."""
    rng = np.random.default_rng(0)
    for ep in range(n):
        env = chip_smoke.CartPole()
        obs, _ = env.reset(seed=seed0 + ep)
        rows = {k: [] for k in ("obs", "actions", "rewards", "terminateds", "truncateds")}
        done = False
        while not done:
            a = int(rng.integers(2)) if random_odd and ep % 2 else _expert(obs)
            nxt, r, term, trunc, _ = env.step(a)
            for k, v in zip(rows, (obs.tolist(), a, float(r), bool(term), bool(trunc))):
                rows[k].append(v)
            obs, done = nxt, term or trunc
        yield rows


def _write(writer_cls, path, batches):
    writer = writer_cls(str(path))
    for b in batches:
        writer.write(b)
    writer.close()
    return str(path)


def _continuous_batches(n, rows=32, obs_dim=3, seed=7):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        obs = rng.uniform(-1, 1, (rows, obs_dim)).astype(np.float32)
        actions = rng.uniform(-2, 2, (rows, 1)).astype(np.float32)
        yield {"obs": obs, "actions": actions,
               "rewards": (-np.square(actions[:, 0] - obs[:, 0])).astype(np.float32),
               "next_obs": rng.uniform(-1, 1, (rows, obs_dim)).astype(np.float32),
               "dones": (rng.random(rows) < 0.3).astype(np.float32)}


# ------------------------------------------------------------------ JSON input
@pytest.mark.parametrize("data", ["episodes", "continuous"])
def test_json_files_cross_between_the_packages(tmp_path, data):
    batches = list(_episodes(6) if data == "episodes" else _continuous_batches(5))
    ours = _write(JsonWriter, tmp_path / "torch", batches)
    theirs = _write(JaxJsonWriter, tmp_path / "jax", batches)
    name = "output-00000.json"
    with open(os.path.join(ours, name), "rb") as a, open(os.path.join(theirs, name), "rb") as b:
        assert a.read() == b.read()
    for path in (ours, theirs):
        for reader_pair in ((JsonReader, JaxJsonReader), (JaxJsonReader, JsonReader)):
            r1, r2 = (cls(path, batch_size=64, seed=3) for cls in reader_pair)
            for _ in range(8):  # across files' epochs: reshuffled, never exhausted
                a, b = r1.next(), r2.next()
                assert a.keys() == b.keys() and a["dones"][-1] == 1.0
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                    assert a[k].dtype == b[k].dtype


def test_json_reader_globs_lists_and_missing_files(tmp_path):
    path = _write(JsonWriter, tmp_path / "d", _episodes(2))
    for src in (path, os.path.join(path, "*.json"), [os.path.join(path, "output-00000.json")]):
        assert len(JsonReader(src, batch_size=8).next()["actions"]) >= 8
    with pytest.raises(FileNotFoundError):
        JsonReader(str(tmp_path / "nope" / "*.json"))


class _Dataset:
    """What the offline seam knows a Data ``Dataset`` by: ``iter_batches``."""

    def iter_batches(self, **kwargs):
        return iter(())


def test_input_sources_resolve_as_in_the_jax_package(tmp_path):
    path = _write(JsonWriter, tmp_path / "d", _episodes(2))
    cfg = tmarwil.MARWILConfig()
    with pytest.raises(ValueError, match="offline_data"):
        cfg.build_input_reader(batch_size=8)
    assert isinstance(cfg.offline_data(input_=path).build_input_reader(8), JsonReader)
    reader = JsonReader(path)
    assert cfg.offline_data(input_=reader).build_input_reader(8) is reader
    assert cfg.offline_data(input_=lambda: reader).build_input_reader(8) is reader
    assert isinstance(reader, InputReader)
    ds = _Dataset()
    got = cfg.offline_data(input_=ds).build_input_reader(8)
    assert isinstance(got, DatasetReader) and isinstance(got, InputReader)
    assert got.dataset is ds and got.batch_size == 8
    with pytest.raises(TypeError, match="unsupported offline input"):
        cfg.offline_data(input_=3).build_input_reader(8)


def test_compute_returns_equals_jax():
    rewards = np.array([1.0, 1.0, 1.0, 2.0, 2.0], np.float32)
    dones = np.array([0.0, 0.0, 1.0, 0.0, 1.0], np.float32)
    out = tmarwil.compute_returns(rewards, dones, gamma=0.5)
    np.testing.assert_allclose(out, [1.75, 1.5, 1.0, 3.0, 2.0], rtol=1e-6)
    rng = np.random.default_rng(0)
    r, d = rng.standard_normal(200).astype(np.float32), (rng.random(200) < 0.1).astype(np.float32)
    d[-1] = 1.0
    np.testing.assert_array_equal(tmarwil.compute_returns(r, d, 0.97),
                                  jmarwil.compute_returns(r, d, 0.97))


def test_bc_rejects_nonzero_beta():
    with pytest.raises(ValueError, match="beta"):
        tbc.BCConfig().training(beta=0.5)


# ------------------------------------------------------------------ losses
def _discrete_batch(seed, rows=64):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((rows, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, rows),
            "returns": (3.0 * rng.standard_normal(rows)).astype(np.float32),
            "ma_sqd_adv_norm": np.full(rows, 4.0, np.float32)}


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_marwil_loss_matches_jax(beta):
    jm, tm = jrl.MLPModule(4, 2, HID), trl.MLPModule(4, 2, HID)
    w = jax_numpy(jm.init(jax.random.PRNGKey(0)))
    cfgs = [m.MARWILConfig().training(beta=beta) for m in (jmarwil, tmarwil)]
    losses = [m.make_marwil_loss(c) for m, c in zip((jmarwil, tmarwil), cfgs)]
    assert np.isfinite(assert_loss_matches(*losses, jm, tm, w, _discrete_batch(1)))


def test_cql_loss_matches_jax():
    low, high = np.array([-2.0], np.float32), np.array([2.0], np.float32)
    jm, tm = (m.SquashedGaussianModule(3, low, high, HID) for m in (jrl, trl))
    w = jax_numpy(jm.init(jax.random.PRNGKey(0)))
    target = jax_numpy(jm.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    batch = next(_continuous_batches(1, rows=32))
    batch["terminateds"] = batch.pop("dones")
    r = 3
    batch.update(noise_next=rng.standard_normal((32, 1)).astype(np.float32),
                 noise_pi=rng.standard_normal((32, 1)).astype(np.float32),
                 cql_random_actions=rng.uniform(low, high, (32, r, 1)).astype(np.float32),
                 cql_noise_pi=rng.standard_normal((32, r, 1)).astype(np.float32),
                 cql_noise_next=rng.standard_normal((32, r, 1)).astype(np.float32))
    cfgs = [m.CQLConfig().training(min_q_weight=2.0) for m in (jcql, tcql)]
    losses = [m.make_cql_loss(c, -1.0) for m, c in zip((jcql, tcql), cfgs)]
    extra = {"q1": target["q1"], "q2": target["q2"]}
    assert np.isfinite(assert_loss_matches(*losses, jm, tm, w, batch, extra))


# ------------------------------------------------------------------ training_step
@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("algo", ["marwil", "bc", "cql"])
def test_training_step_matches_jax(monkeypatch, tmp_path, algo, writer):
    writer_cls = JaxJsonWriter if writer == "jax" else JsonWriter
    if algo == "cql":
        path = _write(writer_cls, tmp_path / "d", _continuous_batches(12))
        opts = dict(lr=1e-3, train_batch_size=32, updates_per_iteration=3, cql_num_actions=2,
                    model={"hiddens": HID})
        cfgs = [m.CQLConfig().environment("Pendulum-v1") for m in (jcql, tcql)]
    else:
        path = _write(writer_cls, tmp_path / "d", _episodes(8, random_odd=True))
        opts = dict(lr=1e-3, train_batch_size=128, updates_per_iteration=3,
                    model={"hiddens": HID})
        mods = (jmarwil, tmarwil) if algo == "marwil" else (jbc, tbc)
        cls = "MARWILConfig" if algo == "marwil" else "BCConfig"
        cfgs = [getattr(m, cls)().environment("CartPole-v1") for m in mods]
        if algo == "marwil":  # a rate that moves the norm visibly in 3 updates
            opts["moving_average_sqd_adv_norm_update_rate"] = 0.1
    ja, ta = build_both(monkeypatch, *(c.training(**opts).offline_data(input_=path)
                                      for c in cfgs))
    assert ta.env_runners == [] and ja.env_runners == []
    for _ in range(2):
        jm, tm = ja.training_step(), ta.training_step()
    assert tm["num_env_steps_trained"] == jm["num_env_steps_trained"]
    assert tm["num_learner_updates"] == 3 and tm["learn_time_s"] > 0
    ours, theirs = ta.learner_group.get_weights(), ja.learner_group.get_weights()
    if algo == "cql":
        # CQL runs SAC's loss: its policy tower as test_torch_rllib_offpolicy
        # states for SAC (the saturated tanh's log-Jacobian), 3e-5.
        assert_trees_close(ours.pop("pi"), theirs.pop("pi"), atol=3e-5)
        assert ta.num_updates == ja.num_updates == 6
        assert_trees_close(ta.learner_group.get_extra(), ja.learner_group.get_extra())
    assert_trees_close(ours, theirs)
    if algo == "marwil":
        assert tm["ma_sqd_adv_norm"] == pytest.approx(jm["ma_sqd_adv_norm"], rel=1e-5)
        assert tm["ma_sqd_adv_norm"] != pytest.approx(100.0)
    if algo == "bc":
        assert tm["vf_loss"] == jm["vf_loss"] == 0.0


# ------------------------------------------------------------------ through the runtime
@pytest.fixture(scope="module")
def port():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_bc_learns_from_expert_json(port, tmp_path):
    path = _write(JsonWriter, tmp_path / "d", _episodes(40))
    algo = (tbc.BCConfig().environment(chip_smoke.CartPole)
            .training(lr=1e-3, train_batch_size=512, updates_per_iteration=20)
            .offline_data(input_=path).learners(num_gpus_per_learner=0).build())
    try:
        assert algo.env_runners == []
        for _ in range(10):
            m = algo.train()
        assert np.isfinite(m["total_loss"]) and m["vf_loss"] == 0.0
        ev = algo.evaluate(num_episodes=8)
        assert ev["episode_return_mean"] > 150, ev
        placement = port.get(algo._eval_runner.placement.remote())
        assert placement["cuda_visible_devices"] == "" and placement["device"] == "cpu"
    finally:
        algo.stop()


def _transition_rows(episodes):
    return [{"obs": np.asarray(obs, np.float32), "actions": act}
            for ep in episodes for obs, act in zip(ep["obs"], ep["actions"])]


def test_dataset_reader_cycles_as_the_jax_packages(port):
    # tests/test_rllib_offline.py:95's rows: 80 rows asked of a 30-row
    # Dataset cycle through epochs; each package's reader over its own
    # Dataset of the same rows serves the same batches, in order.
    import ray_tpu
    from ray_tpu import data as jdata
    from ray_tpu.rllib.offline import DatasetReader as JaxDatasetReader
    from ray_tpu_torch import data as tdata

    items = [{"obs": np.full(4, i, np.float32), "actions": i % 2} for i in range(30)]
    ours = DatasetReader(tdata.from_items(items), batch_size=16)
    got = [ours.next() for _ in range(5)]
    port.shutdown()
    ray_tpu.init(num_cpus=4)
    try:
        theirs = JaxDatasetReader(jdata.from_items(items), batch_size=16)
        want = [theirs.next() for _ in range(5)]
    finally:
        ray_tpu.shutdown()
        port.init(num_cpus=4)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["actions", "obs"]
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert sum(len(b["actions"]) for b in got) == 80


def test_bc_learns_from_ray_data_dataset(port):
    # tests/test_rllib_offline.py:141: BC fed from a Dataset of the expert's
    # transition rows through DatasetReader; the same bar.
    from ray_tpu_torch import data as tdata

    ds = tdata.from_items(_transition_rows(_episodes(30)))
    algo = (tbc.BCConfig().environment(chip_smoke.CartPole)
            .training(lr=1e-3, train_batch_size=512, updates_per_iteration=20)
            .offline_data(input_=ds).learners(num_gpus_per_learner=0).build())
    try:
        assert isinstance(algo.reader, DatasetReader)
        for _ in range(10):
            m = algo.train()
        assert np.isfinite(m["total_loss"])
        ev = algo.evaluate(num_episodes=8)
        assert ev["episode_return_mean"] > 150, ev
    finally:
        algo.stop()


def test_cql_offline_learns(port, tmp_path):
    rng = np.random.default_rng(7)
    writer = JsonWriter(str(tmp_path / "data"))
    for _ in range(40):
        obs = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
        actions = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
        rewards = -np.square(actions[:, 0] - 0.5 * obs[:, 0])
        writer.write({"obs": obs, "actions": actions, "rewards": rewards.astype(np.float32),
                      "next_obs": rng.uniform(-1, 1, (64, 1)).astype(np.float32),
                      "dones": np.ones(64, np.float32)})
    writer.close()
    algo = (tcql.CQLConfig().environment(chip_smoke.LinearTargetEnv)
            .training(lr=1e-3, train_batch_size=256, updates_per_iteration=40,
                      min_q_weight=1.0, model={"hiddens": (32, 32)})
            .offline_data(input_=str(tmp_path / "data" / "*.json"))
            .evaluation(evaluation_duration=64)
            .learners(num_gpus_per_learner=0).build())
    try:
        for _ in range(8):
            m = algo.train()
        assert np.isfinite(m["critic_loss"]) and np.isfinite(m["cql_penalty"])
        ev = algo.evaluate()["evaluation"]
        assert ev["episode_return_mean"] > -0.15, ev
    finally:
        algo.stop()


def test_marwil_checkpoint_round_trips_its_norm(port, tmp_path):
    path = _write(JsonWriter, tmp_path / "d", _episodes(6))

    def build():
        return (tmarwil.MARWILConfig().environment(chip_smoke.CartPole)
                .training(lr=1e-3, train_batch_size=256, updates_per_iteration=4)
                .offline_data(input_=path).learners(num_gpus_per_learner=0).build())

    algo = build()
    try:
        algo.train()
        norm, ckpt = algo.ma_sqd_adv_norm, algo.save(str(tmp_path / "ck"))
    finally:
        algo.stop()
    again = build()
    try:
        again.restore(ckpt)
        assert again.ma_sqd_adv_norm == pytest.approx(norm) and again.iteration == 1
        again.train()
    finally:
        again.stop()
