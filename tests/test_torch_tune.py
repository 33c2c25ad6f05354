"""The port's Tune (``ray_tpu_torch.tune``) against the JAX package's
(``ray_tpu.tune``) on the CPU, and its GPU seams.

- Search spaces: one seed and one ``param_space`` expand to the same configs
  in both packages, exactly (both draw from ``random.Random``); TPE makes the
  same suggestions from the same observations, exactly.
- Schedulers: ASHA, the median stopping rule and PBT reach the same decision
  on every result of one scripted sequence, and PBT's ``_explore`` gives the
  same configs from one seed.
- Sweeps through both runtimes in this process: a function trainable gives
  the same ``ResultGrid`` metrics; a Trainer sweep (the JAX package's
  ``DataParallelTrainer`` on its nano GPT step, the port's ``TorchTrainer``
  on the same weights carried by ``params_from_numpy``, ``device="cpu"``)
  gives per-trial losses within rtol 1e-5, the tolerance of
  ``tests/test_torch_train.py``.
- Seams (ROADMAP.md Queue 3): (a) ``GPU`` in ``resources_per_trial`` becomes
  the trial actor's ``num_gpus`` and ``TPU`` raises; (b) ``fit()`` bounds the
  trials that run at once by every resource of a trial's footprint, a
  Trainer's gang included, and refuses a trial the cluster cannot hold; (c)
  a PBT exploit hands the restarted trial the donor's checkpoint of torch
  tensors, read in place, and the journal and spec hold tensors as CPU
  tensors.
"""

import glob
import hashlib
import json
import os
import pickle
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import tune as jtune
from ray_tpu_torch import tune as ttune

RTOL = 1e-5


def _space(tune):
    return {
        "a": tune.grid_search([1, 2, 3]),
        "lr": tune.loguniform(1e-5, 1e-1),
        "u": tune.uniform(-1.0, 1.0),
        "q": tune.quniform(0.0, 10.0, 0.5),
        "n": tune.randint(2, 9),
        "qn": tune.qrandint(0, 100, 10),
        "ln": tune.lograndint(1, 1000),
        "g": tune.randn(0.0, 2.0),
        "act": tune.choice(["relu", "gelu", "tanh"]),
        "nested": {"b": tune.grid_search(["x", "y"]), "d": 7,
                   "c": tune.sample_from(lambda spec: spec["a"] * 10)},
    }


@pytest.mark.parametrize("seed", [0, 7])
def test_variant_generation_matches_jax(seed):
    from ray_tpu.tune.search.basic_variant import BasicVariantGenerator as JGen
    from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator as TGen

    want = list(JGen(seed=seed).generate(_space(jtune), num_samples=3))
    got = list(TGen(seed=seed).generate(_space(ttune), num_samples=3))
    assert len(got) == 3 * 3 * 2 and got == want  # exactly: the same random.Random draws
    assert TGen().count(_space(ttune), 3) == JGen().count(_space(jtune), 3) == 18


def _quadratic(cfg):
    return (np.log10(cfg["lr"]) + 3) ** 2 + (cfg["u"] - 0.25) ** 2 + 0.1 * cfg["n"] + (
        0.0 if cfg["act"] == "gelu" else 0.5)


def test_tpe_suggestions_match_jax():
    # Both get the same observations, so each suggestion (random for the
    # first 4, then from the Parzen models) must be the same, exactly.
    from ray_tpu.tune.search import TPESearcher as JTPE
    from ray_tpu_torch.tune.search import TPESearcher as TTPE

    def space(tune):
        return {"lr": tune.loguniform(1e-5, 1e-1), "u": tune.uniform(-1.0, 1.0),
                "n": tune.randint(1, 8), "act": tune.choice(["relu", "gelu", "tanh"])}

    searchers = []
    for cls, tune in ((JTPE, jtune), (TTPE, ttune)):
        s = cls(n_initial_points=4, n_candidates=12)
        s.set_search_properties("score", "min", space(tune), seed=3)
        searchers.append(s)
    for i in range(14):
        want, got = (s.suggest(f"t{i}") for s in searchers)
        assert got == want, i
        for s in searchers:
            s.on_trial_complete(f"t{i}", {"score": _quadratic(want)})
    assert len(searchers[1]._observations) == 14


class _Trial:
    """What the schedulers read of a trial, the same object for both."""

    def __init__(self, trial_id, config):
        self.trial_id, self.config = trial_id, dict(config)
        self.last_result, self.checkpoint, self.restore_checkpoint = None, None, None

    def metric(self, name, default=float("nan")):
        return float((self.last_result or {}).get(name, default))


class _Runner:
    def __init__(self, trials):
        self.trials = trials


def _scripted(scheduler, n_trials=6, steps=12):
    """Feed ``scheduler`` one fixed sequence of results (trials of different
    slopes, interleaved in a fixed order) and return each decision, with the
    config and donor of every PBT restart."""
    trials = [_Trial(f"t{i}", {"lr": [1e-4, 3e-4, 1e-3][i % 3], "w": i}) for i in range(n_trials)]
    runner = _Runner(trials)
    for t in trials:
        scheduler.on_trial_add(runner, t)
    rng = np.random.default_rng(0)
    out, stopped = [], set()
    for step in range(1, steps + 1):
        for i in rng.permutation(n_trials):
            t = trials[i]
            if t.trial_id in stopped:
                continue
            score = (i + 1) * step * 0.1 + float(rng.normal(0, 0.05))
            result = {"training_iteration": step, "score": score}
            t.last_result = result
            t.checkpoint = f"ckpt-{t.trial_id}-{step}"
            decision = scheduler.on_trial_result(runner, t, result)
            record = [t.trial_id, step, decision]
            if decision == "RESTART":
                record += [t.restore_checkpoint, sorted(t.config.items())]
            elif decision == "STOP":
                stopped.add(t.trial_id)
            out.append(record)
    return out


@pytest.mark.parametrize("name", ["asha", "median", "pbt"])
def test_scheduler_decisions_match_jax(name):
    import ray_tpu.tune.schedulers as js
    import ray_tpu_torch.tune.schedulers as ts

    def make(mod, tune):
        if name == "asha":
            s = mod.ASHAScheduler(max_t=12, grace_period=2, reduction_factor=2)
        elif name == "median":
            s = mod.MedianStoppingRule(grace_period=2, min_samples_required=2)
        else:
            s = mod.PopulationBasedTraining(
                perturbation_interval=3, quantile_fraction=0.34, seed=5,
                hyperparam_mutations={"lr": [1e-4, 3e-4, 1e-3], "w": tune.uniform(0.0, 10.0)})
        s.set_objective("score", "max")
        return s

    want, got = _scripted(make(js, jtune)), _scripted(make(ts, ttune))
    assert got == want
    kinds = {r[2] for r in got}
    assert kinds == {"CONTINUE", {"asha": "STOP", "median": "STOP", "pbt": "RESTART"}[name]}


def test_pbt_explore_matches_jax():
    from ray_tpu.tune.schedulers import PopulationBasedTraining as JPBT
    from ray_tpu_torch.tune.schedulers import PopulationBasedTraining as TPBT

    def explored(cls, tune):
        pbt = cls(hyperparam_mutations={"lr": [1e-4, 3e-4, 1e-3], "mom": tune.uniform(0.1, 0.9),
                                        "bs": lambda: 64},
                  resample_probability=0.4, seed=11)
        cfg = {"lr": 3e-4, "mom": 0.5, "bs": 32, "fixed": "x"}
        out = []
        for _ in range(20):
            cfg = pbt._explore(cfg)
            out.append(dict(cfg))
        return out

    assert explored(TPBT, ttune) == explored(JPBT, jtune)


@pytest.fixture
def both():
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _make_objective(package):
    """A function trainable reporting through ``package``'s session (made by
    a factory, so cloudpickle ships it by value)."""

    def objective(config):
        import importlib

        session = importlib.import_module(package + ".air.session")
        for i in range(4):
            session.report({"score": config["x"] * (i + 1) + config["nested"]["y"],
                            "i": i})

    return objective


def test_function_sweep_result_grid_matches_jax(both, tmp_path):
    grids = []
    for pkg, tune, name in ((ray_tpu, jtune, "jax"), (ray_tpu_torch, ttune, "port")):
        air = __import__(pkg.__name__ + ".air", fromlist=["RunConfig"])
        grids.append(tune.Tuner(
            _make_objective(pkg.__name__),
            param_space={"x": tune.grid_search([1.0, 2.0, 3.0]),
                         "nested": {"y": tune.uniform(0.0, 1.0)}},
            tune_config=tune.TuneConfig(metric="score", mode="max", search_seed=4),
            run_config=air.RunConfig(name=name, storage_path=str(tmp_path),
                                     stop={"training_iteration": 3}),
        ).fit())

    def view(grid):
        keep = ("score", "i", "training_iteration", "config")
        return [({k: r.metrics[k] for k in keep}, r.error) for r in grid]

    jgrid, tgrid = grids
    assert view(tgrid) == view(jgrid)
    assert [r["training_iteration"] for r, _ in view(tgrid)] == [3, 3, 3]
    assert tgrid.get_best_result().metrics["config"] == jgrid.get_best_result().metrics["config"]
    assert tgrid.get_best_result(metric="score", mode="min").metrics["config"]["x"] == 1.0


# ------------------------------------------------------------------ a Trainer sweep
LRS = [1e-3, 3e-3]


def _make_jax_loop():
    def loop(config):
        import jax
        import jax.numpy as jnp

        from ray_tpu.air import session
        from ray_tpu.models import GPTConfig, TrainState, default_optimizer, make_train_step

        cfg = GPTConfig.nano(dtype=jnp.float32)
        opt = default_optimizer(learning_rate=config["lr"])
        params = jax.tree.map(jnp.asarray, config["params"])
        state = TrainState(params=params, opt_state=opt.init(params), step=jnp.asarray(0))
        step = make_train_step(cfg, opt, donate=False)
        for _ in range(config["steps"]):
            state, m = step(state, {"tokens": jnp.asarray(config["tokens"])})
            session.report({"loss": float(m["loss"])})

    return loop


def _make_port_loop():
    def loop(config):
        import torch

        from ray_tpu_torch.air import session
        from ray_tpu_torch.models import GPTConfig, TrainState, default_optimizer, make_train_step
        from ray_tpu_torch.models.convert import params_from_numpy

        cfg = GPTConfig.nano(dtype=torch.float32)
        opt = default_optimizer(learning_rate=config["lr"])
        params = params_from_numpy(config["params"], "cpu", requires_grad=True)
        state = TrainState(params=params, opt_state=opt.init(params), step=0)
        step = make_train_step(cfg, opt)
        for _ in range(config["steps"]):
            state, m = step(state, {"tokens": torch.as_tensor(config["tokens"])})
            session.report({"loss": m["loss"].item()})

    return loop


def _losses_by_lr(results):
    out = {}
    for r in results:
        out[r["config"]["train_loop_config"]["lr"]] = out.get(
            r["config"]["train_loop_config"]["lr"], []) + [r["loss"]]
    return out


def test_trainer_sweep_matches_jax(both, tmp_path):
    from ray_tpu.air import RunConfig as JRunConfig
    from ray_tpu.air import ScalingConfig as JScalingConfig
    from ray_tpu.models import GPTConfig as JGPTConfig
    from ray_tpu.models import create_train_state as j_create
    from ray_tpu.models import default_optimizer as j_optimizer
    from ray_tpu.train import DataParallelTrainer
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    state = j_create(JGPTConfig.nano(dtype=jnp.float32), jax.random.PRNGKey(0), j_optimizer())
    loop_config = {"params": jax.tree.map(np.asarray, state.params), "steps": 3,
                   "tokens": np.random.default_rng(0).integers(0, 256, (2, 33)).astype(np.int32)}
    seen = {}
    for name, tune, trainer in (
        ("jax", jtune, DataParallelTrainer(
            _make_jax_loop(), train_loop_config=loop_config,
            scaling_config=JScalingConfig(num_workers=1),
            run_config=JRunConfig(name="jax_inner", storage_path=str(tmp_path)))),
        ("port", ttune, TorchTrainer(
            _make_port_loop(), train_loop_config=loop_config,
            scaling_config=ScalingConfig(num_workers=1),
            backend_config=TorchConfig(device="cpu"),
            run_config=RunConfig(name="port_inner", storage_path=str(tmp_path)))),
    ):
        results = []

        class Keep(tune.Callback):
            def on_trial_result(self, iteration, trials, trial, result, **info):
                results.append(result)

        run_config = (JRunConfig if name == "jax" else RunConfig)(
            name=name, storage_path=str(tmp_path), callbacks=[Keep()])
        grid = tune.Tuner(trainer, param_space={"train_loop_config": {"lr": tune.grid_search(LRS)}},
                          tune_config=tune.TuneConfig(metric="loss", mode="min"),
                          run_config=run_config).fit()
        assert len(grid) == 2 and not grid.errors
        seen[name] = _losses_by_lr(results)
    # Each trial's gang removed its placement group from the trial actor:
    # the port's runtime holds nothing after fit().
    deadline = time.time() + 10
    while ray_tpu_torch.available_resources().get("CPU") != 4.0 and time.time() < deadline:
        time.sleep(0.1)
    assert ray_tpu_torch.available_resources().get("CPU") == 4.0
    assert sorted(seen["port"]) == sorted(seen["jax"]) == LRS
    for lr in LRS:
        assert len(seen["port"][lr]) == 3
        np.testing.assert_allclose(seen["port"][lr], seen["jax"][lr], rtol=RTOL)
    assert seen["port"][LRS[0]][0] == pytest.approx(seen["port"][LRS[1]][0], rel=1e-7)


# ------------------------------------------------------------------ the GPU seams
def test_seam_a_gpu_becomes_num_gpus_and_tpu_raises():
    from ray_tpu_torch.tune.execution.trial_runner import trial_actor_options

    assert trial_actor_options({"CPU": 2, "GPU": 0.5}) == {"num_cpus": 2, "num_gpus": 0.5}
    assert trial_actor_options({"GPU": 1, "disk": 1}) == {"num_cpus": 1.0, "num_gpus": 1,
                                                          "resources": {"disk": 1}}
    with pytest.raises(ValueError, match="GPU"):
        trial_actor_options({"CPU": 1, "TPU": 1})


def test_seam_b_footprint_counts_every_resource_and_the_gang():
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer
    from ray_tpu_torch.tune.tuner import trial_footprint, trials_that_fit

    trainer = TorchTrainer(lambda c: None, scaling_config=ScalingConfig(
        num_workers=2, use_gpu=True, gpus_per_worker=0.25))
    assert trial_footprint(trainer, {"CPU": 1}) == {"CPU": 3.0, "GPU": 0.5}
    assert trial_footprint(lambda c: None, {"CPU": 0, "GPU": 0.5}) == {"CPU": 1.0, "GPU": 0.5}
    cluster = {"CPU": 8.0, "GPU": 1.0}
    assert trials_that_fit({"CPU": 3.0, "GPU": 0.5}, cluster) == 2
    assert trials_that_fit({"CPU": 1.0}, cluster) == 8
    with pytest.raises(ValueError, match=r"GPU 1.5.*GPU 1.0"):
        trials_that_fit({"CPU": 1.0, "GPU": 1.5}, cluster)
    with pytest.raises(ValueError, match="TPU"):
        trial_footprint(lambda c: None, {"TPU": 4})


def _make_gpu_share_trainable(log_dir):
    def trainable(config):
        import os
        import time

        from ray_tpu_torch.air import session

        t0 = time.time()
        time.sleep(1.0)
        with open(os.path.join(log_dir, f"{config['i']}.json"), "w") as f:
            import json

            json.dump({"t0": t0, "t1": time.time(),
                       "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}, f)
        session.report({"i": config["i"]})

    return trainable


def test_seam_b_gpu_share_trials_run_two_at_a_time(tmp_path):
    # A node with one logical GPU (no CUDA behind it): four trials of 0.5 GPU
    # each finish, at most two at once, each seeing the device id; a larger
    # max_concurrent_trials is held to what fits.
    from ray_tpu_torch.air import RunConfig

    log_dir = tmp_path / "spans"
    log_dir.mkdir()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        grid = ttune.Tuner(
            _make_gpu_share_trainable(str(log_dir)),
            param_space={"i": ttune.grid_search([0, 1, 2, 3])},
            tune_config=ttune.TuneConfig(resources_per_trial={"CPU": 1, "GPU": 0.5},
                                         max_concurrent_trials=4),
            run_config=RunConfig(name="gpu_share", storage_path=str(tmp_path)),
        ).fit()
        assert sorted(r.metrics["i"] for r in grid) == [0, 1, 2, 3] and not grid.errors
        assert ray_tpu_torch.available_resources().get("GPU") == 1.0
        # A footprint over the cluster raises at fit(), before any trial.
        with pytest.raises(ValueError, match=r"GPU 2.0.*GPU 1.0"):
            ttune.Tuner(lambda c: None,
                        tune_config=ttune.TuneConfig(resources_per_trial={"CPU": 1, "GPU": 2}),
                        run_config=RunConfig(name="too_big", storage_path=str(tmp_path))).fit()
        assert not (tmp_path / "too_big").exists()
    finally:
        ray_tpu_torch.shutdown()
    spans = [json.loads(p.read_text()) for p in log_dir.iterdir()]
    assert len(spans) == 4 and {s["visible"] for s in spans} == {"0"}
    edges = sorted([(s["t0"], 1) for s in spans] + [(s["t1"], -1) for s in spans])
    running, most = 0, 0
    for _, d in edges:
        running += d
        most = max(most, running)
    assert most == 2, spans


def test_seam_b_trainer_gang_over_the_cluster_raises(tmp_path):
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        trainer = TorchTrainer(lambda c: None, scaling_config=ScalingConfig(
            num_workers=3, use_gpu=True, gpus_per_worker=0.5))
        with pytest.raises(ValueError, match=r"GPU 1.5.*GPU 1.0"):
            ttune.Tuner(trainer, run_config=RunConfig(name="gang", storage_path=str(tmp_path))
                        ).fit()
    finally:
        ray_tpu_torch.shutdown()


def _make_pbt_trainable():
    def trainable(config):
        import hashlib

        import torch

        from ray_tpu_torch.air import session
        from ray_tpu_torch.air.checkpoint import Checkpoint

        ckpt, restored = session.get_checkpoint(), None
        if ckpt is None:
            w, start = torch.zeros(4), 0
            # Both trials start stepping together (Tune launches their actors
            # one after the other): each waits until the other is up.
            import os
            import time

            from ray_tpu_torch._private.worker import global_worker

            kv = global_worker.context.kv
            kv("put", f"pbt_up/{os.getpid()}".encode(), b"1")
            deadline = time.time() + 60
            while len(kv("keys", b"pbt_up/")) < 2 and time.time() < deadline:
                time.sleep(0.05)
        else:
            saved = ckpt.to_dict()
            w, start = saved["w"], saved["step"]
            restored = {"from": saved["trial_id"], "step": start,
                        "sha": hashlib.sha256(w.numpy().tobytes()).hexdigest()}
        # 5 steps, a checkpoint at steps 2 and 4: a restored trial resumes
        # from step 2 or 4, so it always has a step left to report.
        for i in range(start + 1, 6):
            w = w + config["lr"]
            record = {"score": float(w.sum()), "step": i, "restored": restored,
                      "probe_device": str(config["probe"].device)}
            restored = None
            if i % 2 == 0:
                session.report(record, checkpoint=Checkpoint.from_dict(
                    {"w": w, "step": i, "trial_id": session.get_trial_id()}))
            else:
                session.report(record)

    return trainable


def test_seam_c_pbt_exploit_restores_a_donor_checkpoint_of_tensors(tmp_path):
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch.air import RunConfig
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.tune.schedulers import PopulationBasedTraining

    results = []

    class Keep(ttune.Callback):
        def on_trial_result(self, iteration, trials, trial, result, **info):
            results.append(result)

    tmp = set(glob.glob(os.path.join(tempfile.gettempdir(), "ray_tpu_torch_ckpt_*")))
    ray_tpu_torch.init(num_cpus=4)
    try:
        grid = ttune.Tuner(
            _make_pbt_trainable(),
            param_space={"lr": ttune.grid_search([0.001, 1.0]), "probe": torch.arange(3.0)},
            tune_config=ttune.TuneConfig(
                metric="score", mode="max", max_concurrent_trials=2,
                scheduler=PopulationBasedTraining(perturbation_interval=2,
                                                  hyperparam_mutations={"lr": [0.5, 1.0]})),
            run_config=RunConfig(name="pbt", storage_path=str(tmp_path), callbacks=[Keep()]),
        ).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert not grid.errors and all(r["probe_device"] == "cpu" for r in results)
    restores = [r for r in results if r["restored"]]
    assert restores, "PBT made no exploit"
    paths = {r.metrics["trial_id"]: r.path for r in grid}
    for r in restores:
        got = r["restored"]
        with open(os.path.join(paths[got["from"]], ".tune_checkpoint_metrics.json")) as f:
            name = next(n for n, m in json.load(f).items() if m["step"] == got["step"])
        donor = Checkpoint.from_directory(os.path.join(paths[got["from"]], name)).to_dict()
        assert isinstance(donor["w"], torch.Tensor)
        assert got["sha"] == hashlib.sha256(donor["w"].numpy().tobytes()).hexdigest()
        assert r["config"]["lr"] in (0.5, 1.0)
    # The restored trials read the donor's directory in place: no copy of it
    # was extracted into a temporary directory.
    assert set(glob.glob(os.path.join(tempfile.gettempdir(), "ray_tpu_torch_ckpt_*"))) == tmp
    # The journal and the spec hold the config's tensor as a CPU tensor,
    # written by the host-lowering pickler.
    exp = tmp_path / "pbt"
    for t in json.loads((exp / "experiment_state.json").read_text())["trials"]:
        blob = bytes.fromhex(t["config_pkl"])
        assert b"_tensor_from_numpy" in blob
        assert torch.equal(serialization.loads(blob)["probe"], torch.arange(3.0))
    spec = pickle.loads((exp / "tuner.pkl").read_bytes())
    assert torch.equal(spec["param_space"]["probe"], torch.arange(3.0))


def test_tune_exports_match_the_jax_packages():
    import ast

    def exported(rel):
        with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), rel)) as f:
            for node in ast.parse(f.read()).body:
                if isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
                    return sorted(ast.literal_eval(node.value))

    import ray_tpu_torch.tune.schedulers as ts
    import ray_tpu_torch.tune.search as tsearch
    from ray_tpu_torch.air import session

    assert sorted(ttune.__all__) == exported("ray_tpu/tune/__init__.py")
    assert sorted(ts.__all__) == exported("ray_tpu/tune/schedulers/__init__.py")
    assert sorted(tsearch.__all__) == exported("ray_tpu/tune/search/__init__.py")
    assert ttune.report is session.report and ttune.get_checkpoint is session.get_checkpoint
