"""GBDT (``ray_tpu_torch/train/{gbdt_trainer,gbdt,xgboost,lightgbm}``) against
the JAX package's.

The port's GBDT is the JAX package's numpy engine on the port's runtime: the
shard workers are actors that hold no GPU, the histograms are summed by a
pairwise tree of tasks, the Datasets are the port's Data. So on the same
numpy data (made from a seed), params and worker counts, both packages must
grow the same trees: split features and thresholds exactly, leaf values and
predictions within 1e-6. Both runtimes run in this process, side by side.
"""

import os

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu.air.config import ScalingConfig as JScalingConfig
from ray_tpu.train.lightgbm import LightGBMTrainer as JLightGBMTrainer
from ray_tpu.train.xgboost import XGBoostTrainer as JXGBoostTrainer
from ray_tpu_torch import data as tdata
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.train import BatchPredictor
from ray_tpu_torch.train.gbdt_trainer import MODEL_KEY
from ray_tpu_torch.train.lightgbm import LightGBMTrainer
from ray_tpu_torch.train.xgboost import XGBoostPredictor, XGBoostTrainer

ATOL = 1e-6


@pytest.fixture(scope="module")
def runtimes():
    # The port's node has one logical GPU (no CUDA behind it), so a pool that
    # took a GPU share would show it.
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _columns(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "regression":
        x0, x1, x2 = rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.normal(size=n)
        y = np.sin(x0) + 0.5 * x1 * x1 + 0.1 * x2 + 0.1 * rng.normal(size=n)
    else:
        x0, x1, x2 = rng.normal(size=n), rng.normal(size=n), rng.uniform(-1, 1, n)
        y = (x0 + x1 - 0.5 * x2 > 0).astype(np.float64)
    return {"x0": x0, "x1": x1, "x2": x2, "y": y}


def _fit(trainer_cls, data, scaling_cls, cols, workers, params, rounds=None, resume=None,
         valid=None):
    kwargs = {"num_boost_round": rounds} if rounds is not None else {}
    datasets = {"train": data.from_numpy(cols)}
    if valid is not None:
        datasets["valid"] = data.from_numpy(valid)
    result = trainer_cls(datasets=datasets, label_column="y", params=dict(params),
                         scaling_config=scaling_cls(num_workers=workers),
                         resume_from_checkpoint=resume, **kwargs).fit()
    assert result.error is None, result.error
    return result


def _assert_same_trees(ours, ref, X):
    assert len(ours.trees) == len(ref.trees) > 0
    assert (ours.base_score, ours.objective, ours.learning_rate) == (
        ref.base_score, ref.objective, ref.learning_rate)
    assert ours.feature_columns == ref.feature_columns and ours.label_column == ref.label_column
    for a, b in zip(ours.trees, ref.trees):
        np.testing.assert_array_equal(a.feature, b.feature)
        np.testing.assert_array_equal(a.threshold, b.threshold)
        np.testing.assert_array_equal(a.left, b.left)
        np.testing.assert_array_equal(a.right, b.right)
        np.testing.assert_allclose(a.value, b.value, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours.predict(X), ref.predict(X), rtol=0, atol=ATOL)


CASES = {
    "xgboost_regression": (XGBoostTrainer, JXGBoostTrainer, "regression",
                           {"objective": "reg:squarederror", "eta": 0.3, "max_depth": 4}, 8),
    "xgboost_classification": (XGBoostTrainer, JXGBoostTrainer, "classification",
                               {"objective": "binary:logistic", "eta": 0.4, "max_depth": 3,
                                "reg_lambda": 2.0, "gamma": 0.1}, 6),
    "lightgbm_classification": (LightGBMTrainer, JLightGBMTrainer, "classification",
                                {"objective": "binary", "learning_rate": 0.4,
                                 "num_iterations": 6, "lambda_l2": 1.0,
                                 "min_sum_hessian_in_leaf": 0.5}, None),
}


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_same_trees_as_jax(runtimes, case, workers):
    ours_cls, ref_cls, kind, params, rounds = CASES[case]
    cols, valid = _columns(kind, 900, seed=0), _columns(kind, 300, seed=1)
    ours = _fit(ours_cls, tdata, ScalingConfig, cols, workers, params, rounds, valid=valid)
    ref = _fit(ref_cls, jdata, JScalingConfig, cols, workers, params, rounds, valid=valid)
    X = np.stack([_columns(kind, 400, seed=2)[c] for c in ("x0", "x1", "x2")], axis=1)
    _assert_same_trees(ours.checkpoint.to_dict()[MODEL_KEY], ref.checkpoint.to_dict()["model"], X)
    assert set(ours.metrics) == set(ref.metrics)
    for k, v in ref.metrics.items():
        assert ours.metrics[k] == pytest.approx(v, rel=0, abs=ATOL), k


def test_resume_continues_boosting_as_jax_and_as_one_run(runtimes):
    params = {"max_depth": 4}
    cols = _columns("regression", 800, seed=4)
    X = np.stack([_columns("regression", 300, seed=5)[c] for c in ("x0", "x1", "x2")], axis=1)
    first = _fit(XGBoostTrainer, tdata, ScalingConfig, cols, 2, params, 5)
    j_first = _fit(JXGBoostTrainer, jdata, JScalingConfig, cols, 2, params, 5)
    resumed = _fit(XGBoostTrainer, tdata, ScalingConfig, cols, 2, params, 5,
                   resume=first.checkpoint)
    j_resumed = _fit(JXGBoostTrainer, jdata, JScalingConfig, cols, 2, params, 5,
                     resume=j_first.checkpoint)
    model = resumed.checkpoint.to_dict()[MODEL_KEY]
    assert resumed.metrics["num_trees"] == 10
    _assert_same_trees(model, j_resumed.checkpoint.to_dict()["model"], X)
    assert resumed.metrics["train-rmse"] == pytest.approx(j_resumed.metrics["train-rmse"],
                                                          rel=0, abs=ATOL)
    # The source checkpoint is not grown in place, and five more rounds after
    # a resume are the rounds 6-10 of one run of ten.
    assert len(first.checkpoint.to_dict()[MODEL_KEY].trees) == 5
    straight = _fit(XGBoostTrainer, tdata, ScalingConfig, cols, 2, params, 10)
    _assert_same_trees(model, straight.checkpoint.to_dict()[MODEL_KEY], X)


def test_batch_predictor_pool_of_xgboost_predictors_holds_no_gpu(runtimes):
    # XGBoostPredictor is numpy on the host: with num_gpus_per_worker=None
    # its pool holds no GPU (the node's one logical GPU stays free) and its
    # actors see no device, where a TorchPredictor pool shares one GPU.
    cols = _columns("classification", 400, seed=6)
    result = _fit(XGBoostTrainer, tdata, ScalingConfig, cols, 2,
                  {"objective": "binary:logistic", "max_depth": 3}, 4)

    class Where(XGBoostPredictor):
        def predict(self, batch):
            out = super().predict(batch)
            n = len(out["predictions"])
            out["visible"] = np.array([os.environ.get("CUDA_VISIBLE_DEVICES")] * n)
            out["gpu_free"] = np.full(n, ray_tpu_torch.available_resources().get("GPU", 0.0))
            return out

    assert XGBoostPredictor.uses_gpu is False
    bp = BatchPredictor.from_checkpoint(result.checkpoint, Where)
    rows = bp.predict(tdata.from_numpy(cols), feature_columns=["x0", "x1", "x2"],
                      keep_columns=["y"], batch_size=100, num_workers=2).take_all()
    assert len(rows) == 400
    assert {str(r["visible"]) for r in rows} == {""}
    assert {float(r["gpu_free"]) for r in rows} == {1.0}
    model = result.checkpoint.to_dict()[MODEL_KEY]
    X = np.stack([cols[c] for c in ("x0", "x1", "x2")], axis=1)
    got = np.sort(np.array([float(r["predictions"]) for r in rows]))
    np.testing.assert_array_equal(got, np.sort(model.predict(X)))
