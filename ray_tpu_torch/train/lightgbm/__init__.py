"""LightGBMTrainer / LightGBMPredictor.

Reference: `python/ray/train/lightgbm/lightgbm_trainer.py`. Same engine as
XGBoostTrainer (`ray_tpu_torch/train/gbdt/_engine.py`) with lightgbm param names
translated (learning_rate, num_iterations, lambda_l2, min_gain_to_split,
min_sum_hessian_in_leaf, objective regression/binary).
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.train.gbdt_trainer import GBDTTrainer
from ray_tpu_torch.train.xgboost import XGBoostPredictor

_OBJECTIVES = {
    "regression": "reg:squarederror",
    "regression_l2": "reg:squarederror",
    "binary": "binary:logistic",
}


class LightGBMTrainer(GBDTTrainer):
    def _translate_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(params)
        if "objective" in out:
            out["objective"] = _OBJECTIVES.get(out["objective"], out["objective"])
        for src, dst in [
            ("learning_rate", "eta"),
            ("num_iterations", "num_boost_round"),
            ("n_estimators", "num_boost_round"),
            ("lambda_l2", "reg_lambda"),
            ("min_gain_to_split", "gamma"),
            ("min_sum_hessian_in_leaf", "min_child_weight"),
        ]:
            if src in out:
                out[dst] = out.pop(src)
        return out


class LightGBMPredictor(XGBoostPredictor):
    pass


__all__ = ["LightGBMTrainer", "LightGBMPredictor"]
