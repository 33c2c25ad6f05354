"""XGBoostTrainer / XGBoostPredictor.

Reference: `python/ray/train/xgboost/xgboost_trainer.py` (+
`xgboost_predictor.py`): distributed `hist` boosting over Dataset shards and
checkpoint-based batch prediction. The tree engine is the in-repo numpy
histogram implementation (`ray_tpu_torch/train/gbdt/_engine.py`) with xgboost's
param names and split math — xgboost itself is not vendored on the GPU hosts;
the distribution strategy (global quantile sketch + per-level histogram
allreduce) is identical, so params and results transfer.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.train.gbdt._engine import GBDTModel
from ray_tpu_torch.train.gbdt_trainer import MODEL_KEY, GBDTTrainer


class XGBoostTrainer(GBDTTrainer):
    """`params` uses xgboost names: objective ("reg:squarederror" |
    "binary:logistic"), eta/learning_rate, max_depth, reg_lambda, gamma,
    min_child_weight, max_bin, base_score, num_boost_round."""


class XGBoostPredictor:
    """Batch predictor over a fitted checkpoint (reference:
    `xgboost_predictor.py`): usable directly or as a class UDF in
    `Dataset.map_batches(XGBoostPredictor, fn_constructor_args=(ckpt,),
    compute="actors")` for distributed batch inference."""

    # numpy on the host: a BatchPredictor pool of it holds no GPU.
    uses_gpu = False

    def __init__(self, checkpoint: Checkpoint):
        model = checkpoint.to_dict().get(MODEL_KEY)
        if not isinstance(model, GBDTModel):
            raise ValueError("checkpoint does not contain a GBDT model")
        self.model = model

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint) -> "XGBoostPredictor":
        return cls(checkpoint)

    def predict(self, batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
        X = np.stack(
            [np.asarray(batch[c]) for c in self.model.feature_columns], axis=1
        )
        return {"predictions": self.model.predict(X)}

    # map_batches class-UDF protocol.
    def __call__(self, batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
        return self.predict(batch)


__all__ = ["XGBoostTrainer", "XGBoostPredictor"]
