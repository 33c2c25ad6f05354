"""Distributed histogram-GBDT engine (see `_engine.py`)."""

from ray_tpu_torch.train.gbdt._engine import GBDTModel, Tree

__all__ = ["GBDTModel", "Tree"]
