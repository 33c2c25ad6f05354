"""GBDTTrainer: distributed gradient-boosted trees over Dataset shards.

Reference: `python/ray/train/gbdt_trainer.py:105` (the base under
XGBoostTrainer/LightGBMTrainer, which drives xgboost-ray actors with rabit
allreduce on `hist` histograms). Redesigned for this runtime: an actor gang
holds Dataset shards, each boosting round grows one tree LEVEL-WISE with
per-level histogram aggregation across the gang (`_engine.py` — the same
distribution strategy, so the fitted model equals single-node training on the
concatenated data), and the fitted model lands in an AIR Checkpoint.
"""

from __future__ import annotations

import numpy as np
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.base_trainer import BaseTrainer
from ray_tpu_torch.train.gbdt._engine import (
    DEFAULT_PARAMS,
    GBDTModel,
    ShardState,
    Tree,
    find_best_splits,
    leaf_value,
    make_bin_edges,
)

MODEL_KEY = "model"  # checkpoint dict key (reference: gbdt_trainer MODEL_KEY)


def _combine_hists(a, b):
    """One pairwise combine of (G, H) histogram pairs — runs as a task on a
    worker, never on the driver."""
    return a[0] + b[0], a[1] + b[1]


# One RemoteFunction for the whole training run (the wrapper pickles the
# function once; rebuilding it per tree level would re-wrap ~levels*rounds
# times on the driver's hot loop).
_combine_remote = None


def _tree_reduce_hists(refs: List[Any]):
    """Sum per-worker (G, H) histograms with a pairwise combine TREE
    (xgboost's rabit allreduce shape): partial histograms flow worker->worker
    through O(log n) combine rounds and the driver materializes exactly ONE
    final pair — not O(workers) histograms funneled through the control
    plane."""
    global _combine_remote
    if _combine_remote is None:
        _combine_remote = ray_tpu_torch.remote(_combine_hists)
    combine = _combine_remote
    while len(refs) > 1:
        nxt = []
        for i in range(0, len(refs) - 1, 2):
            nxt.append(combine.remote(refs[i], refs[i + 1]))
        if len(refs) % 2:
            nxt.append(refs[-1])
        refs = nxt
    return ray_tpu_torch.get(refs[0])


class _GBDTShardWorker:
    """Actor holding one train (and optional valid) shard."""

    def __init__(self, block_refs, label_column, feature_columns, params,
                 valid_block_refs=None):
        def to_xy(refs):
            # Refs, not bytes, cross the control plane: blocks read zero-copy
            # from the shared store inside this actor (the driver never
            # materializes shard data).
            cols: Dict[str, List[np.ndarray]] = {}
            for r in refs:
                for k, v in ray_tpu_torch.get(r).items():
                    cols.setdefault(k, []).append(np.asarray(v))
            merged = {k: np.concatenate(v) for k, v in cols.items()}
            y = merged[label_column]
            X = np.stack([merged[c] for c in feature_columns], axis=1)
            return X, y

        X, y = to_xy(block_refs)
        Xv = yv = None
        if valid_block_refs is not None:
            Xv, yv = to_xy(valid_block_refs)
        self.state = ShardState(X, y, params, Xv, yv)

    def sample_rows(self, k, seed):
        return self.state.sample_rows(k, seed)

    def set_bins(self, edges):
        self.state.set_bins(edges)
        return True

    def new_tree(self):
        self.state.new_tree()
        return True

    def level_hist(self, active_nodes):
        return self.state.level_hist(active_nodes)

    def apply_splits(self, splits):
        self.state.apply_splits(splits)
        return True

    def finalize_tree(self, tree, eta):
        return self.state.finalize_tree(tree, eta)


class GBDTTrainer(BaseTrainer):
    """Distributed GBDT with an xgboost-style param dict.

    Args mirror the reference trainer: `datasets={"train": ds, "valid": ds}`,
    `label_column`, `params` (objective/eta/max_depth/reg_lambda/gamma/
    min_child_weight/max_bin/base_score), `num_boost_round`.
    """

    def __init__(
        self,
        *,
        datasets: Dict[str, Any],
        label_column: str,
        params: Optional[Dict[str, Any]] = None,
        num_boost_round: int = 10,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ):
        from ray_tpu_torch._private import usage

        usage.record_library_usage("train")
        super().__init__(
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint,
            metadata=metadata,
        )
        if "train" not in datasets:
            raise ValueError('datasets must include a "train" Dataset')
        self.label_column = label_column
        self.params = dict(DEFAULT_PARAMS)
        self.params.update(self._translate_params(dict(params or {})))
        self.num_boost_round = int(
            self.params.pop("num_boost_round", num_boost_round)
        )

    # Subclasses (LightGBMTrainer) map their native param names here.
    def _translate_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        if "learning_rate" in params:
            params["eta"] = params.pop("learning_rate")
        return params

    # ----------------------------------------------------------------- fit
    def _fit_impl(self, trial_info=None) -> Result:
        try:
            return self._train()
        except Exception as e:  # noqa: BLE001 — surfaced via Result
            return Result(metrics=None, checkpoint=None, error=e)

    def _train(self) -> Result:
        ray_tpu_torch._private.worker._auto_init()
        n = max(1, self.scaling_config.num_workers or 1)
        train_ds = self.datasets["train"]
        valid_ds = self.datasets.get("valid")

        feature_columns = [
            c for c in (train_ds.columns() or []) if c != self.label_column
        ]
        if not feature_columns:
            raise ValueError("train dataset has no feature columns")

        # equal=True repartitions first: a single-block dataset still gives
        # every worker a non-empty shard.
        train_shards = train_ds.split(n, equal=True)
        valid_shards = (
            valid_ds.split(n, equal=True) if valid_ds is not None else [None] * n
        )
        worker_cls = ray_tpu_torch.remote(_GBDTShardWorker)
        workers = []
        for i in range(n):
            refs = train_shards[i]._execute()
            vrefs = (
                None if valid_shards[i] is None else valid_shards[i]._execute()
            )
            workers.append(
                worker_cls.remote(
                    refs, self.label_column, feature_columns, self.params, vrefs
                )
            )

        try:
            return self._boost(workers, feature_columns)
        finally:
            # Failure paths must not leak the gang (each actor pins a shard).
            for w in workers:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:
                    pass

    def _boost(self, workers, feature_columns) -> Result:
        n = len(workers)
        model = GBDTModel(
            base_score=self.params["base_score"],
            objective=self.params["objective"],
            learning_rate=self.params["eta"],
            feature_columns=feature_columns,
            label_column=self.label_column,
        )
        if self.resume_from_checkpoint is not None:
            prev = self.resume_from_checkpoint.to_dict().get(MODEL_KEY)
            if prev is not None:
                # COPY the ensemble: appending to the checkpointed model in
                # place would silently grow the source checkpoint too.
                model = GBDTModel(
                    trees=list(prev.trees),
                    base_score=prev.base_score,
                    objective=prev.objective,
                    learning_rate=prev.learning_rate,
                    feature_columns=list(prev.feature_columns),
                    label_column=prev.label_column,
                )

        # Global quantile bins from a cross-shard sample.
        samples = ray_tpu_torch.get(
            [w.sample_rows.remote(20_000 // n + 1, seed=17 + i)
             for i, w in enumerate(workers)]
        )
        edges = make_bin_edges(np.concatenate(samples, axis=0), self.params["max_bin"])
        ray_tpu_torch.get([w.set_bins.remote(edges) for w in workers])
        if model.trees:
            # Resumed ensemble: fast-forward worker margins through it.
            for t in model.trees:
                ray_tpu_torch.get([w.finalize_tree.remote(t, model.learning_rate) for w in workers])

        lam = self.params["reg_lambda"]
        eta = self.params["eta"]
        history: List[Dict[str, float]] = []
        for _round in range(self.num_boost_round):
            ray_tpu_torch.get([w.new_tree.remote() for w in workers])
            tree = self._grow_tree(workers, edges, lam)
            model.trees.append(tree)
            parts = ray_tpu_torch.get([w.finalize_tree.remote(tree, eta) for w in workers])
            metric = parts[0]["metric"]
            tr_sum = sum(p["train_loss_sum"] for p in parts)
            tr_n = sum(p["train_n"] for p in parts)
            row = {
                "training_iteration": _round + 1,
                f"train-{metric}": (
                    float(np.sqrt(tr_sum / tr_n)) if metric == "rmse" else tr_sum / tr_n
                ),
            }
            if "valid_loss_sum" in parts[0]:
                v_sum = sum(p["valid_loss_sum"] for p in parts)
                v_n = sum(p["valid_n"] for p in parts)
                row[f"valid-{metric}"] = (
                    float(np.sqrt(v_sum / v_n)) if metric == "rmse" else v_sum / v_n
                )
            history.append(row)

        ckpt = Checkpoint.from_dict({MODEL_KEY: model})
        metrics = dict(history[-1]) if history else {}
        metrics["num_trees"] = len(model.trees)
        return Result(metrics=metrics, checkpoint=ckpt)

    def _grow_tree(self, workers, edges, lam) -> Tree:
        """One boosting round: level-wise growth with cross-worker histogram
        aggregation (the rabit-allreduce step of distributed xgboost)."""
        feature = [-1]
        threshold = [0.0]
        left = [-1]
        right = [-1]
        value = [0.0]
        active = [0]
        for _depth in range(self.params["max_depth"]):
            if not active:
                break
            G, H = _tree_reduce_hists(
                [w.level_hist.remote(active) for w in workers]
            )
            # Root/leaf values: refresh from aggregated totals (covers nodes
            # that end up unsplit at this level).
            for k, node in enumerate(active):
                g_tot = float(G[k, 0, :].sum())
                h_tot = float(H[k, 0, :].sum())
                value[node] = leaf_value(g_tot, h_tot, lam)
            splits = find_best_splits(G, H, active, self.params)
            apply_list = []
            next_active = []
            for node in active:
                sp = splits[node]
                if sp is None:
                    continue
                lid, rid = len(feature), len(feature) + 1
                for _ in range(2):
                    feature.append(-1)
                    threshold.append(0.0)
                    left.append(-1)
                    right.append(-1)
                    value.append(0.0)
                feature[node] = sp.feature
                threshold[node] = float(edges[sp.feature][sp.bin])
                left[node], right[node] = lid, rid
                value[lid] = leaf_value(sp.g_left, sp.h_left, lam)
                value[rid] = leaf_value(sp.g_right, sp.h_right, lam)
                apply_list.append((node, sp.feature, sp.bin, lid, rid))
                next_active += [lid, rid]
            if not apply_list:
                break
            ray_tpu_torch.get([w.apply_splits.remote(apply_list) for w in workers])
            active = next_active
        return Tree(
            feature=np.asarray(feature, dtype=np.int32),
            threshold=np.asarray(threshold, dtype=np.float64),
            left=np.asarray(left, dtype=np.int32),
            right=np.asarray(right, dtype=np.int32),
            value=np.asarray(value, dtype=np.float64),
        )
