"""Distributed histogram gradient boosting: the numpy engine.

The distribution strategy is the reference's GBDT path
(upstream `python/ray/train/gbdt_trainer.py:105` driving xgboost-ray's
`hist` tree method): each worker holds a data shard, bins features against
GLOBAL quantile cut points, and per tree LEVEL computes gradient/hessian
histograms that are summed across workers (the allreduce xgboost performs via
rabit); the driver finds splits on the aggregated histograms, so the fitted
model is IDENTICAL to single-node training on the concatenated data.

xgboost/lightgbm are not vendored on the GPU hosts, so the math lives here in
~300 lines of numpy: exact second-order split gain, reg_lambda/gamma/
min_child_weight regularization, level-wise growth.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Tree:
    """One regression tree in flat arrays (leaf: feature == -1)."""

    feature: np.ndarray  # int32 [n_nodes]
    threshold: np.ndarray  # float64 [n_nodes] raw cut value (x <= t -> left)
    left: np.ndarray  # int32 [n_nodes]
    right: np.ndarray  # int32 [n_nodes]
    value: np.ndarray  # float64 [n_nodes] leaf weight

    def predict(self, X: np.ndarray) -> np.ndarray:
        node = np.zeros(len(X), dtype=np.int32)
        # Level-wise vectorized descent: at most n_nodes iterations.
        for _ in range(len(self.feature)):
            internal = self.feature[node] >= 0
            if not internal.any():
                break
            idx = np.nonzero(internal)[0]
            n = node[idx]
            go_left = X[idx, self.feature[n]] <= self.threshold[n]
            node[idx] = np.where(go_left, self.left[n], self.right[n])
        return self.value[node]


@dataclass
class GBDTModel:
    """Boosted ensemble + the metadata needed for standalone prediction."""

    trees: List[Tree] = field(default_factory=list)
    base_score: float = 0.5
    objective: str = "reg:squarederror"
    learning_rate: float = 0.3
    feature_columns: List[str] = field(default_factory=list)
    label_column: str = ""

    def predict_margin(self, X: np.ndarray) -> np.ndarray:
        out = np.full(len(X), self.base_score, dtype=np.float64)
        for t in self.trees:
            out += self.learning_rate * t.predict(X)
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        margin = self.predict_margin(np.asarray(X, dtype=np.float64))
        if self.objective == "binary:logistic":
            return 1.0 / (1.0 + np.exp(-margin))
        return margin


DEFAULT_PARAMS = {
    "objective": "reg:squarederror",
    "eta": 0.3,
    "max_depth": 6,
    "reg_lambda": 1.0,
    "gamma": 0.0,
    "min_child_weight": 1.0,
    "max_bin": 256,
    "base_score": 0.5,
}


def grad_hess(margin: np.ndarray, y: np.ndarray, objective: str):
    if objective == "binary:logistic":
        p = 1.0 / (1.0 + np.exp(-margin))
        return p - y, np.maximum(p * (1.0 - p), 1e-16)
    if objective == "reg:squarederror":
        return margin - y, np.ones_like(margin)
    raise ValueError(f"unsupported objective {objective!r}")


def loss_of(margin: np.ndarray, y: np.ndarray, objective: str) -> Tuple[float, str]:
    if objective == "binary:logistic":
        p = np.clip(1.0 / (1.0 + np.exp(-margin)), 1e-12, 1 - 1e-12)
        return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).sum()), "logloss"
    return float(((margin - y) ** 2).sum()), "rmse"


def make_bin_edges(sample: np.ndarray, max_bin: int) -> List[np.ndarray]:
    """Per-feature global quantile cut points from a row sample (the quantile
    sketch xgboost's `hist` builds; approximate, shared by every worker)."""
    edges = []
    qs = np.linspace(0, 1, max_bin + 1)[1:-1]
    for f in range(sample.shape[1]):
        col = sample[:, f]
        col = col[np.isfinite(col)]
        e = np.unique(np.quantile(col, qs)) if len(col) else np.array([0.0])
        edges.append(e.astype(np.float64))
    return edges


def bin_matrix(X: np.ndarray, edges: List[np.ndarray]) -> np.ndarray:
    out = np.empty(X.shape, dtype=np.uint16)
    for f, e in enumerate(edges):
        # bin b  <=>  x <= e[b] (b == len(e) is the overflow bin): split at
        # bin b sends x <= e[b] left, matching Tree.predict's `x <= t`.
        out[:, f] = np.searchsorted(e, X[:, f], side="left")
    return out


@dataclass
class _Split:
    node: int
    feature: int
    bin: int
    gain: float
    g_left: float
    h_left: float
    g_right: float
    h_right: float


def find_best_splits(
    G: np.ndarray,  # [n_active, F, B] summed over workers
    H: np.ndarray,
    active_nodes: List[int],
    params: Dict,
) -> Dict[int, Optional[_Split]]:
    """Exact best split per active node from aggregated histograms."""
    lam = params["reg_lambda"]
    gamma = params["gamma"]
    mcw = params["min_child_weight"]
    out: Dict[int, Optional[_Split]] = {}
    for k, node in enumerate(active_nodes):
        g_tot = G[k].sum(axis=1)[0] if G[k].size else 0.0  # same for every f
        h_tot = H[k].sum(axis=1)[0] if H[k].size else 0.0
        parent_score = g_tot * g_tot / (h_tot + lam)
        gl = np.cumsum(G[k], axis=1)  # [F, B] left sums at threshold b
        hl = np.cumsum(H[k], axis=1)
        gr = g_tot - gl
        hr = h_tot - hl
        gain = 0.5 * (
            gl * gl / (hl + lam) + gr * gr / (hr + lam) - parent_score
        ) - gamma
        ok = (hl >= mcw) & (hr >= mcw)
        # The last bin's "split" keeps everything left: never valid.
        ok[:, -1] = False
        gain = np.where(ok, gain, -np.inf)
        f, b = np.unravel_index(int(np.argmax(gain)), gain.shape)
        if not np.isfinite(gain[f, b]) or gain[f, b] <= 0:
            out[node] = None
            continue
        out[node] = _Split(
            node=node,
            feature=int(f),
            bin=int(b),
            gain=float(gain[f, b]),
            g_left=float(gl[f, b]),
            h_left=float(hl[f, b]),
            g_right=float(gr[f, b]),
            h_right=float(hr[f, b]),
        )
    return out


def leaf_value(g: float, h: float, lam: float) -> float:
    return -g / (h + lam)


class ShardState:
    """Per-worker training state over one data shard (runs inside an actor;
    pure numpy so it is also unit-testable inline)."""

    def __init__(self, X: np.ndarray, y: np.ndarray, params: Dict,
                 X_valid: Optional[np.ndarray] = None,
                 y_valid: Optional[np.ndarray] = None):
        self.X = np.asarray(X, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        self.params = params
        self.margin = np.full(len(self.y), params["base_score"], dtype=np.float64)
        self.X_valid = None if X_valid is None else np.asarray(X_valid, np.float64)
        self.y_valid = None if y_valid is None else np.asarray(y_valid, np.float64)
        self.valid_margin = (
            None
            if self.X_valid is None
            else np.full(len(self.y_valid), params["base_score"], dtype=np.float64)
        )
        self.binned: Optional[np.ndarray] = None
        self.n_bins = 0
        self.node_of: Optional[np.ndarray] = None
        self.g: Optional[np.ndarray] = None
        self.h: Optional[np.ndarray] = None

    def sample_rows(self, k: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        if len(self.X) <= k:
            return self.X
        return self.X[rng.choice(len(self.X), size=k, replace=False)]

    def set_bins(self, edges: List[np.ndarray]) -> None:
        self.binned = bin_matrix(self.X, edges)
        self.n_bins = max(len(e) for e in edges) + 1

    def new_tree(self) -> None:
        self.node_of = np.zeros(len(self.y), dtype=np.int32)
        self.g, self.h = grad_hess(self.margin, self.y, self.params["objective"])

    def level_hist(self, active_nodes: List[int]):
        """G/H histograms [n_active, F, B] for this shard."""
        nA, F, B = len(active_nodes), self.X.shape[1], self.n_bins
        if len(self.y) == 0:
            return np.zeros((nA, F, B)), np.zeros((nA, F, B))
        slot = {n: k for k, n in enumerate(active_nodes)}
        s = np.array([slot.get(n, -1) for n in range(max(self.node_of.max() + 1, 1))])
        sample_slot = s[self.node_of]
        valid = sample_slot >= 0
        G = np.zeros((nA, F, B))
        H = np.zeros((nA, F, B))
        if valid.any():
            ss = sample_slot[valid]
            gv, hv = self.g[valid], self.h[valid]
            bv = self.binned[valid]
            for f in range(F):
                idx = ss * B + bv[:, f]
                G[:, f, :] = np.bincount(idx, weights=gv, minlength=nA * B).reshape(nA, B)
                H[:, f, :] = np.bincount(idx, weights=hv, minlength=nA * B).reshape(nA, B)
        return G, H

    def apply_splits(self, splits: List[Tuple[int, int, int, int, int]]) -> None:
        """splits: (node, feature, bin, left_id, right_id)."""
        for node, f, b, left_id, right_id in splits:
            mask = self.node_of == node
            go_left = self.binned[mask, f] <= b
            ids = np.where(go_left, left_id, right_id).astype(np.int32)
            self.node_of[mask] = ids

    def finalize_tree(self, tree: Tree, eta: float):
        """Apply the finished tree to train (via node assignment) and valid
        (via raw traversal) margins; return loss components. Without a live
        node assignment (fast-forwarding a resumed ensemble) the train side
        traverses raw features too."""
        if self.node_of is not None:
            self.margin += eta * tree.value[self.node_of]
        else:
            self.margin += eta * tree.predict(self.X)
        train_loss, metric = loss_of(self.margin, self.y, self.params["objective"])
        out = {"train_loss_sum": train_loss, "train_n": len(self.y), "metric": metric}
        if self.valid_margin is not None:
            self.valid_margin += eta * tree.predict(self.X_valid)
            vloss, _ = loss_of(self.valid_margin, self.y_valid, self.params["objective"])
            out["valid_loss_sum"] = vloss
            out["valid_n"] = len(self.y_valid)
        return out
