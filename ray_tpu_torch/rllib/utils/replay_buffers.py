"""Replay buffers: uniform ring + proportional prioritized (sum-tree).

Reference: `rllib/utils/replay_buffers/replay_buffer.py` (uniform) and
`prioritized_replay_buffer.py` + `rllib/execution/segment_tree.py`
(proportional prioritization, Schaul et al. 2016). The reference's segment
tree is a Python object updated element-by-element; here the sum-tree is one
flat numpy array and sampling/updating are vectorized over the whole batch —
a level-by-level descent of shape (batch,) index arrays, O(log n) vector ops
per batch instead of O(batch * log n) Python iterations.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform ring buffer over flat numpy transition columns."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._store: Dict[str, np.ndarray] = {}
        self._next = 0
        self.size = 0

    def _added_indices(self, n: int) -> np.ndarray:
        idx = (self._next + np.arange(n)) % self.capacity
        self._next = (self._next + n) % self.capacity
        self.size = min(self.size + n, self.capacity)
        return idx

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        if not self._store:
            for k, v in batch.items():
                self._store[k] = np.zeros((self.capacity,) + v.shape[1:], v.dtype)
        idx = self._added_indices(n)
        for k, v in batch.items():
            self._store[k][idx] = v

    def sample(self, batch_size: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, batch_size)
        return {k: v[idx] for k, v in self._store.items()}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay: P(i) ~ p_i^alpha, IS weights
    w_i = (N * P(i))^-beta / max_j w_j ride the sampled batch as
    `loss_weight` (the TD losses already multiply by that column) together
    with `batch_indexes` for `update_priorities`."""

    def __init__(self, capacity: int, alpha: float = 0.6):
        super().__init__(capacity)
        if alpha <= 0:
            raise ValueError("alpha must be > 0")
        self.alpha = float(alpha)
        # Leaf i of the sum-tree lives at _tree[_cap2 + i]; internal node k
        # holds the sum of its two children, root at _tree[1].
        self._cap2 = 1 << (capacity - 1).bit_length()
        self._depth = self._cap2.bit_length() - 1
        self._tree = np.zeros(2 * self._cap2, np.float64)
        self._max_priority = 1.0

    # ------------------------------------------------------------- tree ops
    def _set_priorities(self, idx: np.ndarray, prio: np.ndarray) -> None:
        """Vectorized leaf assign + path re-sum. Duplicate idx entries keep
        the LAST value (np fancy-assign semantics), then each affected path
        is recomputed bottom-up from child sums, so duplicates stay exact."""
        leaf = self._cap2 + idx
        self._tree[leaf] = prio
        parents = leaf // 2
        for _ in range(self._depth):
            parents = np.unique(parents)
            self._tree[parents] = self._tree[2 * parents] + self._tree[2 * parents + 1]
            parents //= 2

    def _sample_leaves(self, u: np.ndarray) -> np.ndarray:
        """Descend the tree with a batch of prefix-sum targets at once."""
        idx = np.ones(len(u), np.int64)
        u = u.astype(np.float64).copy()
        for _ in range(self._depth):
            left = 2 * idx
            lsum = self._tree[left]
            go_right = u >= lsum
            u -= np.where(go_right, lsum, 0.0)
            idx = left + go_right
        return idx - self._cap2

    # ------------------------------------------------------------ buffer API
    def add(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        if not self._store:
            for k, v in batch.items():
                self._store[k] = np.zeros((self.capacity,) + v.shape[1:], v.dtype)
        idx = self._added_indices(n)
        for k, v in batch.items():
            self._store[k][idx] = v
        # New transitions get max priority so everything is seen at least
        # once before TD errors take over (reference: `add` -> max_priority).
        self._set_priorities(
            idx, np.full(n, self._max_priority**self.alpha, np.float64)
        )

    def sample(self, batch_size: int, rng: np.random.Generator,
               beta: float = 0.4) -> Dict[str, np.ndarray]:
        total = self._tree[1]
        if total <= 0 or self.size == 0:
            raise ValueError("cannot sample from an empty buffer")
        # Stratified draw: one uniform per equal-mass segment keeps sample
        # diversity high at small batch sizes.
        seg = total / batch_size
        u = (np.arange(batch_size) + rng.random(batch_size)) * seg
        idx = np.clip(self._sample_leaves(u), 0, self.size - 1)
        out = {k: v[idx] for k, v in self._store.items()}
        p = self._tree[self._cap2 + idx] / total
        weights = (self.size * np.maximum(p, 1e-12)) ** (-beta)
        weights = weights / weights.max()
        base = out.get("loss_weight")
        w = weights.astype(np.float32)
        out["loss_weight"] = w if base is None else base * w
        out["batch_indexes"] = idx
        return out

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray) -> None:
        priorities = np.asarray(priorities, np.float64)
        if np.any(priorities < 0):
            raise ValueError("priorities must be >= 0")
        eps = 1e-6
        self._max_priority = max(self._max_priority, float(priorities.max(initial=0.0)))
        self._set_priorities(np.asarray(idx, np.int64), (priorities + eps) ** self.alpha)

    def stats(self) -> Dict[str, float]:
        return {
            "size": float(self.size),
            "max_priority": self._max_priority,
            "priority_total": float(self._tree[1]),
        }
