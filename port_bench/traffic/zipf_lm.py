"""Token batches for causal-LM pretraining: ids drawn Zipf(s) over the
vocabulary, ranks permuted by the seed, as word frequencies in text are.

Each row is drawn from its own stream, keyed by (seed, step, row), so a
row's tokens do not depend on how many ranks share the global batch, and a
run of any length sees the same batch at the same step.
"""

from __future__ import annotations

import numpy as np

_PERMUTATION_KEY = 0x7A1F


def _stream(*key):
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([k % 2**64 for k in key])))


class ZipfTokens:
    def __init__(self, traffic, model, seed):
        self.seq = int(traffic["seq"])
        self.seed = int(seed)
        vocab = int(model.get("token_ids_below") or model["vocab_size"])
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        weights = ranks ** -float(traffic["zipf_exponent"])
        cdf = np.cumsum(weights)
        self.cdf = cdf / cdf[-1]
        self.ids = _stream(self.seed, _PERMUTATION_KEY).permutation(vocab).astype(np.int32)

    def rows(self, step, start, stop):
        """Rows ``start`` to ``stop`` of the global batch of ``step``: int32
        token ids (stop - start, seq + 1)."""
        out = np.empty((stop - start, self.seq + 1), dtype=np.int32)
        for i, row in enumerate(range(start, stop)):
            u = _stream(self.seed, step, row).random(self.seq + 1)
            rank = np.searchsorted(self.cdf, u, side="right")
            out[i] = self.ids[np.minimum(rank, len(self.ids) - 1)]
        return out


def make(traffic, model, seed):
    return ZipfTokens(traffic, model, seed)
