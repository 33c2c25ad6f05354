"""TPESearcher: tree-structured Parzen estimator search, dependency-free.

The native model-based searcher of this build — the role Optuna/HyperOpt
wrappers play in the reference (`python/ray/tune/search/optuna/`,
`search/hyperopt/`; both default to TPE). Algorithm (Bergstra et al. 2011):
split observed trials at the gamma-quantile of the objective into good/bad
sets, model each set's density per dimension with a Parzen (Gaussian-kernel)
estimator, draw candidates from the good model l(x), and pick the candidate
maximizing l(x)/g(x).

Independent per-dimension models (like HyperOpt); Float/Integer dims use KDE
in (log-)value space, Categorical dims use smoothed category frequencies.
Function/Normal dims fall back to fresh random draws (no bounded support to
model)."""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.tune.search.basic_variant import _find_axes, _set_path
from ray_tpu_torch.tune.search.sample import Categorical, Domain, Float, Integer
from ray_tpu_torch.tune.search.searcher import Searcher


def _get_path(cfg: Dict, path: Tuple) -> Any:
    node = cfg
    for k in path:
        node = node[k]
    return node


class _NumericDim:
    """Parzen model over a bounded (possibly log, possibly quantized) dim."""

    def __init__(self, domain):
        self.domain = domain
        self.log = bool(domain.log)
        self.lo = math.log(domain.lower) if self.log else float(domain.lower)
        self.hi = math.log(domain.upper) if self.log else float(domain.upper)

    def to_unit(self, v: float) -> float:
        x = math.log(v) if self.log else float(v)
        return (x - self.lo) / max(self.hi - self.lo, 1e-12)

    def from_unit(self, u: float, rng: random.Random) -> Any:
        u = min(max(u, 0.0), 1.0)
        x = self.lo + u * (self.hi - self.lo)
        v = math.exp(x) if self.log else x
        d = self.domain
        if isinstance(d, Integer):
            v = int(round(v))
            if d.q:
                v = int(round(v / d.q) * d.q)
            return max(d.lower, min(v, d.upper - 1))
        if d.q:
            v = round(v / d.q) * d.q
        return min(max(v, d.lower), d.upper)

    @staticmethod
    def kde_sample(points: List[float], rng: random.Random) -> float:
        """Draw from the Parzen mixture over unit-scaled observations."""
        if not points:
            return rng.random()
        bw = max(1.0 / (1 + len(points)) ** 0.8, 1e-3)
        c = points[rng.randrange(len(points))]
        return rng.gauss(c, bw)

    @staticmethod
    def kde_logpdf(x: float, points: List[float]) -> float:
        """Log-density of the Parzen mixture (uniform prior when empty)."""
        if not points:
            return 0.0
        bw = max(1.0 / (1 + len(points)) ** 0.8, 1e-3)
        arr = np.asarray(points)
        z = (x - arr) / bw
        log_k = -0.5 * z * z - math.log(bw * math.sqrt(2 * math.pi))
        m = float(np.max(log_k))
        return m + math.log(float(np.exp(log_k - m).sum()) / len(points))


class TPESearcher(Searcher):
    def __init__(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        n_initial_points: int = 10,
        gamma: float = 0.25,
        n_candidates: int = 24,
    ):
        super().__init__(metric, mode)
        self.n_initial = n_initial_points
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._observations: List[Tuple[Dict[str, Any], float]] = []
        self._configs: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------------ seam
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._space is None:
            raise RuntimeError("set_search_properties was not called")
        if len(self._observations) < self.n_initial:
            cfg = self._random_config()
        else:
            cfg = self._tpe_config()
        self._configs[trial_id] = cfg
        return cfg

    def on_trial_complete(
        self, trial_id: str, result: Optional[Dict[str, Any]] = None,
        error: bool = False,
    ) -> None:
        cfg = self._configs.pop(trial_id, None)
        if cfg is None or error or not result:
            return
        obj = self._objective(result)
        if obj is not None and math.isfinite(obj):
            self._observations.append((cfg, obj))

    # ------------------------------------------------------------------- TPE
    def _tpe_config(self) -> Dict[str, Any]:
        _, samples = _find_axes(self._space)
        obs = sorted(self._observations, key=lambda o: o[1])
        n_good = max(1, int(math.ceil(self.gamma * len(obs))))
        good, bad = obs[:n_good], obs[n_good:]
        cfg = self._random_config()  # Function/Normal dims keep random draws
        for path, domain in samples:
            choice = self._suggest_dim(path, domain, good, bad)
            if choice is not None:
                _set_path(cfg, path, choice)
        return cfg

    def _suggest_dim(self, path, domain: Domain, good, bad):
        rng = self._rng
        if isinstance(domain, (Float, Integer)):
            dim = _NumericDim(domain)
            g_pts = [dim.to_unit(_get_path(c, path)) for c, _ in good]
            b_pts = [dim.to_unit(_get_path(c, path)) for c, _ in bad]
            best, best_score = None, -math.inf
            for _ in range(self.n_candidates):
                u = dim.kde_sample(g_pts, rng)
                score = dim.kde_logpdf(u, g_pts) - dim.kde_logpdf(u, b_pts)
                if score > best_score:
                    best, best_score = u, score
            return dim.from_unit(best, rng)
        if isinstance(domain, Categorical):
            cats = domain.categories

            def counts(obs_set):
                c = np.ones(len(cats))  # +1 smoothing
                for cfg, _ in obs_set:
                    v = _get_path(cfg, path)
                    try:
                        c[cats.index(v)] += 1
                    except ValueError:
                        pass
                return c / c.sum()

            pg, pb = counts(good), counts(bad)
            scores = np.log(pg) - np.log(pb)
            # Sample from the good distribution, keep the best-scoring of a few.
            cand = np.random.default_rng(rng.randrange(2**31)).choice(
                len(cats), size=min(self.n_candidates, 8), p=pg
            )
            best = max(cand, key=lambda i: scores[i])
            return cats[int(best)]
        return None  # unmodeled Domain kinds keep their random draw
