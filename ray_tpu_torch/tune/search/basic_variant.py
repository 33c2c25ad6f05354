"""Variant generation: param_space -> concrete trial configs.

Reference: `python/ray/tune/search/basic_variant.py` (`BasicVariantGenerator`)
+ `variant_generator.py`: grid axes expand exhaustively (cartesian product,
recursing into nested dicts); Domain leaves are sampled per variant;
`num_samples` repeats the whole expansion with fresh samples.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Tuple

from ray_tpu_torch.tune.search.sample import Domain, Function


def _find_axes(space: Any, path: Tuple = ()) -> Tuple[List, List]:
    """Walk the space: returns (grid_axes, sample_points) as (path, payload)."""
    grids, samples = [], []
    if isinstance(space, dict):
        if set(space.keys()) == {"grid_search"}:
            grids.append((path, space["grid_search"]))
            return grids, samples
        for k, v in space.items():
            g, s = _find_axes(v, path + (k,))
            grids.extend(g)
            samples.extend(s)
    elif isinstance(space, Domain):
        samples.append((path, space))
    return grids, samples


def _set_path(cfg: Dict, path: Tuple, value: Any) -> None:
    node = cfg
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _materialize(space: Any) -> Dict:
    """Deep-copy the space with grid/Domain placeholders left as None."""
    if isinstance(space, dict):
        if set(space.keys()) == {"grid_search"}:
            return None  # type: ignore[return-value]
        return {k: _materialize(v) for k, v in space.items()}
    if isinstance(space, Domain):
        return None  # type: ignore[return-value]
    return space


class BasicVariantGenerator:
    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)

    def generate(self, space: Dict[str, Any], num_samples: int = 1) -> Iterator[Dict]:
        grids, samples = _find_axes(space)
        grid_values = [vals for _, vals in grids]
        for _ in range(max(num_samples, 1)):
            for combo in itertools.product(*grid_values) if grids else [()]:
                cfg = _materialize(space) or {}
                for (path, _), value in zip(grids, combo):
                    _set_path(cfg, path, value)
                for path, domain in samples:
                    if isinstance(domain, Function):
                        _set_path(cfg, path, domain.sample(self._rng, cfg))
                    else:
                        _set_path(cfg, path, domain.sample(self._rng))
                yield cfg

    def count(self, space: Dict[str, Any], num_samples: int = 1) -> int:
        grids, _ = _find_axes(space)
        n = max(num_samples, 1)
        for _, vals in grids:
            n *= len(vals)
        return n
