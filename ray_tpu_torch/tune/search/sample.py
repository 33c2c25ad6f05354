"""Search-space primitives: the vocabulary of `param_space`.

Reference: `python/ray/tune/search/sample.py` (`Domain`, `Float`, `Integer`,
`Categorical`, `Function`) and `tune/search/variant_generator.py`'s
`grid_search` marker. A Domain knows how to draw one value; grid_search marks
an axis for exhaustive expansion by `BasicVariantGenerator`.
"""

from __future__ import annotations

import math
import random
from typing import Any, Callable, Dict, List, Optional, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False, q: Optional[float] = None):
        if log and (lower <= 0 or upper <= 0):
            raise ValueError("loguniform requires positive bounds")
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng: random.Random) -> float:
        if self.log:
            v = math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(v / self.q) * self.q
        return v


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False, q: Optional[int] = None):
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng: random.Random) -> int:
        if self.log:
            v = int(math.exp(rng.uniform(math.log(self.lower), math.log(self.upper))))
        else:
            v = rng.randint(self.lower, self.upper - 1)
        if self.q:
            v = int(round(v / self.q) * self.q)
        return max(self.lower, min(v, self.upper - 1))


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.categories)


class Normal(Domain):
    def __init__(self, mean: float, sd: float):
        self.mean, self.sd = mean, sd

    def sample(self, rng: random.Random) -> float:
        return rng.gauss(self.mean, self.sd)


class Function(Domain):
    def __init__(self, fn: Callable[[Dict[str, Any]], Any]):
        self.fn = fn

    def sample(self, rng: random.Random, spec: Optional[Dict[str, Any]] = None) -> Any:
        try:
            return self.fn(spec or {})
        except TypeError:
            return self.fn()


# ----------------------------------------------------------------- public API
def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def qrandint(lower: int, upper: int, q: int) -> Integer:
    return Integer(lower, upper, q=q)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values: List[Any]) -> Dict[str, List[Any]]:
    return {"grid_search": list(values)}
