from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator
from ray_tpu_torch.tune.search.searcher import RandomSearcher, Searcher
from ray_tpu_torch.tune.search.tpe import TPESearcher
from ray_tpu_torch.tune.search.sample import (
    Categorical,
    Domain,
    Float,
    Function,
    Integer,
    choice,
    grid_search,
    lograndint,
    loguniform,
    qrandint,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)

__all__ = [
    "BasicVariantGenerator",
    "RandomSearcher",
    "Searcher",
    "TPESearcher",
    "Categorical",
    "Domain",
    "Float",
    "Function",
    "Integer",
    "choice",
    "grid_search",
    "lograndint",
    "loguniform",
    "qrandint",
    "quniform",
    "randint",
    "randn",
    "sample_from",
    "uniform",
]
