"""The architectures the benchmark trains, one module each, chosen by a
configuration file's ``model_type``; and the plain reference of each, chosen
by its ``reference``.

``archs/<model_type>.py`` gives:

- ``port_config(model)``: the port's config object for the file's sizes;
- ``init_params(model, seed, device, dtype=torch.float32)``: the benchmark's
  own tree, drawn from the seed on ``device``, in the port's leaf names and
  shapes, so the port trains it and the reference reads the same values;
- ``units(tree)``: the pieces of a params-shaped tree that the check
  compares, by dotted name;
- ``forward_flops_per_token(model, seq)``: the model FLOPs of one token's
  forward (the products of the active parameters, and causal attention);
- ``attention_calls(model, traffic)``: ``(bh, seq, qk_dim, v_dim,
  calls_per_step)`` for each attention shape a step launches on one GPU,
  each call once forward and once backward;
- ``HALF_BATCH``: ``(module, attribute)`` of the port's function that takes
  the batch, which the ``half_batch`` fault wraps.

``reference/<reference>.py`` gives ``train(params, batches, model, opt,
precision="f32", on_step=None)``: plain PyTorch, in float32 or, with
``precision="fp8"``, the check's control. It imports nothing of the program.
"""

from __future__ import annotations

import importlib
import os

HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCES = os.path.join(os.path.dirname(HERE), "reference")


def _modules(folder):
    return sorted(n[:-3] for n in os.listdir(folder) if n.endswith(".py") and n[0] != "_")


def of(model):
    """The module of ``model["model_type"]``; a KeyError that names the known
    ones for a type that has none."""
    name, known = model.get("model_type"), _modules(HERE)
    if name not in known:
        raise KeyError(f"no architecture {name!r} in port_bench/archs; known: {known}")
    return importlib.import_module(f"port_bench.archs.{name}")


def reference(model):
    """The module of ``model["reference"]`` under ``port_bench/reference/``."""
    name, known = model.get("reference"), _modules(REFERENCES)
    if name not in known:
        raise KeyError(f"no reference {name!r} in port_bench/reference; known: {known}")
    return importlib.import_module(f"port_bench.reference.{name}")


def attention_launches(model, traffic):
    """Calls of each attention kernel a step: the sum over the step's
    shapes."""
    return sum(calls for *_, calls in of(model).attention_calls(model, traffic))
