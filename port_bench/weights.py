"""What the check reads of a params-shaped tree: its leaves by dotted name,
and the norms of an architecture's units (``archs/<model_type>.py``'s
``units``), of a tree or of the change between two."""

from __future__ import annotations

import torch


def leaves(tree, prefix=""):
    """(dotted name, tensor) of every leaf of nested dicts, in order."""
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out += leaves(v, name + ".") if isinstance(v, dict) else [(name, v)]
    return out


def unit_norms(units, scale=1.0):
    """The f32 Frobenius norm of each of ``units`` (name -> tensor), times
    ``scale``."""
    with torch.no_grad():
        norms = torch.stack([p.detach().float().norm() for p in units.values()]) * scale
    return dict(zip(units, norms.tolist()))


def delta_norms(after, before):
    """The norm of each unit of ``after - before`` (two dicts of units)."""
    with torch.no_grad():
        norms = torch.stack([(after[k].detach().float() - before[k].float()).norm()
                             for k in after])
    return dict(zip(after, norms.tolist()))
