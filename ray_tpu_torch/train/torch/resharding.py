"""Rule-based checkpoint resharding: the counterpart of
``ray_tpu/train/jax/resharding.py``.

When an elastic gang shrinks or grows, the surviving checkpoint shards must
be cut again for the new world size. The rules are an ordered list of
``(regex, spec)`` pairs matched against the '/'-joined path of each leaf;
the first match wins and a 0-dim leaf is always replicated. A spec is a
tuple with one entry per dimension: None keeps the dimension whole, a mesh
axis name marks the one dimension that is split.

Leaves are numpy arrays or CPU tensors, and a tree may mix them. A split
dimension is cut with ``np.array_split``'s balance (the first ``dim % world``
ranks take one more element), so any world size holds the state: 4 -> 3
needs no padding. A DTensor ``Shard`` cuts as ``torch.chunk`` does (10 over
4 gives 3, 3, 3, 1), so ``device_put_tree`` places a split leaf on a mesh
only where the two cuts agree, and raises elsewhere.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PartitionSpec = Tuple[Optional[str], ...]

REPLICATED: PartitionSpec = ()


def tree_paths(tree: Any, sep: str = "/") -> Dict[str, Any]:
    """Flatten a nested dict/list tree into {joined_path: leaf}."""
    out: Dict[str, Any] = {}

    def walk(node: Any, prefix: List[str]) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + [str(i)])
        else:
            out[sep.join(prefix)] = node

    walk(tree, [])
    return out


def tree_unflatten(paths: Dict[str, Any], sep: str = "/") -> Any:
    """Inverse of ``tree_paths`` for dict-shaped trees (lists come back as
    dicts keyed by index, as in the JAX package)."""
    root: Dict[str, Any] = {}
    for path, leaf in paths.items():
        parts = path.split(sep) if path else [""]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def match_partition_rules(
    rules: Sequence[Tuple[str, PartitionSpec]], tree: Any, sep: str = "/"
) -> Dict[str, PartitionSpec]:
    """Every leaf path's spec, from the first rule whose regex it matches.
    A 0-dim leaf is replicated whatever the rules say; a leaf that matches no
    rule raises: a sharded tensor replicated by mistake corrupts a resume."""
    specs: Dict[str, PartitionSpec] = {}
    for path, leaf in tree_paths(tree, sep).items():
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0:
            specs[path] = REPLICATED
            continue
        for pattern, spec in rules:
            if re.search(pattern, path) is not None:
                specs[path] = tuple(spec)
                break
        else:
            raise ValueError(
                f"no partition rule matches checkpoint leaf '{path}' "
                f"(shape {shape}); add a rule or an explicit catch-all ('.*', ())"
            )
    return specs


def _shard_axis(spec: PartitionSpec) -> Optional[int]:
    """The one dimension a spec splits, or None if it splits none."""
    axes = [i for i, a in enumerate(spec) if a is not None]
    if not axes:
        return None
    if len(axes) > 1:
        raise ValueError(f"at most one sharded dimension supported, got {spec}")
    return axes[0]


def shard_bounds(dim: int, world_size: int, rank: int) -> Tuple[int, int]:
    """[start, stop) of ``rank``'s slice of a dimension of size ``dim``:
    ``np.array_split``'s balance (the first ``dim % world`` ranks take one
    more element)."""
    base, extra = divmod(dim, world_size)
    start = rank * base + min(rank, extra)
    return start, start + base + (1 if rank < extra else 0)


def _slice(leaf, axis: int, start: int, stop: int):
    """A copy of ``leaf[..., start:stop, ...]`` along ``axis`` that holds no
    reference to the whole leaf."""
    index = [slice(None)] * leaf.ndim
    index[axis] = slice(start, stop)
    if isinstance(leaf, torch.Tensor):
        return leaf[tuple(index)].clone()
    return np.ascontiguousarray(np.asarray(leaf)[tuple(index)])


def shard_for_rank(
    tree: Any,
    rules: Sequence[Tuple[str, PartitionSpec]],
    world_size: int,
    rank: int,
    sep: str = "/",
) -> Any:
    """``rank``'s shard of a whole (host) state tree at ``world_size``."""
    specs = match_partition_rules(rules, tree, sep)
    out: Dict[str, Any] = {}
    for path, leaf in tree_paths(tree, sep).items():
        axis = _shard_axis(specs[path])
        if axis is None:
            out[path] = leaf
        else:
            out[path] = _slice(leaf, axis, *shard_bounds(leaf.shape[axis], world_size, rank))
    return tree_unflatten(out, sep)


def gather_tree(
    shards_by_rank: Dict[int, Any],
    rules: Sequence[Tuple[str, PartitionSpec]],
    sep: str = "/",
) -> Any:
    """The whole state tree from one shard per rank (the inverse of
    ``shard_for_rank`` at the world size that cut them): replicated leaves
    from the lowest rank, split ones concatenated in rank order."""
    if not shards_by_rank:
        raise ValueError("gather_tree needs at least one shard")
    ranks = sorted(shards_by_rank)
    flat = {rk: tree_paths(shards_by_rank[rk], sep) for rk in ranks}
    specs = match_partition_rules(rules, shards_by_rank[ranks[0]], sep)
    out: Dict[str, Any] = {}
    for path, leaf in flat[ranks[0]].items():
        axis = _shard_axis(specs[path])
        if axis is None:
            out[path] = leaf
            continue
        parts = [flat[rk][path] for rk in ranks]
        if isinstance(leaf, torch.Tensor):
            out[path] = torch.cat([torch.as_tensor(p) for p in parts], dim=axis)
        else:
            out[path] = np.concatenate([np.asarray(p) for p in parts], axis=axis)
    return tree_unflatten(out, sep)


def reshard(
    tree: Any,
    rules: Sequence[Tuple[str, PartitionSpec]],
    new_world_size: int,
    new_rank: int,
    sep: str = "/",
) -> Any:
    """A whole tree cut for a resized gang: what a rank calls on the
    recovered checkpoint when it resumes."""
    return shard_for_rank(tree, rules, new_world_size, new_rank, sep)


def device_put_tree(tree: Any, rules, mesh=None, sep: str = "/") -> Any:
    """A whole host tree placed on ``mesh`` (a ``DeviceMesh``), each leaf a
    DTensor split on its spec's mesh axis (``Shard``) or replicated, on the
    rank's device. Without a mesh, the host tree as it is. Raises where the
    JAX package leaves a leaf on the host: a spec naming an axis the mesh
    lacks, or a split dimension the axis does not divide (where ``Shard``'s
    cut and ``shard_bounds``' differ)."""
    if mesh is None:
        return tree
    from torch.distributed.tensor import Replicate, Shard

    from ray_tpu_torch.models.training import mesh_device
    from ray_tpu_torch.parallel.mesh import distribute

    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    device = mesh_device(mesh)
    specs = match_partition_rules(rules, tree, sep)
    out = {}
    for path, leaf in tree_paths(tree, sep).items():
        t = torch.as_tensor(np.asarray(leaf) if not isinstance(leaf, torch.Tensor) else leaf)
        placements = [Replicate() for _ in names]
        axis = _shard_axis(specs[path])
        if axis is not None:
            name = specs[path][axis]
            if name not in sizes:
                raise ValueError(f"'{path}': spec {specs[path]} names axis '{name}', "
                                 f"which the mesh {names} lacks")
            if t.shape[axis] % int(sizes[name]):
                raise ValueError(
                    f"'{path}': dim {axis} of {t.shape[axis]} does not split evenly over "
                    f"'{name}' of {int(sizes[name])} (a DTensor Shard would cut it unlike "
                    "shard_bounds)")
            placements[names.index(name)] = Shard(axis)
        out[path] = distribute(t.to(device), mesh, placements)
    return tree_unflatten(out, sep)


def resume_state(ckpt_dict: Dict[str, Any]) -> Tuple[int, Any, Any]:
    """(step, whole state tree, rules) of a recovery checkpoint the elastic
    controller assembled. Raises KeyError on a checkpoint of another shape,
    so a caller can fall back to its own format."""
    return ckpt_dict["elastic_step"], ckpt_dict["state"], ckpt_dict["rules"]
