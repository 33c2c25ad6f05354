"""Device-mesh construction and sharding rules: the counterpart of
``ray_tpu/parallel/mesh.py``, in PyTorch's idiom.

- ``MeshSpec(data=, fsdp=, tensor=, pipeline=, context=, expert=)`` names the
  six axes in the JAX package's order (``AXIS_ORDER``, ``tensor`` innermost,
  so tensor-parallel ranks are neighbours: on one host, the GPUs an NVLink
  switch joins). ``build()`` makes a ``torch.distributed.device_mesh.
  DeviceMesh`` with those six dim names over the world of the default process
  group, one rank per device.
- ``ShardingRules`` maps logical array axes ("batch", "embed", "heads", ...)
  to mesh axes with the JAX package's rules. ``mesh_axes`` returns the mesh
  axes per dimension as the JAX ``PartitionSpec`` lists them, so the two are
  compared entry for entry; ``placements`` turns them into DTensor
  placements (one per mesh dim).
- ``shard_params`` distributes a tree of full tensors leaf by leaf through
  ``distribute_tensor``; ``batch_spec``/``batch_sharding``/``replicated`` and
  ``host_local_to_global``/``global_to_host_local`` map onto
  ``DTensor.from_local`` and ``to_local``.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

AXIS_ORDER = ("data", "fsdp", "pipeline", "expert", "context", "tensor")


@dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    pipeline: int = 1
    context: int = 1
    expert: int = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    @property
    def num_devices(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def build(self, device=None):
        """A ``DeviceMesh`` with ``AXIS_ORDER`` dim names over the default
        process group's ranks, in rank order, on the GPU (``device="cpu"``:
        on the CPU, which the caller must ask for). Raises ``ValueError``
        when the world size differs from ``num_devices``."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.num_devices:
            raise ValueError(
                f"MeshSpec wants {self.num_devices} devices "
                f"({dict(zip(AXIS_ORDER, self.shape))}), got {world}"
            )
        if not dist.is_initialized():
            raise RuntimeError(
                "MeshSpec.build needs a torch.distributed process group (a TorchTrainer gang "
                "makes one; so does init_process_group)"
            )
        if device is None:
            from ray_tpu_torch._private.accelerators.gpu import default_device

            device = default_device()
        device_type = torch.device(device).type
        grid = torch.arange(world).reshape(self.shape)
        return DeviceMesh(device_type, grid, mesh_dim_names=AXIS_ORDER)

    @classmethod
    def for_data_parallel(cls, num_devices: int) -> "MeshSpec":
        return cls(data=num_devices)

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "MeshSpec":
        return cls(**{k: int(v) for k, v in d.items()})

    def replace(self, **kw) -> "MeshSpec":
        return dataclasses.replace(self, **kw)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``, a ``MeshSpec`` or a dict."""
    if isinstance(mesh, MeshSpec):
        return dict(zip(AXIS_ORDER, mesh.shape))
    if isinstance(mesh, dict):
        return {a: int(mesh.get(a, 1)) for a in AXIS_ORDER}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


# --------------------------------------------------------------------------- logical sharding rules
Rule = Tuple[str, Optional[Tuple[str, ...]]]


@dataclass
class ShardingRules:
    """Logical-axis -> mesh-axis mapping, applied to model annotations.

    The default rules are the JAX package's transformer recipe: batch over
    (data, fsdp); embed over fsdp (ZeRO-3 style parameter shard); mlp/heads
    over tensor (megatron style); sequence over context; experts over expert.
    """

    rules: Tuple[Rule, ...] = (
        ("batch", ("data", "fsdp")),
        ("sequence", ("context",)),
        ("embed", ("fsdp",)),
        ("mlp", ("tensor",)),
        ("heads", ("tensor",)),
        ("kv_heads", ("tensor",)),
        ("vocab", ("tensor",)),
        ("expert", ("expert",)),
        # Layer stacks shard over the pipeline axis; on pipeline=1 meshes the
        # divisibility filter drops it and layers stay replicated.
        ("layers", ("pipeline",)),
        ("stage", ("pipeline",)),
        ("head_dim", None),
        ("norm", None),
    )

    def mesh_axes(
        self,
        logical_axes: Sequence[Optional[str]],
        mesh=None,
        shape: Optional[Sequence[int]] = None,
    ) -> Tuple:
        """Mesh axes per dimension of an array annotated with logical axis
        names: None, one axis name, or a tuple of them, as the entries of the
        JAX ``PartitionSpec``.

        With ``mesh`` + ``shape``, mesh axes that don't divide the dimension
        are dropped (2 heads on a tensor=4 mesh stay replicated): of the free
        axes of size > 1, the order-preserving subset with the largest product
        that divides the dimension.
        """
        lookup = dict(self.rules)
        sizes = axis_sizes(mesh) if mesh is not None else None
        out: List = []
        used: set = set()
        for i, ax in enumerate(logical_axes):
            if ax is None:
                out.append(None)
                continue
            if ax not in lookup:
                raise ValueError(f"no sharding rule for logical axis '{ax}'")
            mesh_axes = lookup[ax]
            if mesh_axes is None:
                out.append(None)
                continue
            # An axis already consumed by another dimension cannot repeat.
            free = [a for a in mesh_axes if a not in used]
            if sizes is not None and shape is not None:
                dim = shape[i]
                candidates = [a for a in free if sizes[a] > 1]
                best: List[str] = []
                best_prod = 1
                # Exhaustive over subsets (rules map to <= 3 axes): a larger
                # subset is not necessarily a larger product.
                for r in range(len(candidates), 0, -1):
                    for combo in itertools.combinations(candidates, r):
                        prod = 1
                        for a in combo:
                            prod *= sizes[a]
                        if dim % prod == 0 and prod > best_prod:
                            best, best_prod = list(combo), prod
                free = best
            used.update(free)
            if not free:
                out.append(None)
            elif len(free) == 1:
                out.append(free[0])
            else:
                out.append(tuple(free))
        return tuple(out)

    def placements(self, logical_axes: Sequence[Optional[str]], mesh, shape: Sequence[int]):
        """DTensor placements (one per mesh dim, in ``AXIS_ORDER``) of an
        array of ``shape``: ``Shard(i)`` on each mesh axis ``mesh_axes``
        gives dimension ``i``, ``Replicate()`` elsewhere."""
        return spec_placements(self.mesh_axes(logical_axes, mesh=mesh, shape=shape))


def spec_placements(spec: Sequence) -> List:
    """DTensor placements of a ``mesh_axes`` spec. A dimension over several
    mesh axes is split over them in ``AXIS_ORDER`` (outermost first), as a
    JAX ``PartitionSpec`` tuple splits it in its order."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate() for _ in AXIS_ORDER]
    for dim, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        order = [AXIS_ORDER.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"mesh axes {names} of dim {dim} are not in AXIS_ORDER")
        for i in order:
            placements[i] = Shard(dim)
    return placements


def batch_spec() -> Tuple:
    """Batch over (data, fsdp), sequence over context."""
    return (("data", "fsdp"), "context")


def batch_sharding(mesh, ndim: int = 2):
    """Placements of an ``ndim``-D batch: ``batch_spec`` for a 2-D token
    batch, the batch dim alone for any other rank."""
    return spec_placements(batch_spec() if ndim == 2 else (("data", "fsdp"),))


def replicated(mesh):
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


# --------------------------------------------------------------------------- host<->global helpers
def host_local_to_global(mesh, spec, array):
    """This rank's shard -> a DTensor over ``mesh`` with ``spec``'s
    placements (the shards of all ranks make up the global shape)."""
    import torch
    from torch.distributed.tensor import DTensor

    local = torch.as_tensor(array)
    placements = spec_placements(spec)
    shape = list(local.shape)
    sizes = mesh.mesh.shape
    for mdim, p in enumerate(placements):
        if p.is_shard():
            shape[p.dim] *= int(sizes[mdim])
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def global_to_host_local(garr):
    """This rank's shard of a DTensor (the inverse of the above)."""
    return garr.to_local()


def distribute(tensor, mesh, placements):
    """``tensor`` (the same full value on every rank) as a DTensor with
    ``placements``: each rank keeps its own slice, no collective runs, and
    the slice holds no reference to the whole."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    dt = distribute_tensor(tensor, mesh, placements, src_data_rank=None)
    local = dt.to_local()
    if (local.numel() < tensor.numel()
            and local.untyped_storage().data_ptr() == tensor.untyped_storage().data_ptr()):
        dt = DTensor.from_local(local.clone(), mesh, placements, run_check=False,
                                shape=dt.shape, stride=dt.stride())
    return dt


def shard_params(params, mesh, rules: ShardingRules, logical_axes):
    """DTensors of a tree of full params, leaf by leaf, by per-leaf logical
    axes (nested dicts and lists of the same structure)."""
    if isinstance(params, dict):
        return {k: shard_params(v, mesh, rules, logical_axes[k]) for k, v in params.items()}
    if isinstance(params, list):
        return [shard_params(v, mesh, rules, ax) for v, ax in zip(params, logical_axes)]
    return distribute(params, mesh, rules.placements(logical_axes, mesh, params.shape))
