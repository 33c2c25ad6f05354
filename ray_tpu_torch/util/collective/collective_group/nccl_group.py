"""NCCL collective group: the port's device group, the counterpart of
``ray_tpu/util/collective/collective_group/xla_group.py`` (``XLAGroup``) and
of the reference's ``NCCLGroup``
(``python/ray/util/collective/collective_group/nccl_collective_group.py:127``).

Each group owns a ``torch.distributed`` process group of its own, built from
a ``TCPStore`` whose address rank 0 publishes in the KV store under the group's
name (the seam the reference fills with a named ``NCCLUniqueIDStore`` actor,
and the JAX package with ``jax.distributed.initialize``). It never touches
the default process group, so any number of named groups live side by side
with a trainer's gang.

The group runs NCCL on the process's CUDA device. With ``device="cpu"``,
which a caller must ask for, it runs gloo on CPU tensors instead; that is how
the tests reach it on a machine without a card. A tensor on the other kind of
device raises. The group never switches backend by itself.

Semantics follow the JAX package's group: ``allreduce`` and ``broadcast``
return the result (here they also write it into the input, as NCCL does);
``reduce`` returns the result on the root and None elsewhere; ``allgather``
returns one tensor per rank; ``reducescatter`` returns this rank's slice of
the reduced leading dim; ``sendrecv(perm)`` is the SPMD permute (rank ``i``
receives from ``j`` for ``(j, i)`` in ``perm``, zeros when nobody sends to
it). ``send``/``recv`` are eager point-to-point between two ranks. The
``*_multidevice`` variants take one tensor per local device: NCCL takes one
device per process, so they reduce (or gather) across the process's devices
first, then across the group.
"""

from __future__ import annotations

import datetime
import socket
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.util.collective.collective_group.base_group import BaseGroup
from ray_tpu_torch.util.collective.rendezvous import clear, publish, wait_for
from ray_tpu_torch.util.collective.types import ReduceOp

_TORCH_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MEAN: dist.ReduceOp.SUM,  # divided by the element count after
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
}


def _store_key(group_name: str) -> bytes:
    return f"collective/{group_name}/nccl_store".encode()


class NCCLGroup(BaseGroup):
    def __init__(
        self,
        world_size: int,
        rank: int,
        group_name: str,
        kv=None,
        device=None,
        devices: Optional[Sequence] = None,
        timeout_s: float = 300.0,
    ):
        super().__init__(world_size, rank, group_name)
        self._kv = kv
        if device is not None and torch.device(device).type != "cpu":
            raise ValueError(f"device={device!r}: the group takes 'cpu' or None (the GPU)")
        self.on_cpu = device is not None
        if self.on_cpu:
            self.device = torch.device("cpu")
            default_devices = [self.device]
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available for an NCCL group; pass device='cpu' to "
                    "run the group on gloo"
                )
            self.device = torch.device("cuda", torch.cuda.current_device())
            default_devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.devices = [torch.device(d) for d in (devices or default_devices)]
        for d in self.devices:
            if (d.type == "cpu") != self.on_cpu:
                raise ValueError(f"group on {self.device} given local device {d}")
        timeout = datetime.timedelta(seconds=timeout_s)
        self._store = self._rendezvous(timeout)
        prefixed = dist.PrefixStore(f"{group_name}/", self._store)
        if self.on_cpu:
            self.pg = dist.ProcessGroupGloo(prefixed, rank, world_size, timeout)
        else:
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            self.pg = dist.ProcessGroupNCCL(prefixed, rank, world_size, opts)

    def _rendezvous(self, timeout):
        """Rank 0 hosts a TCPStore and publishes its address in the KV store;
        the others read it and connect."""
        key = _store_key(self.group_name)
        if self.world_size == 1:
            return dist.HashStore()
        if self.rank == 0:
            try:
                host = socket.gethostbyname(socket.gethostname())
            except OSError:
                host = "127.0.0.1"
            store = dist.TCPStore(host, 0, self.world_size, True, timeout=timeout,
                                  wait_for_workers=False)
            publish(self._kv, key, f"{host}:{store.port}".encode())
            return store
        host, port = wait_for(self._kv, key).decode().rsplit(":", 1)
        return dist.TCPStore(host, int(port), self.world_size, False, timeout=timeout)

    # ------------------------------------------------------------------ helpers
    def _check(self, tensor) -> torch.Tensor:
        if not isinstance(tensor, torch.Tensor):
            raise TypeError(f"an NCCL group takes torch tensors, got {type(tensor).__name__}")
        if (tensor.device.type == "cpu") != self.on_cpu:
            where = "gloo on the CPU" if self.on_cpu else f"NCCL on {self.device}"
            raise ValueError(
                f"collective group '{self.group_name}' runs {where} and was given a tensor on "
                f"{tensor.device}; create the group with device='cpu' for CPU tensors"
            )
        return tensor

    def _allreduce_(self, t: torch.Tensor, op: ReduceOp) -> torch.Tensor:
        opts = dist.AllreduceOptions()
        opts.reduceOp = _TORCH_OPS[ReduceOp(op)]
        self.pg.allreduce([t], opts).wait()
        if ReduceOp(op) == ReduceOp.MEAN:
            t.div_(self.world_size)
        return t

    def _local_reduce(self, tensors: List[torch.Tensor], op: ReduceOp) -> torch.Tensor:
        """The op over this process's per-device tensors, on the group's
        device (MEAN is left as a SUM: the caller divides once)."""
        if not tensors:
            raise ValueError("expected one tensor per local device, got none")
        if len(tensors) != len(self.devices):
            raise ValueError(f"expected {len(self.devices)} per-device tensors, got {len(tensors)}")
        acc = self._check(tensors[0]).to(self.device, copy=True)
        for t in tensors[1:]:
            t = self._check(t).to(self.device)
            if ReduceOp(op) in (ReduceOp.SUM, ReduceOp.MEAN):
                acc.add_(t)
            elif ReduceOp(op) == ReduceOp.PRODUCT:
                acc.mul_(t)
            elif ReduceOp(op) == ReduceOp.MIN:
                torch.minimum(acc, t, out=acc)
            else:
                torch.maximum(acc, t, out=acc)
        return acc

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """(world, *t.shape): every rank's ``t``, in rank order."""
        out = torch.empty(self.world_size * t.numel(), dtype=t.dtype, device=t.device)
        self.pg._allgather_base(out, t.contiguous().view(-1)).wait()
        return out.view(self.world_size, *t.shape)

    # ------------------------------------------------------------------ collectives
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        return self._allreduce_(self._check(tensor), op)

    def barrier(self):
        self._allreduce_(torch.zeros(1, device=self.device), ReduceOp.SUM)
        if not self.on_cpu:
            torch.cuda.synchronize(self.device)

    def reduce(self, tensor, root_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        t = self._check(tensor)
        opts = dist.ReduceOptions()
        opts.rootRank = root_rank
        opts.reduceOp = _TORCH_OPS[ReduceOp(op)]
        self.pg.reduce([t], opts).wait()
        if self.rank != root_rank:
            return None
        if ReduceOp(op) == ReduceOp.MEAN:
            t.div_(self.world_size)
        return t

    def broadcast(self, tensor, root_rank: int = 0):
        t = self._check(tensor)
        opts = dist.BroadcastOptions()
        opts.rootRank = root_rank
        self.pg.broadcast([t], opts).wait()
        return t

    def allgather(self, tensor) -> List[torch.Tensor]:
        return list(self._gather_rows(self._check(tensor)).unbind(0))

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        t = self._check(tensor).contiguous()
        if t.dim() == 0 or t.shape[0] % self.world_size:
            raise ValueError(
                f"reducescatter needs a leading dim divisible by {self.world_size}, got "
                f"{tuple(t.shape)}"
            )
        out = torch.empty((t.shape[0] // self.world_size, *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = _TORCH_OPS[ReduceOp(op)]
        self.pg._reduce_scatter_base(out, t, opts).wait()
        if ReduceOp(op) == ReduceOp.MEAN:
            out.div_(self.world_size)
        return out

    def send(self, tensor, dst_rank: int):
        if dst_rank == self.rank:
            raise ValueError("send to this rank itself: use sendrecv([(r, r)])")
        self.pg.send([self._check(tensor).contiguous()], dst_rank, 0).wait()

    def recv(self, shape, dtype, src_rank: int):
        if src_rank == self.rank:
            raise ValueError("recv from this rank itself: use sendrecv([(r, r)])")
        out = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        self.pg.recv([out], src_rank, 0).wait()
        return out

    def sendrecv(self, tensor, perm: Sequence[Tuple[int, int]]):
        """All ranks enter with same-shaped tensors; rank ``i`` gets the tensor
        of ``j`` for ``(j, i)`` in ``perm`` and zeros if no pair ends at it.
        One all-to-all with per-peer sizes of the whole tensor or nothing."""
        t = self._check(tensor).contiguous()
        perm = [(int(s), int(d)) for s, d in perm]
        for pairs, what in ((perm, "source"), ([(d, s) for s, d in perm], "destination")):
            firsts = [p[0] for p in pairs]
            if len(set(firsts)) != len(firsts):
                raise ValueError(f"perm {perm} repeats a {what}")
        dsts = [d for s, d in perm if s == self.rank]
        srcs = [s for s, d in perm if d == self.rank]
        n = t.numel()
        in_split = [n if r in dsts else 0 for r in range(self.world_size)]
        out_split = [n if r in srcs else 0 for r in range(self.world_size)]
        out = torch.zeros(sum(out_split), dtype=t.dtype, device=t.device)
        inp = t.reshape(-1) if dsts else t.new_empty(0)
        self.pg.alltoall_base(out, inp, out_split, in_split, dist.AllToAllOptions()).wait()
        return out.reshape(t.shape) if srcs else torch.zeros_like(t)

    # ------------------------------------------------------------------ local-device variants
    # The counterpart of the reference's *_multigpu calls: one process driving
    # several devices, one tensor on each.
    def allreduce_multidevice(self, tensors: List, op: ReduceOp = ReduceOp.SUM):
        acc = self._allreduce_(self._local_reduce(tensors, op), op)
        if ReduceOp(op) == ReduceOp.MEAN:
            acc.div_(len(tensors))
        for t in tensors:
            t.copy_(acc)
        return list(tensors)

    def allgather_multidevice(self, tensors: List) -> List[torch.Tensor]:
        """Every device's tensor of every rank, rank-major, each on the
        group's device."""
        if len(tensors) != len(self.devices):
            raise ValueError(f"expected {len(self.devices)} per-device tensors, got {len(tensors)}")
        local = torch.stack([self._check(t).to(self.device) for t in tensors])
        rows = self._gather_rows(local)
        return list(rows.reshape(-1, *local.shape[1:]).unbind(0))

    def reducescatter_multidevice(self, tensors: List, op: ReduceOp = ReduceOp.SUM):
        """The op over every device of every rank, its leading dim split into
        world x local-device slices; local device ``i`` gets slice
        ``rank * n_local + i``."""
        acc = self._local_reduce(tensors, op)
        nlocal = len(tensors)
        if acc.dim() == 0 or acc.shape[0] % (self.world_size * nlocal):
            raise ValueError(
                f"reducescatter_multidevice needs a leading dim divisible by "
                f"{self.world_size * nlocal}, got {tuple(acc.shape)}"
            )
        mine = self.reducescatter(acc, ReduceOp.SUM if op == ReduceOp.MEAN else op)
        if ReduceOp(op) == ReduceOp.MEAN:
            mine.div_(self.world_size * nlocal)
        return [s.to(d, copy=True) for s, d in zip(mine.chunk(nlocal, 0), self.devices)]

    def destroy(self):
        if self.pg is not None:
            try:
                if not self.on_cpu:
                    self.pg.shutdown()
            except (AttributeError, RuntimeError):
                pass
            self.pg = None
        self._store = None
        if self.rank == 0 and self.world_size > 1 and self._kv is not None:
            clear(self._kv, _store_key(self.group_name))
