"""Collective API (reference: `python/ray/util/collective/collective.py` —
`init_collective_group:120`, `allreduce:258`, `barrier:298`, `reduce:311`,
`broadcast:373`, `allgather:423`, `reducescatter:472`, `send/recv:531+`): the
counterpart of ``ray_tpu/util/collective/collective.py``.

Backends: ``nccl`` (device tensors over ``torch.distributed``; ``xla`` is
accepted and resolves to it; ``device="cpu"`` runs the same group on gloo,
only when asked) and ``tcp`` (host data over sockets; ``gloo`` resolves to
it). Rendezvous uses the KV store instead of a named NCCLUniqueIDStore actor.
Every op is timed into ``_STATS``, which the Train step clock reads as its
collective seconds.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch.util.collective.types import Backend, ReduceOp

_groups: Dict[str, object] = {}
_lock = threading.Lock()
_RESERVED = object()

# Plain per-process accumulators for the train-session step clock: ops and
# wall-seconds spent inside collective calls, plus per-rank arrival offsets
# reported back by the TCP coordinator (how much earlier this rank reached
# the rendezvous than the last arriver — a fast rank accumulates offset, the
# straggler accumulates ~none). Hot-path discipline: plain int/float bumps
# here; the step clock diffs them per step and materializes Metric samples.
_STATS = {
    "ops": 0,
    "errors": 0,
    "time_s": 0.0,
    "arrival_offset_s": 0.0,
    "arrival_offsets": 0,
}


def _note_arrival_offset(offset_s: float) -> None:
    """Called by collective groups when a completed op learns this rank's
    arrival offset (seconds it arrived before the gang's last arriver)."""
    _STATS["arrival_offset_s"] += float(offset_s)
    _STATS["arrival_offsets"] += 1


def _rank_tag(group_name: str) -> str:
    g = _groups.get(group_name)
    rank = getattr(g, "rank", None)
    return str(rank) if rank is not None else "-"


def _timed(op: str, group_name: str, fn):
    """Record a collective op's wall time: a ray_tpu_collective_op_seconds
    histogram sample (enable_metrics) and a "collective" span for the unified
    timeline (enable_timeline or explicit tracing). Both off -> plain call.
    Ops that raise record too (status="error"): a hung or failed collective
    must show up in the same series the healthy ones feed."""
    from ray_tpu_torch._private.config import get_config

    cfg = get_config()
    from ray_tpu_torch.util import tracing

    want_span = cfg.enable_timeline or tracing.is_enabled()
    want_metric = cfg.enable_metrics
    if not want_span and not want_metric:
        return fn()
    span = None
    if want_span:
        span = tracing.start_span(
            f"collective::{op}", "collective", attributes={"group": group_name}
        )
    t0 = time.perf_counter()
    try:
        out = fn()
    except BaseException:
        dt = time.perf_counter() - t0
        _STATS["ops"] += 1
        _STATS["errors"] += 1
        _STATS["time_s"] += dt
        if want_metric:
            from ray_tpu_torch._private.telemetry import collective_histogram

            collective_histogram().observe(
                dt, {"op": op, "group": group_name,
                     "rank": _rank_tag(group_name), "status": "error"}
            )
        if span is not None:
            tracing.end_span(span, "ERROR")
        raise
    dt = time.perf_counter() - t0
    _STATS["ops"] += 1
    _STATS["time_s"] += dt
    if want_metric:
        from ray_tpu_torch._private.telemetry import collective_histogram

        collective_histogram().observe(
            dt, {"op": op, "group": group_name,
                 "rank": _rank_tag(group_name), "status": "ok"}
        )
    if span is not None:
        tracing.end_span(span)
    return out


def _kv(op: str, *args):
    from ray_tpu_torch._private.worker import _auto_init, global_worker

    _auto_init()
    return global_worker.context.kv(op, *args)


def is_group_initialized(group_name: str = "default") -> bool:
    g = _groups.get(group_name)
    return g is not None and g is not _RESERVED


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "nccl",
    group_name: str = "default",
    devices: Optional[List] = None,
    device=None,
):
    """Join this process into a named collective group. Every participant must
    call this with the same world_size/group_name and a distinct rank.
    ``device="cpu"`` runs an ``nccl`` group on gloo over CPU tensors; without
    it the group runs NCCL on the GPU and raises when there is none.
    ``devices`` are this process's devices for the ``*_multidevice`` ops
    (default: every visible GPU)."""
    if world_size < 1 or not (0 <= rank < world_size):
        raise ValueError(f"invalid world_size={world_size} rank={rank}")
    # Reserve the name atomically so concurrent initializations of the same
    # group cannot both construct (and leak) a coordinator.
    with _lock:
        if group_name in _groups:
            raise RuntimeError(f"collective group '{group_name}' already initialized")
        _groups[group_name] = _RESERVED
    try:
        b = Backend.resolve(backend)
        if b == Backend.NCCL:
            from ray_tpu_torch.util.collective.collective_group.nccl_group import NCCLGroup

            g = NCCLGroup(world_size, rank, group_name, kv=_kv, device=device, devices=devices)
        elif b == Backend.TCP:
            from ray_tpu_torch.util.collective.collective_group.tcp_group import TCPGroup

            g = TCPGroup(world_size, rank, group_name, kv=_kv)
        else:
            raise ValueError(f"unsupported backend {backend}")
    except BaseException:
        with _lock:
            if _groups.get(group_name) is _RESERVED:
                del _groups[group_name]
        raise
    with _lock:
        _groups[group_name] = g
    return g


def destroy_collective_group(group_name: str = "default") -> None:
    with _lock:
        g = _groups.pop(group_name, None)
    if g is not None:
        g.destroy()


def get_group(group_name: str = "default"):
    g = _groups.get(group_name)
    if g is _RESERVED:
        raise RuntimeError(f"collective group '{group_name}' is still initializing")
    if g is None:
        raise RuntimeError(
            f"collective group '{group_name}' is not initialized in this process; "
            "call init_collective_group first"
        )
    return g


def get_rank(group_name: str = "default") -> int:
    return get_group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return get_group(group_name).world_size


def allreduce(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return _timed("allreduce", group_name,
                  lambda: get_group(group_name).allreduce(tensor, op))


def barrier(group_name: str = "default") -> None:
    _timed("barrier", group_name, lambda: get_group(group_name).barrier())


def reduce(tensor, dst_rank: int = 0, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return _timed("reduce", group_name,
                  lambda: get_group(group_name).reduce(tensor, root_rank=dst_rank, op=op))


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _timed("broadcast", group_name,
                  lambda: get_group(group_name).broadcast(tensor, root_rank=src_rank))


def allgather(tensor, group_name: str = "default"):
    return _timed("allgather", group_name,
                  lambda: get_group(group_name).allgather(tensor))


def reducescatter(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return _timed("reducescatter", group_name,
                  lambda: get_group(group_name).reducescatter(tensor, op))


def send(tensor, dst_rank: int, group_name: str = "default"):
    return _timed("send", group_name,
                  lambda: get_group(group_name).send(tensor, dst_rank))


def recv(shape, dtype, src_rank: int, group_name: str = "default"):
    return _timed("recv", group_name,
                  lambda: get_group(group_name).recv(shape, dtype, src_rank))


def sendrecv(tensor, perm, group_name: str = "default"):
    """SPMD permute: all ranks call; rank i receives from j for (j, i) in perm
    (nccl backend only; one all-to-all)."""
    return _timed("sendrecv", group_name,
                  lambda: get_group(group_name).sendrecv(tensor, perm))


# Reference-parity aliases for the multi-accelerator-per-process variants.
def allreduce_multidevice(tensors, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return _timed("allreduce_multidevice", group_name,
                  lambda: get_group(group_name).allreduce_multidevice(tensors, op))


def allgather_multidevice(tensors, group_name: str = "default"):
    return _timed("allgather_multidevice", group_name,
                  lambda: get_group(group_name).allgather_multidevice(tensors))


def reducescatter_multidevice(tensors, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return _timed("reducescatter_multidevice", group_name,
                  lambda: get_group(group_name).reducescatter_multidevice(tensors, op))
