"""Switch (top-1) mixture-of-experts MLP: the counterpart of ``ray_tpu/models/moe.py``.

Routing is the JAX package's dense one-hot dispatch and combine with a static
per-row capacity: each batch row is a routing group, each expert takes at most
``C = ceil(S * capacity_factor / E)`` of its tokens, and tokens over capacity
are dropped to the residual path. The dispatch and combine tensors are
``(B, S, E, C)``, the expert products batched einsums over ``E``.

On a mesh (``parallel/spmd.py``) each rank routes its own rows over all ``E``
experts. Over an ``expert`` axis a rank holds ``E / expert`` experts and runs
only their products; the combine is summed across the expert group in f32.
Over a ``tensor`` axis each expert's hidden dim is split, column-parallel in
and row-parallel out. Over a ``context`` axis a row's tokens are split across
ranks, and a token's slot counts the tokens of the ranks before it.

``route_counts`` counts the tokens every layer's forward routed and dropped
over capacity, summed on the device without a host sync, from the first
``reset_route_counts`` in a process on.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.util.tracing import region

# Tokens routed (a host count) and kept within capacity by MoE forwards
# since reset_route_counts: the kept ones as one int64 count a token position
# on each device, as long as the largest forward, added to on the device.
_ROUTES: Dict[str, Any] = {"on": False, "routed": 0, "kept": {}}
_ROUTES_LOCK = threading.Lock()


def moe_capacity(num_tokens: int, num_experts: int, capacity_factor: float) -> int:
    return max(math.ceil(num_tokens * capacity_factor / num_experts), 1)


class Route(NamedTuple):
    probs: Any  # (B, S, E) f32 router softmax
    expert_idx: Any  # (B, S) the top-1 expert
    gate: Any  # (B, S) f32, the chosen expert's probability
    slot: Any  # (B, S) the token's place in its expert's queue (0 where dropped)
    keep: Any  # (B, S) bool, within capacity
    capacity: int


def route(x, router_w, capacity_factor: float, spmd=None) -> Route:
    """Top-1 routing of x (B, S, D) over router_w (D, E), in f32. ``argmax``
    takes the first maximum on a tie, as ``jnp.argmax`` does. Over a context
    split (``spmd.cp > 1``) x is this rank's slice of each row: the capacity
    is that of the whole row, and each queue starts after the tokens that the
    ranks before this one sent to the same expert."""
    S, E = x.shape[1], router_w.shape[1]
    cp = 1 if spmd is None else spmd.cp
    C = moe_capacity(S * cp, E, capacity_factor)
    logits = torch.einsum("bsd,de->bse", x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, -1, expert_idx[..., None])[..., 0]
    onehot = F.one_hot(expert_idx, E)
    position = torch.cumsum(onehot, dim=1)
    if cp > 1:
        position = position + spmd.context_prefix(onehot.sum(1))[:, None, :]
    position = position * onehot  # 1-based slot within the row
    keep = ((position > 0) & (position <= C)).any(-1)
    slot = ((position - 1) * onehot).sum(-1)
    # jax.nn.one_hot gives zeros for a slot past C; F.one_hot raises, so a
    # dropped token (masked by keep anyway) takes slot 0.
    slot = torch.where(keep, slot, 0)
    return Route(probs, expert_idx, gate, slot, keep, C)


def _count_routes(keep) -> None:
    """Add a forward's routing to ``_ROUTES`` once ``reset_route_counts`` has
    started the count: one kernel, no sync (the sum waits for
    ``route_counts``). A checkpoint recomputes the forward inside the
    backward's graph task, and counts nothing there."""
    if not _ROUTES["on"] or torch._C._current_graph_task_id() != -1:
        return
    n = keep.numel()
    # The device's counts live outside inference mode, so that a forward
    # under torch.inference_mode and a training forward add to the same.
    with _ROUTES_LOCK, torch.inference_mode(False):
        kept = _ROUTES["kept"].get(keep.device)
        if kept is None or kept.numel() < n:
            grown = torch.zeros(n, dtype=torch.int64, device=keep.device)
            if kept is not None:
                grown[:kept.numel()] = kept
            _ROUTES["kept"][keep.device] = kept = grown
        kept[:n].add_(keep.reshape(-1))
        _ROUTES["routed"] += n


def route_counts() -> Dict[str, int]:
    """Tokens routed and dropped over capacity by every MoE layer's forward
    (a checkpoint's recompute not counted again) since the last
    ``reset_route_counts``, on this rank. Reads the device's sum: call it
    after the caller's sync."""
    with _ROUTES_LOCK:
        kept = sum(int(t.sum()) for t in _ROUTES["kept"].values())
        return {"routed": _ROUTES["routed"], "dropped": _ROUTES["routed"] - kept}


def reset_route_counts() -> None:
    """Zero the counts, and count from now on in this process: until its
    first call a MoE forward launches nothing for the counter."""
    with _ROUTES_LOCK:
        _ROUTES.update(on=True, routed=0, kept={})


def moe_mlp(
    x,  # (B, S, D) activations, config.dtype
    router_w,  # (D, E) f32
    fc_w,  # (E, D, F); on a mesh (E / expert, D, F / tensor)
    fc_b,  # (E, F)
    proj_w,  # (E, F, D)
    proj_b,  # (E, D)
    capacity_factor: float = 1.25,
    batch_mean=None,
    spmd=None,
    tensor_split: bool = False,
) -> Tuple[Any, Any]:
    """Returns (out (B, S, D), aux_loss scalar f32). The aux loss is Switch's
    ``E * sum_e assign_frac_e * prob_frac_e``. On a mesh, x is this rank's
    batch shard (and context slice) and ``batch_mean`` takes the two
    fractions' means over the shards, so the aux loss is the global batch's;
    the expert weights are this rank's experts (fewer than the router's
    ``E`` over an expert axis), their hidden dim split over the tensor group
    when ``tensor_split``."""
    B, S, D = x.shape
    E, local_e = router_w.shape[1], fc_w.shape[0]
    cdt = x.dtype
    with region("moe.route"):
        r = route(x, router_w, capacity_factor, spmd)
        _count_routes(r.keep)
    C = r.capacity
    first, gate = 0, r.gate
    if local_e < E:  # this rank's experts: their part of every gradient is summed
        first = spmd.ep_rank * local_e
        x, gate = spmd.copy_to_ep(x), spmd.copy_to_ep(gate)
    if tensor_split:
        x = spmd.copy_to_tp(x, True)

    with region("moe.dispatch"):
        dispatch = (
            F.one_hot(r.expert_idx, E)[..., first:first + local_e].to(cdt)[..., None]
            * F.one_hot(r.slot, C).to(cdt)[..., None, :]
            * r.keep[..., None, None].to(cdt)
        )  # (B, S, local_e, C)
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, x).reshape(local_e, B * C, D)

    with region("moe.experts"):
        h = torch.einsum("egd,edf->egf", expert_in, fc_w.to(cdt)) + fc_b.to(cdt)[:, None, :]
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
        if tensor_split:
            h = spmd.row_parallel(h, proj_w.to(cdt), cdt)
        else:
            h = torch.einsum("egf,efd->egd", h, proj_w.to(cdt))
        h = (h + proj_b.to(cdt)[:, None, :]).reshape(local_e, B, C, D)

    with region("moe.combine"):
        combine = dispatch * gate.to(cdt)[..., None, None]
        if local_e < E:
            out = spmd.expert_sum(torch.einsum("bsec,ebcd->bsd", combine.float(), h.float()),
                                  cdt)
        else:
            out = torch.einsum("bsec,ebcd->bsd", combine, h)

    with region("moe.route"):
        assign_frac = F.one_hot(r.expert_idx, E).float().mean((0, 1))  # (E,)
        prob_frac = r.probs.mean((0, 1))  # (E,)
        if batch_mean is not None:
            assign_frac, prob_frac = batch_mean(assign_frac), batch_mean(prob_frac)
        aux = E * torch.sum(assign_frac * prob_frac)
    return out, aux


def init_moe_params(gen, n_layer: int, d_model: int, ff_dim: int, n_experts: int,
                    param_dtype, device, place=None) -> Dict[str, Any]:
    """Stacked per-layer MoE params (router and per-expert FFN weights), drawn
    from the ``torch.Generator`` ``gen`` onto ``device`` (``gen`` None: empty
    leaves, for shapes on the meta device), each through ``place``."""
    std = 0.02
    proj_std = std / math.sqrt(2 * n_layer)
    put = place or (lambda t: t)

    def norm(shape, s):
        if gen is None:
            return put(torch.empty(shape, dtype=param_dtype, device=device))
        return put((torch.randn(shape, generator=gen, device=gen.device) * s)
                   .to(device, param_dtype))

    def zeros(shape):
        return put(torch.zeros(shape, dtype=param_dtype, device=device))

    L, d, F_, E = n_layer, d_model, ff_dim, n_experts
    return {
        "router_w": norm((L, d, E), std),
        "fc_w": norm((L, E, d, F_), std),
        "fc_b": zeros((L, E, F_)),
        "proj_w": norm((L, E, F_, d), proj_std),
        "proj_b": zeros((L, E, d)),
    }


def moe_param_logical_axes() -> Dict[str, Tuple]:
    """Per-leaf logical axes of the MoE params: those of ``ray_tpu/models/moe.py``."""
    return {
        "router_w": ("layers", "embed", None),
        "fc_w": ("layers", "expert", "embed", "mlp"),
        "fc_b": ("layers", "expert", "mlp"),
        "proj_w": ("layers", "expert", "mlp", "embed"),
        "proj_b": ("layers", "expert", "embed"),
    }
