"""Ring and Ulysses attention over the ``context`` mesh axis: the counterpart
of ``ray_tpu/parallel/ring_attention.py``.

Each rank of the context group holds a contiguous slice of every sequence
(``s_local`` positions, rank r the r-th slice) and its q, k and v, laid out
(batch, heads, s_local, head_dim).

- ``ring_attention``: K/V slices go around the ring; at step ``step`` a rank
  holds the slice of rank ``(my - step) mod n``. Each block runs through the
  flash kernels (``ops/flash_attention.py::_fwd``): causal on the diagonal
  block, non-causal on a past block, and a future block is skipped under
  causal masking, as the reference's ``lax.cond`` skips it. The blocks'
  ``(o, lse)`` pairs merge into the global ``o`` and ``lse`` in f32, rounded
  once to q's dtype. The backward runs ``_bwd`` on each block with the
  global ``o`` and ``lse``, sums dq in f32, and sends each block's dk and dv
  accumulators (f32) around the ring with the block, so after n steps they
  reach the rank that owns it. The next rotation is started before a block's
  kernels, so it may overlap them.
- ``ring_attention_plain``: the reference's f32 einsum ring with an online
  softmax, differentiated by autograd through ``ppermute``. The tests and
  the card's check hold the kernel ring against it. It computes the masked
  future blocks instead of skipping them (the same values): every rank's
  autograd graph then holds the same rotations, so each rotation's backward
  finds its partner.
- ``ulysses_attention``: all-to-all from sequence slices to head groups, the
  flash kernels on the local heads over the whole sequence, and back. The
  JAX version calls plain attention there; the port's ``"auto"`` means the
  kernel (ROADMAP.md Queue 3).

The block loop and merge (``ring_forward``, ``ring_backward``) take the
ranks they run for and a ``rotate`` callable, so the same code runs one rank
of a process group (``GroupRing``) or every rank of a virtual ring in one
process (``VirtualRing``, the card's check at full size without a gang).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.flash_attention import _bwd, _fwd, flash_attention
from ray_tpu_torch.parallel.spmd import P2P, all_to_all, ppermute

NEG_INF = -1e30


# --------------------------------------------------------------------------- rotations
# A rotation takes one tuple of tensors per rank it runs for, moves each
# rank's tuple to the next rank, and returns a function that waits for the
# move and gives the tuples each rank now holds.
class VirtualRing:
    """The ring's rotation over all n slices held in one process."""

    def __call__(self, items: List[tuple]):
        return lambda: items[-1:] + items[:-1]


class GroupRing:
    """The ring's rotation for this rank of ``group``: its tuple goes to rank
    ``my + 1`` and rank ``my - 1``'s arrives, both started at once."""

    def __init__(self, group):
        self.group = group
        self.n, self.my = dist.get_world_size(group), dist.get_rank(group)

    def __call__(self, items: List[tuple]):
        (tensors,) = items
        nxt, prev = (self.my + 1) % self.n, (self.my - 1) % self.n
        p2p = P2P([(t, nxt) for t in tensors], [(t, prev) for t in tensors], self.group)
        return lambda: [tuple(p2p.wait())]


# --------------------------------------------------------------------------- the block loop
def _merge(acc, lse, o_b, lse_b):
    """Fold one block's normalized output and log-sum-exp into the f32
    accumulators (``acc`` updated in place)."""
    if acc is None:
        return o_b.float(), lse_b
    new = torch.logaddexp(lse, lse_b)
    acc.mul_(torch.exp(lse - new)[..., None])
    acc.addcmul_(o_b, torch.exp(lse_b - new)[..., None])
    return acc, new


def ring_forward(qs, ks, vs, ranks: Sequence[int], n: int, causal: bool, sm_scale: float,
                 rotate: Callable):
    """The ring's forward for the ranks in ``ranks`` of a ring of ``n``: their
    q, k, v slices (bh, s_local, d) in ``qs``, ``ks``, ``vs``. Returns their
    outputs (q's dtype) and f32 log-sum-exps (bh, s_local)."""
    accs: List = [None] * len(ranks)
    lses: List = [None] * len(ranks)
    for step in range(n):
        pending = rotate(list(zip(ks, vs))) if step < n - 1 else None
        for i, my in enumerate(ranks):
            src = (my - step) % n
            if causal and src > my:
                continue
            o_b, lse_b = _fwd(qs[i], ks[i], vs[i], causal and src == my, sm_scale)
            accs[i], lses[i] = _merge(accs[i], lses[i], o_b, lse_b)
        if pending is not None:
            ks, vs = (list(t) for t in zip(*pending()))
    return [a.to(q.dtype) for a, q in zip(accs, qs)], lses


def ring_backward(qs, ks, vs, os_, lses, dos, ranks: Sequence[int], n: int, causal: bool,
                  sm_scale: float, rotate: Callable):
    """The ring's backward for the ranks in ``ranks``, from the global ``o``
    and ``lse`` of ``ring_forward`` and the output gradients ``dos``. Returns
    their dq, dk, dv (the inputs' dtype), each summed in f32."""
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dks = [torch.zeros_like(dq) for dq in dqs]
    dvs = [torch.zeros_like(dq) for dq in dqs]
    for step in range(n):
        pending = rotate(list(zip(ks, vs))) if step < n - 1 else None
        for i, my in enumerate(ranks):
            src = (my - step) % n
            if causal and src > my:
                continue
            dq, dk, dv = _bwd(qs[i], ks[i], vs[i], os_[i], lses[i], dos[i],
                              causal and src == my, sm_scale)
            dqs[i].add_(dq)
            dks[i].add_(dk)
            dvs[i].add_(dv)
        if n > 1:
            # The accumulators travel with their block: after the n-th step
            # each is back at the rank that owns it.
            dks, dvs = (list(t) for t in zip(*rotate(list(zip(dks, dvs)))()))
        if pending is not None:
            ks, vs = (list(t) for t in zip(*pending()))
    dt = qs[0].dtype
    return ([t.to(dt) for t in dqs], [t.to(dt) for t in dks], [t.to(dt) for t in dvs])


def _flat(x):
    b, h, s, d = x.shape
    return x.reshape(b * h, s, d)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        rotate = GroupRing(group)
        ctx.ring = (rotate, causal, sm_scale, q.shape)
        q2, k2, v2 = _flat(q.contiguous()), _flat(k.contiguous()), _flat(v.contiguous())
        (o,), (lse,) = ring_forward([q2], [k2], [v2], [rotate.my], rotate.n, causal, sm_scale,
                                    rotate)
        ctx.save_for_backward(q2, k2, v2, o, lse)
        return o.view(q.shape)

    @staticmethod
    def backward(ctx, do):
        rotate, causal, sm_scale, shape = ctx.ring
        q, k, v, o, lse = ctx.saved_tensors
        (dq,), (dk,), (dv,) = ring_backward([q], [k], [v], [o], [lse],
                                            [_flat(do.contiguous())], [rotate.my], rotate.n,
                                            causal, sm_scale, rotate)
        return dq.view(shape), dk.view(shape), dv.view(shape), None, None, None


def ring_attention(q, k, v, group, causal: bool = True, sm_scale: Optional[float] = None):
    """Exact attention over the sequence split across ``group`` (this rank's
    slices q, k, v: (batch, heads, s_local, head_dim)), through the flash
    kernels; returns this rank's output slice."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, group, causal, float(sm_scale))


def plain_ring(q, k, v, my: int, n: int, causal: bool, sm_scale: float, rotate: Callable):
    """The reference's ring for rank ``my`` of ``n`` in f32 einsums, on its
    slices (..., s_local, d); ``rotate(step, k, v)`` gives the K/V slices it
    holds at step + 1. Differentiable by autograd."""
    s_local = q.shape[-2]
    qf = q.float()
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    pos = torch.arange(s_local, device=q.device)
    for step in range(n):
        src = (my - step) % n
        s = torch.einsum("...qd,...kd->...qk", qf, k.float()) * sm_scale
        if causal:
            keep = (my * s_local + pos)[:, None] >= (src * s_local + pos)[None, :]
            s = s.masked_fill(~keep, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("...qk,...kd->...qd", p, v.float())
        m = m_new
        if step < n - 1:
            k, v = rotate(step, k, v)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def ring_attention_plain(q, k, v, group, causal: bool = True,
                         sm_scale: Optional[float] = None):
    """The reference's ring (``plain_ring``) over ``group``, the K/V slices
    rotated by ``ppermute``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    n, my = dist.get_world_size(group), dist.get_rank(group)
    perm = [(i, (i + 1) % n) for i in range(n)]

    def rotate(step, k, v):
        return ppermute(k, perm, group), ppermute(v, perm, group)

    return plain_ring(q, k, v, my, n, causal, float(sm_scale), rotate)


def ring_attention_sharded(mesh, q, k, v, causal: bool = True,
                           sm_scale: Optional[float] = None):
    """``ring_attention`` on DTensors (batch, heads, seq, head_dim) over
    ``mesh``: batch over (data, fsdp), the sequence over context; full
    tensors are distributed so first. Returns a DTensor placed alike."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.mesh import distribute, spec_placements

    placements = spec_placements((("data", "fsdp"), None, "context", None))
    q, k, v = (x if isinstance(x, DTensor) else distribute(x, mesh, placements)
               for x in (q, k, v))
    o = ring_attention(q.to_local(), k.to_local(), v.to_local(), mesh.get_group("context"),
                       causal, sm_scale)
    return DTensor.from_local(o, mesh, q.placements, run_check=False, shape=q.shape,
                              stride=q.stride())


def ulysses_attention(q, k, v, group, causal: bool = True, sm_scale: Optional[float] = None):
    """Sequence parallelism by head groups: (b, h, s/n, d) slices become
    (b, h/n, s, d) head groups by all-to-all, the flash kernels attend over
    the whole sequence on the local heads, and an all-to-all brings the
    output back to (b, h, s/n, d). Needs ``h % n == 0``."""
    n = dist.get_world_size(group)
    if q.shape[1] % n:
        raise ValueError(f"ulysses_attention: {q.shape[1]} heads do not split over {n} ranks")
    qh, kh, vh = (all_to_all(x, 1, 2, group).contiguous() for x in (q, k, v))
    oh = flash_attention(qh, kh, vh, causal=causal, sm_scale=sm_scale)
    return all_to_all(oh, 2, 1, group)


__all__ = ["GroupRing", "VirtualRing", "plain_ring", "ring_attention", "ring_attention_plain",
           "ring_attention_sharded", "ring_backward", "ring_forward", "ulysses_attention"]
