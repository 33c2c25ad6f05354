"""Flash attention in PyTorch: the counterpart of ``ray_tpu/ops/flash_attention.py``.

Layout is (batch, heads, seq, head_dim), as in the JAX package. Backends:

- ``"flash"`` (the default): ``_FlashBHSD``, an autograd function whose forward
  and backward are the hand-written CUDA kernels of ``csrc/flash_attention.cu``
  on a CUDA tensor (bf16: ``wgmma`` fed by TMA; f32: the CUDA cores), and
  their plain PyTorch versions (``_fwd_plain``, ``_bwd_plain``) on a CPU
  tensor. On CUDA it launches the kernel or raises.
- ``"xla"``: ``xla_attention``, plain attention on the full score matrix.
- ``"blockwise"``: ``blockwise_attention``, an exact O(S * block_k)-memory loop
  over K blocks.

The forward saves (q, k, v, o, lse), so the backward never re-runs it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The reference's Pallas tile defaults, kept for its signature only.
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024


# --------------------------------------------------------------------------- plain attention
def _causal_mask(qlen: int, klen: int, device) -> torch.Tensor:
    return torch.ones((qlen, klen), dtype=torch.bool, device=device).tril(klen - qlen)


def xla_attention(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """Plain attention on the full score matrix (O(S^2) memory). Products take
    the inputs' values and accumulate in f32, as ``preferred_element_type=f32``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[-2], s.shape[-1], s.device), NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def blockwise_attention(q, k, v, causal: bool = True, sm_scale: Optional[float] = None,
                        block_k: int = 1024):
    """Exact attention as a loop over K blocks with an online softmax, each step
    checkpointed, so memory is O(S * block_k). Sequences that ``block_k`` does not
    divide go to ``xla_attention``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    B, H, S, D = q.shape
    if S % block_k:
        return xla_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    qf = q.float()
    row = torch.arange(S, device=q.device)[:, None]

    def body(m_prev, l_prev, acc, kblk, vblk, j):
        s = torch.matmul(qf, kblk.float().transpose(-1, -2)) * sm_scale
        if causal:
            col = j * block_k + torch.arange(block_k, device=q.device)[None, :]
            s = s.masked_fill(~(row >= col), NEG_INF)
        m_new = torch.maximum(m_prev, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_prev - m_new)
        l_new = l_prev * alpha + p.sum(-1)
        acc_new = acc * alpha[..., None] + torch.matmul(p, vblk.float())
        return m_new, l_new, acc_new

    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    for j in range(S // block_k):
        blk = slice(j * block_k, (j + 1) * block_k)
        m, l, acc = checkpoint(body, m, l, acc, k[:, :, blk], v[:, :, blk], j,
                               use_reentrant=False)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


# --------------------------------------------------------------------------- plain kernel versions
def _scaled_q(q, sm_scale):
    """q pre-scaled and rounded to its own type, as the kernels stage it."""
    return (q.float() * sm_scale).to(q.dtype).float()


def _fwd_plain(q, k, v, causal: bool, sm_scale: float):
    """Plain version of the forward kernel on (bh, S, D): returns (o, lse)."""
    s = torch.matmul(_scaled_q(q, sm_scale), k.float().transpose(-1, -2))
    if causal:
        s = s.masked_fill(~_causal_mask(s.shape[-2], s.shape[-1], s.device), NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1).clamp_min(1e-30)
    o = torch.matmul(p.to(q.dtype).float(), v.float()) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


def _delta(o, do):
    """rowsum(dO * O) in f32, taken outside the backward kernel as on the TPU."""
    return (do.float() * o.float()).sum(-1)


def _bwd_plain(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    """Plain version of the backward kernel on (bh, S, D): textbook formulas on
    the full S x S matrix. Returns (dq, dk, dv)."""
    dt = q.dtype
    s = torch.matmul(_scaled_q(q, sm_scale), k.float().transpose(-1, -2))
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_mask(s.shape[-2], s.shape[-1], s.device), 0.0)
    dof = do.float()
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = (p * (dp - _delta(o, do)[..., None]) * sm_scale).to(dt).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


# --------------------------------------------------------------------------- CUDA kernel wrappers
def _lib():
    from ray_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    if lib.flash_fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [ctypes.c_float, ptr]
        lib.flash_bwd.argtypes = [ptr] * 10 + [i32] * 5 + [ctypes.c_float, ptr]
        lib.flash_fwd.restype = lib.flash_bwd.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor, got strides {t.stride()}")


def _check_qkv(q, k, v):
    if q.dim() != 3:
        raise ValueError(f"q: expected (bh, S, D), got shape {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q: dtype {q.dtype} not in {list(_DTYPE_CODES)}")
    bh, seq, d = q.shape
    if d not in HEAD_DIMS or seq < 1:
        raise ValueError(f"q: head_dim must be one of {HEAD_DIMS} and seq >= 1, got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, q.shape)
    return bh, seq, d


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check_aligned(**tensors):
    """The bf16 kernels read and write by TMA, which takes 16-byte aligned
    addresses: raise on any other (a view at an odd offset), never copy."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer {t.data_ptr():#x} is not 16-byte aligned")


# flash_fwd / flash_bwd return 0, a cudaError_t, or this base plus a CUresult
# from encoding a TMA tensor map (csrc/flash_attention.cu).
_CU_RESULT_BASE = 100000


def _raise_on(err, name):
    if err >= _CU_RESULT_BASE:
        raise RuntimeError(f"{name}: encoding a TMA tensor map failed: CUresult {err - _CU_RESULT_BASE}")
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    """Launch the forward kernel on (bh, S, D) CUDA tensors: returns (o, lse)."""
    bh, seq, d = _check_qkv(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, seq), dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:
        _check_aligned(q=q, k=k, v=v, o=o)
    with torch.cuda.device(q.device):
        err = _lib().flash_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), bh, seq, d,
            _DTYPE_CODES[q.dtype], int(causal), sm_scale, _stream(q),
        )
    _raise_on(err, "flash_fwd")
    _fwd_cuda.launches += 1
    return o, lse


def _bwd_cuda(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """Launch the backward kernels on (bh, S, D) CUDA tensors: returns (dq, dk, dv).

    In bf16 the kernel adds each K tile's share of dq into an f32 sum,
    ``dq_accum``, in no fixed order, and rounds it into dq once; dk and dv are
    bit-reproducible, dq's low bits may vary between runs."""
    bh, seq, d = _check_qkv(q, k, v)
    _check("do", do, q.dtype, q.shape)
    _check("lse", lse, torch.float32, (bh, seq))
    _check("delta", delta, torch.float32, (bh, seq))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_accum = None
    if q.dtype == torch.bfloat16:
        dq_accum = torch.zeros((bh, seq, d), dtype=torch.float32, device=q.device)
        _check_aligned(q=q, k=k, v=v, do=do, dq=dq, dk=dk, dv=dv, dq_accum=dq_accum)
    with torch.cuda.device(q.device):
        err = _lib().flash_bwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(dq), _ptr(dk), _ptr(dv), None if dq_accum is None else _ptr(dq_accum),
            bh, seq, d, _DTYPE_CODES[q.dtype], int(causal), sm_scale, _stream(q),
        )
    _raise_on(err, "flash_bwd")
    _bwd_cuda.launches += 1
    return dq, dk, dv


_fwd_cuda.launches = 0
_bwd_cuda.launches = 0


def launch_counts():
    """Launches of each kernel wrapper since the last ``reset_launch_counts``."""
    return {"flash_fwd": _fwd_cuda.launches, "flash_bwd": _bwd_cuda.launches}


def reset_launch_counts():
    _fwd_cuda.launches = 0
    _bwd_cuda.launches = 0


def _on_cpu(t) -> bool:
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"flash attention runs on CUDA or CPU tensors, got {t.device}")


def _fwd(q, k, v, causal, sm_scale):
    if _on_cpu(q):
        return _fwd_plain(q, k, v, causal, sm_scale)
    return _fwd_cuda(q, k, v, causal, sm_scale)


def _bwd(q, k, v, o, lse, do, causal, sm_scale):
    if _on_cpu(q):
        return _bwd_plain(q, k, v, o, lse, do, causal, sm_scale)
    return _bwd_cuda(q, k, v, do, lse, _delta(o, do), causal, sm_scale)


# --------------------------------------------------------------------------- public entry
class _FlashBHSD(torch.autograd.Function):
    """Flash attention on (bh, S, D); saves (q, k, v, o, lse) for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o, lse = _fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # The incoming gradient may arrive as a strided view of a transpose;
        # the kernel takes a (bh, S, D) contiguous layout.
        dq, dk, dv = _bwd(q, k, v, o, lse, do.contiguous(), ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(
    q,
    k,
    v,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    backend: Optional[str] = None,
    interpret: bool = False,
):
    """Multi-head attention, (batch, heads, seq, head_dim) layout.

    backend: "flash" (the default) | "xla" | "blockwise". "flash" runs the CUDA
    kernels on CUDA tensors at any seq length, and their plain versions on CPU
    tensors. q, k and v must be contiguous. ``block_q``, ``block_k`` and
    ``interpret`` are the reference's Pallas knobs, taken in its positions
    and ignored: the CUDA kernels fix their own tiles.
    """
    del block_q, block_k, interpret
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    backend = backend or "flash"
    if backend == "xla":
        return xla_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if backend == "blockwise":
        return blockwise_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if backend != "flash":
        raise ValueError(f"unknown attention backend {backend!r}")
    b, h, s, d = q.shape
    flat = lambda x: x.view(b * h, s, d)  # noqa: E731 - a view: raises on a strided input
    o = _FlashBHSD.apply(flat(q), flat(k), flat(v), causal, float(sm_scale))
    return o.view(b, h, s, d)
