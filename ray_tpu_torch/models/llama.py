"""Llama family in PyTorch: the counterpart of ``ray_tpu/models/llama.py``.

RMSNorm, SwiGLU MLP, rotary position embeddings, grouped-query attention and
an untied LM head, on the same scaffolding as ``models/gpt.py``: the JAX
package's leaf names and stacked ``(L, ...)`` shapes, bf16 products over f32
params, f32 norms and logits, attention through ``ops.flash_attention``.
Grouped-query attention repeats each kv head to the query heads before the
attention call, as the JAX block does; there is no GQA-native kernel. On a
mesh the same code runs on each rank's shards (``parallel/spmd.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.accelerators.gpu import resolve_device
from ray_tpu_torch.models.gpt import _lm_head, _out_product, _weight, lm_head_loss, stage_output
from ray_tpu_torch.models.stack import apply_stack, remat, resolve_attention
from ray_tpu_torch.parallel.spmd import spmd_for


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32  # < n_head = grouped-query attention
    d_model: int = 4096
    d_ff: int = 11008  # SwiGLU hidden dim
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    # As GPTConfig.remat_policy: "save_attn", "dots" or None.
    remat_policy: Optional[str] = "save_attn"
    attention: str = "auto"  # auto | flash | xla

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_head == 0
        return self.d_model // self.n_head

    @property
    def group_size(self) -> int:
        assert self.n_head % self.n_kv_head == 0
        return self.n_head // self.n_kv_head

    # ---- presets ----
    # As in the JAX package, a keyword that names one of a preset's own sizes
    # raises TypeError (a duplicate keyword); a depth cut reads
    # ``dataclasses.replace(LlamaConfig.llama3_8b(), n_layer=4)``.
    @classmethod
    def llama2_7b(cls, **kw):
        return cls(**kw)

    @classmethod
    def llama2_13b(cls, **kw):
        return cls(n_layer=40, n_head=40, n_kv_head=40, d_model=5120, d_ff=13824, **kw)

    @classmethod
    def llama3_8b(cls, **kw):
        return cls(
            vocab_size=128256, n_layer=32, n_head=32, n_kv_head=8,
            d_model=4096, d_ff=14336, max_seq_len=8192, rope_theta=500000.0, **kw
        )

    @classmethod
    def nano(cls, **kw):
        """Tiny GQA config for CPU tests (2 kv heads for 4 q heads)."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_seq_len", 128)
        return cls(n_layer=2, n_head=4, n_kv_head=2, d_model=64, d_ff=128, **kw)


def num_params(config: LlamaConfig) -> int:
    d, L, V, F_ = config.d_model, config.n_layer, config.vocab_size, config.d_ff
    kvd = config.n_kv_head * config.head_dim
    per_layer = (
        d * d            # wq
        + 2 * d * kvd    # wk, wv
        + d * d          # wo
        + 2 * d * F_     # w_gate, w_up
        + F_ * d         # w_down
        + 2 * d          # 2 rmsnorm scales
    )
    return 2 * V * d + L * per_layer + d  # embed + untied head + final norm


def train_flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    attn = 12 * config.n_layer * config.d_model * seq_len
    return 6.0 * num_params(config) + attn


# --------------------------------------------------------------------------- init
def init_params(config: LlamaConfig, seed=0, device=None, place=None) -> Dict[str, Any]:
    """Random Llama params (normal(0.02), output projections scaled by
    1/sqrt(2L), norm scales 1) from ``seed`` (an int or a ``torch.Generator``),
    on ``device`` (``None``: the GPU; raises when there is none; ``"meta"``:
    shapes only), each leaf through ``place`` as in ``gpt.init_params``."""
    device = resolve_device(device)
    d, L, V, F_ = config.d_model, config.n_layer, config.vocab_size, config.d_ff
    nh, nkv, hd = config.n_head, config.n_kv_head, config.head_dim
    std = 0.02
    out_std = std / math.sqrt(2 * L)
    pd = config.param_dtype
    put = place or (lambda t: t)
    if device.type == "meta":
        gen = None
    elif isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=device).manual_seed(int(seed))

    def norm(shape, s):
        if gen is None:
            return put(torch.empty(shape, dtype=pd, device=device))
        return put((torch.randn(shape, generator=gen, device=gen.device) * s).to(device, pd))

    def ones(shape):
        return put(torch.ones(shape, dtype=pd, device=device))

    return {
        "embed": norm((V, d), std),
        "blocks": {
            "attn_norm": ones((L, d)),
            "wq": norm((L, d, nh, hd), std),
            "wk": norm((L, d, nkv, hd), std),
            "wv": norm((L, d, nkv, hd), std),
            "wo": norm((L, nh, hd, d), out_std),
            "mlp_norm": ones((L, d)),
            "w_gate": norm((L, d, F_), std),
            "w_up": norm((L, d, F_), std),
            "w_down": norm((L, F_, d), out_std),
        },
        "final_norm": ones((d,)),
        "lm_head": norm((V, d), std),
    }


def param_logical_axes(config: LlamaConfig) -> Dict[str, Any]:
    """Per-leaf logical axis names: those of ``ray_tpu/models/llama.py``."""
    return {
        "embed": ("vocab", "embed"),
        "blocks": {
            "attn_norm": ("layers", None),
            "wq": ("layers", "embed", "heads", None),
            "wk": ("layers", "embed", "kv_heads", None),
            "wv": ("layers", "embed", "kv_heads", None),
            "wo": ("layers", "heads", None, "embed"),
            "mlp_norm": ("layers", None),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": (None,),
        "lm_head": ("vocab", "embed"),
    }


# --------------------------------------------------------------------------- forward
def _rms_norm(x, scale, eps):
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return xf * rms * scale


def rope_tables(seq_len: int, head_dim: int, theta: float, device=None, offset: int = 0):
    """(S, head_dim/2) f32 cos and sin tables of positions offset ..
    offset+S-1, built once per forward and shared by every layer: the
    sequence streams of the stack, at this context slice's global
    positions."""
    half = head_dim // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32, device=device) / half)
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32, device=device)
    angles = pos[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def _rope(x, cos, sin):
    """Rotary embeddings on x (B, H, S, hd) with f32 tables (S, hd/2): the
    rotation in f32, the result in x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


def _block(x, layer, config: LlamaConfig, attention_fn, cos, sin, sub_remat=False, spmd=None):
    """One Llama block. x: (B, S, D). Returns (x, None): no aux loss.

    With sub_remat ("save_attn"), the qkv/rope and wo/MLP halves are each
    checkpointed while attention between them is not, as in gpt._block; on a
    mesh, weights are gathered and split as there."""
    cdt = config.dtype
    B, S, D = x.shape
    hd, g = config.head_dim, config.group_size

    def proj(h, w):  # "bsd,dnh->bnsh"
        heads = w.shape[1]
        return (h @ w.reshape(D, heads * hd)).view(B, S, heads, hd).transpose(1, 2)

    def qkv_part(x, layer):
        h = _rms_norm(x, layer["attn_norm"], config.norm_eps).to(cdt)
        wq, wk, wv = (_weight(layer, n, cdt, spmd) for n in ("wq", "wk", "wv"))
        nh, nkv = wq.shape[1], wk.shape[1]
        if spmd is not None:
            h = spmd.copy_to_tp(h, nh < config.n_head)
        q = _rope(proj(h, wq), cos, sin)
        k = _rope(proj(h, wk), cos, sin)
        v = proj(h, wv)
        if nkv * g == nh and g > 1:
            # GQA: each kv head serves `group_size` query heads (jnp.repeat).
            k = torch.repeat_interleave(k, g, dim=1)
            v = torch.repeat_interleave(v, g, dim=1)
        elif nkv * g != nh:
            # Query heads split over the tensor group, kv heads whole: this
            # rank's query heads take their own kv heads.
            idx = (spmd.tp_rank * nh + torch.arange(nh, device=k.device)) // g
            k, v = k.index_select(1, idx), v.index_select(1, idx)
        # (B, nh, S, hd), contiguous: the attention kernels take no strides.
        return q.contiguous(), k.contiguous(), v.contiguous()

    def out_mlp_part(x, o, layer):
        nh = o.shape[1]
        wo = _weight(layer, "wo", cdt, spmd).reshape(nh * hd, D)
        x = x + _out_product(o.transpose(1, 2).reshape(B, S, nh * hd), wo, cdt, spmd,
                             nh < config.n_head)
        h = _rms_norm(x, layer["mlp_norm"], config.norm_eps).to(cdt)
        w_gate = _weight(layer, "w_gate", cdt, spmd)
        sharded = w_gate.shape[-1] < config.d_ff
        if spmd is not None:
            h = spmd.copy_to_tp(h, sharded)
        gate = h @ w_gate
        up = h @ _weight(layer, "w_up", cdt, spmd)
        h = F.silu(gate) * up
        return x + _out_product(h, _weight(layer, "w_down", cdt, spmd), cdt, spmd, sharded), None

    if sub_remat:
        q, k, v = remat(qkv_part)(x, layer)
    else:
        q, k, v = qkv_part(x, layer)
    o = resolve_attention(q, k, v, config.attention, attention_fn)  # (B, nh, S, hd)
    if sub_remat:
        return remat(out_mlp_part)(x, o, layer)
    return out_mlp_part(x, o, layer)


def _hidden(params, tokens, config: LlamaConfig, attention_fn, spmd, num_microbatches):
    """The final RMS-normed activations (B, S, D) in ``config.dtype`` on one
    device, or this rank's on a mesh (the last stage's, a 0-dim zero on the
    other stages of a pipeline), and the stack's aux (an f32 scalar)."""
    cdt = config.dtype
    B, S = tokens.shape
    if spmd is None:
        x = F.embedding(tokens, params["embed"].to(cdt))
    elif spmd.first_stage:
        table = spmd.gather(params["embed"].to(cdt), "embed")
        x = spmd.embed(tokens, table, config.vocab_size)
    else:  # the stage's input comes from the previous stage
        x = torch.empty((B, S, config.d_model), dtype=cdt, device=tokens.device)
    offset = 0 if spmd is None else spmd.seq_offset(S)
    streams = rope_tables(S, config.head_dim, config.rope_theta, x.device, offset)
    save_attn = config.remat and config.remat_policy == "save_attn"

    def make_block_fn(attn, mb_idx, streams):
        cos, sin = streams  # this rank's positions

        def block_fn(x, layer, idx):
            return _block(x, layer, config, attn, cos, sin, sub_remat=save_attn, spmd=spmd)

        if config.remat and not save_attn:
            return remat(block_fn, config.remat_policy)
        return block_fn

    x, aux = apply_stack(params["blocks"], x, make_block_fn, n_layer=config.n_layer,
                         attention_fn=attention_fn, spmd=spmd,
                         num_microbatches=num_microbatches, seq_streams=streams)
    if spmd is None or spmd.last_stage:
        x = _rms_norm(x, params["final_norm"], config.norm_eps).to(cdt)
    return x, aux


def _head(params, config: LlamaConfig, spmd):
    head = params["lm_head"].to(config.dtype)
    return head if spmd is None else spmd.gather(head, "lm_head")


def forward(
    params: Dict[str, Any],
    tokens,  # (B, S) int
    config: LlamaConfig,
    attention_fn: Optional[Callable] = None,
    dropout_seed: Optional[int] = None,  # accepted for API parity; Llama uses no dropout
    mesh=None,
    num_microbatches: Optional[int] = None,
    return_aux: bool = False,
):
    """Logits (B, S, vocab) in float32 (with ``return_aux``, a (logits, aux)
    pair, aux the stack's f32 scalar); on a ``mesh``, from DTensor params
    and tokens, a DTensor as ``gpt.forward`` returns."""
    del dropout_seed
    spmd = spmd_for(mesh)
    if spmd is None:
        x, aux = _hidden(params, tokens, config, attention_fn, None, num_microbatches)
        logits = _lm_head(x, _head(params, config, None))
        return (logits, aux) if return_aux else logits
    params, tokens = spmd.local(params), spmd.batch_local(tokens)
    x, aux = _hidden(params, tokens, config, attention_fn, spmd, num_microbatches)
    x = stage_output(x, (*tokens.shape, config.d_model), config.dtype, spmd)
    head = _head(params, config, spmd)
    logits = _lm_head(spmd.copy_to_tp(x, head.shape[0] < config.vocab_size), head)
    logits = spmd.global_batch(logits, config.vocab_size)
    return (logits, aux) if return_aux else logits


def loss_fn(
    params: Dict[str, Any],
    batch: Dict[str, Any],  # {"tokens": (B, S+1)} or {"inputs", "targets"}
    config: LlamaConfig,
    attention_fn: Optional[Callable] = None,
    dropout_seed: Optional[int] = None,
    mesh=None,
    num_microbatches: Optional[int] = None,
):
    """Causal LM cross entropy (mean over tokens; on a mesh, over the global
    batch, the same on every rank)."""
    spmd = spmd_for(mesh)
    if spmd is not None:
        params = spmd.local(params)
        batch = {k: spmd.batch_local(v) for k, v in batch.items()}
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
    else:
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x, _ = _hidden(params, inputs, config, attention_fn, spmd, num_microbatches)
    head = _head(params, config, spmd) if spmd is None or spmd.last_stage else None
    return lm_head_loss(x, head, targets, config.vocab_size, spmd, num_microbatches)
