"""GPT-2 family in PyTorch: the counterpart of ``ray_tpu/models/gpt.py``.

Params are a plain dict of tensors with the JAX package's leaf names and
shapes: per-layer params stacked on a leading ``(L, ...)`` dim under
``"blocks"``, so ``models/convert.py`` carries a JAX pytree across unchanged.
Activations and matmuls run in ``config.dtype`` (bf16 in training), params,
layernorm and logits in f32. Attention is ``ops.flash_attention``: the CUDA
kernels on the GPU, their plain versions on the CPU. On a mesh the same code
runs on each rank's shards (``parallel/spmd.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.accelerators.gpu import resolve_device
from ray_tpu_torch.models import moe
from ray_tpu_torch.models.stack import apply_stack, remat, resolve_attention
from ray_tpu_torch.ops.basic import HeadF32, causal_lm_loss, fold_seed
from ray_tpu_torch.parallel.spmd import fold_batch_index, spmd_for


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # 50257 padded up to a multiple of 128
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 0  # 0 -> 4 * d_model
    max_seq_len: int = 1024
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    # None recomputes the whole block; "dots" saves the weight products'
    # outputs across the block's checkpoint and recomputes the rest, attention
    # included; "save_attn" checkpoints the qkv projection and the
    # out-proj/MLP half but keeps attention out of the recompute, so the
    # forward kernel runs once per layer per step and the backward reads the
    # saved (q, k, v, o, lse).
    remat_policy: Optional[str] = "save_attn"
    attention: str = "auto"  # auto | flash | xla
    dropout: float = 0.0
    # > 0 replaces every block's dense MLP with a Switch (top-1) MoE of this
    # many experts (models/moe.py).
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_head == 0
        return self.d_model // self.n_head

    # ---- presets ----
    @classmethod
    def gpt2_small(cls, **kw):
        return cls(n_layer=12, n_head=12, d_model=768, **kw)

    @classmethod
    def gpt2_medium(cls, **kw):
        return cls(n_layer=24, n_head=16, d_model=1024, **kw)

    @classmethod
    def gpt2_large(cls, **kw):
        return cls(n_layer=36, n_head=20, d_model=1280, **kw)

    @classmethod
    def gpt2_xl(cls, **kw):
        return cls(n_layer=48, n_head=25, d_model=1600, **kw)

    @classmethod
    def nano(cls, **kw):
        """Tiny config for CPU tests."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_seq_len", 128)
        return cls(n_layer=2, n_head=2, d_model=64, **kw)


def num_params(config: GPTConfig) -> int:
    d, L, V, F_ = config.d_model, config.n_layer, config.vocab_size, config.ff_dim
    E = config.moe_experts
    if E:
        mlp = d * E + E * (d * F_ + F_ + F_ * d + d)  # router + per-expert FFNs
    else:
        mlp = d * F_ + F_ + F_ * d + d
    per_layer = (
        3 * d * d + 3 * d  # qkv
        + d * d + d        # attn out
        + mlp
        + 4 * d            # 2 layernorms
    )
    return V * d + config.max_seq_len * d + L * per_layer + 2 * d


def train_flops_per_token(config: GPTConfig, seq_len: int) -> float:
    """6*N matmul flops + attention term, the standard MFU accounting (the tied
    wte counted once)."""
    attn = 12 * config.n_layer * config.d_model * seq_len  # fwd+bwd qk+pv
    return 6.0 * num_params(config) + attn



# --------------------------------------------------------------------------- init
def init_params(config: GPTConfig, seed=0, device=None, place=None) -> Dict[str, Any]:
    """Random GPT-2 params (normal(0.02), residual projections scaled by
    1/sqrt(2L)) from ``seed`` (an int or a ``torch.Generator``), on ``device``
    (``None``: the GPU; raises when there is none; ``"meta"``: shapes only).
    ``place(leaf)``, when given, takes each leaf as it is drawn and returns
    what the tree keeps (a sharded init keeps this rank's shard)."""
    device = resolve_device(device)
    d, L, V, F_ = config.d_model, config.n_layer, config.vocab_size, config.ff_dim
    nh, hd = config.n_head, config.head_dim
    std = 0.02
    proj_std = std / math.sqrt(2 * L)  # GPT-2 residual-scaled init
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

    def const(shape, value):
        return put(torch.full(shape, value, dtype=pd, device=device))

    blocks = {
        "ln1_scale": const((L, d), 1.0),
        "ln1_bias": const((L, d), 0.0),
        "qkv_w": norm((L, d, 3, nh, hd), std),
        "qkv_b": const((L, 3, nh, hd), 0.0),
        "out_w": norm((L, nh, hd, d), proj_std),
        "out_b": const((L, d), 0.0),
        "ln2_scale": const((L, d), 1.0),
        "ln2_bias": const((L, d), 0.0),
    }
    if config.moe_experts:
        blocks["moe"] = moe.init_moe_params(gen, L, d, F_, config.moe_experts, pd, device, put)
    else:
        blocks.update({
            "fc_w": norm((L, d, F_), std),
            "fc_b": const((L, F_), 0.0),
            "proj_w": norm((L, F_, d), proj_std),
            "proj_b": const((L, d), 0.0),
        })
    return {
        "wte": norm((V, d), std),
        "wpe": norm((config.max_seq_len, d), std),
        "blocks": blocks,
        "lnf_scale": const((d,), 1.0),
        "lnf_bias": const((d,), 0.0),
    }


def param_logical_axes(config: GPTConfig) -> Dict[str, Any]:
    """Per-leaf logical axis names, consumed by ``parallel.ShardingRules``:
    those of ``ray_tpu/models/gpt.py``."""
    blocks = {
        "ln1_scale": ("layers", None),
        "ln1_bias": ("layers", None),
        "qkv_w": ("layers", "embed", None, "heads", None),
        "qkv_b": ("layers", None, "heads", None),
        "out_w": ("layers", "heads", None, "embed"),
        "out_b": ("layers", None),
        "ln2_scale": ("layers", None),
        "ln2_bias": ("layers", None),
    }
    if config.moe_experts:
        blocks["moe"] = moe.moe_param_logical_axes()
    else:
        blocks.update(
            {
                "fc_w": ("layers", "embed", "mlp"),
                "fc_b": ("layers", "mlp"),
                "proj_w": ("layers", "mlp", "embed"),
                "proj_b": ("layers", None),
            }
        )
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "blocks": blocks,
        "lnf_scale": (None,),
        "lnf_bias": (None,),
    }


# --------------------------------------------------------------------------- forward
def _layer_norm(x, scale, bias, eps=1e-5):
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _dropout(x, rate: float, seed: Optional[int]):
    """Inverted dropout with a mask drawn from a generator seeded by ``seed``,
    so a checkpointed block redraws the same mask when it recomputes."""
    if seed is None or rate <= 0.0:
        return x
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0).to(x.dtype)


def _lm_head(x, w):
    """Logits (..., V) in f32 from x (..., d) and the tied embedding w (V, d)."""
    if x.dtype == torch.float32:
        return x @ w.t()
    return HeadF32.apply(x.reshape(-1, x.shape[-1]), w).view(*x.shape[:-1], w.shape[0])


def _weight(layer, name, cdt, spmd):
    """Leaf ``name`` of ``layer`` in ``cdt``, whole over ``fsdp`` on a mesh
    (cast first, so the gather moves ``cdt`` bytes)."""
    w = layer[name].to(cdt)
    return w if spmd is None else spmd.gather(w, name)


def _out_product(a, w, cdt, spmd, sharded: bool):
    """``a @ w``; row-parallel across the tensor group when ``sharded``."""
    return spmd.row_parallel(a, w, cdt) if sharded else a @ w


def _block(x, layer, config: GPTConfig, attention_fn, drop_seed=None, sub_remat=False,
           spmd=None):
    """One transformer block. x: (B, S, D) in config.dtype. Returns (x, aux):
    aux is the MoE load-balancing loss (None when dense).

    With sub_remat ("save_attn"), the qkv projection and the out-proj/MLP half
    are each checkpointed while the attention call between them is not: its
    residuals are saved, so the backward never re-runs the forward kernel.

    On a mesh (``spmd``), x and ``layer`` are this rank's shards: weights are
    gathered over ``fsdp`` inside each checkpointed half, and heads and the
    MLP's hidden dim run tensor-parallel where ``ShardingRules`` split them
    (the local weight is narrower than the config's)."""
    cdt = config.dtype
    B, S, D = x.shape
    hd = config.head_dim
    s1 = s2 = None
    if drop_seed is not None and config.dropout > 0:
        s1, s2 = fold_seed(drop_seed, 1), fold_seed(drop_seed, 2)

    def qkv_part(x, layer):
        h = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"]).to(cdt)
        qkv_w = _weight(layer, "qkv_w", cdt, spmd)  # (D, 3, nh_local, hd)
        nh = qkv_w.shape[2]
        if spmd is not None:
            h = spmd.copy_to_tp(h, nh < config.n_head)
        qkv = (h @ qkv_w.reshape(D, 3 * nh * hd)).view(B, S, 3, nh, hd)
        qkv = qkv + layer["qkv_b"].to(cdt)
        # (B, nh, S, hd), contiguous: the attention kernels take no strides.
        return tuple(qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))

    def out_mlp_part(x, o, layer):
        nh = o.shape[1]
        out_w = _weight(layer, "out_w", cdt, spmd).reshape(nh * hd, D)
        o = _out_product(o.transpose(1, 2).reshape(B, S, nh * hd), out_w, cdt, spmd,
                         nh < config.n_head)
        x = x + _dropout(o + layer["out_b"].to(cdt), config.dropout, s1)
        h = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"]).to(cdt)
        aux = None
        if config.moe_experts:
            m = {k: _weight(layer["moe"], k, cdt if k != "router_w" else v.dtype, spmd)
                 for k, v in layer["moe"].items()}
            h, aux = moe.moe_mlp(h, m["router_w"], m["fc_w"], m["fc_b"], m["proj_w"],
                                 m["proj_b"], capacity_factor=config.moe_capacity_factor,
                                 batch_mean=_moe_batch_mean(spmd), spmd=spmd,
                                 tensor_split=m["fc_w"].shape[-1] < config.ff_dim)
        else:
            fc_w = _weight(layer, "fc_w", cdt, spmd)  # (D, F_local)
            sharded = fc_w.shape[-1] < config.ff_dim
            if spmd is not None:
                h = spmd.copy_to_tp(h, sharded)
            h = h @ fc_w + layer["fc_b"].to(cdt)
            h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
            h = _out_product(h, _weight(layer, "proj_w", cdt, spmd), cdt, spmd, sharded)
            h = h + layer["proj_b"].to(cdt)
        return x + _dropout(h, config.dropout, s2), aux

    if sub_remat:
        q, k, v = remat(qkv_part)(x, layer)
    else:
        q, k, v = qkv_part(x, layer)
    o = resolve_attention(q, k, v, config.attention, attention_fn)  # (B, nh, S, hd)
    if sub_remat:
        return remat(out_mlp_part)(x, o, layer)
    return out_mlp_part(x, o, layer)


def _moe_batch_mean(spmd):
    """The mean of the router's fractions over the tokens a microbatch spans:
    the batch shards' and context slices' (all-reduced) off a pipeline; on a
    pipeline a microbatch lies on one batch shard (``parallel/pipeline.py``),
    so over its context slices only."""
    if spmd is None:
        return None
    return spmd.batch_mean if spmd.pp == 1 else spmd.context_mean


def lm_head_loss(x, head, targets, vocab: int, spmd, num_microbatches=None):
    """The mean cross entropy of the logits ``x @ head.T`` (f32) against
    ``targets``, over the global batch on a mesh. On a pipeline, ``x`` is the
    last stage's output (the others pass their 0-dim zero): the last stage
    takes the head and loss microbatch by microbatch, each under activation
    checkpointing (a row of Llama 3 8B's f32 logits is 4.2 GB), and the loss
    is summed over the pipeline group, so every stage holds it and each
    stage's backward runs."""

    def ce(xc, tc):
        if spmd is not None:
            xc = spmd.copy_to_tp(xc, head.shape[0] < vocab)
        logits = _lm_head(xc, head)
        return causal_lm_loss(logits, tc) if spmd is None else spmd.token_ce(logits, tc, vocab)

    if spmd is None:
        return ce(x, targets)
    if spmd.pp == 1:
        return spmd.batch_mean(ce(x, targets))
    if not spmd.last_stage:
        return spmd.stage_sum(x)
    from torch.utils.checkpoint import checkpoint

    from ray_tpu_torch.parallel.pipeline import microbatches

    m = microbatches(spmd, x.shape[0], num_microbatches)[1]
    parts = [checkpoint(ce, xc, tc, use_reentrant=False)
             for xc, tc in zip(x.chunk(m), targets.chunk(m))]
    return spmd.stage_sum(spmd.batch_mean(torch.stack(parts).mean()))


def stage_output(x, shape, dtype, spmd):
    """The last stage's output (``shape``, ``dtype``) on every stage of a
    pipeline (the evaluation path: each stage then takes the head itself)."""
    if spmd is None or spmd.pp == 1:
        return x
    if not spmd.last_stage:  # zeros, through which the stage's backward is reached
        x = torch.zeros(shape, dtype=dtype, device=x.device) + x.to(dtype)
    return spmd.stage_sum(x)


def _hidden(params, tokens, config: GPTConfig, attention_fn, dropout_seed, spmd,
            num_microbatches):
    """The final layer-normed activations (B, S, D) in ``config.dtype`` and
    the MoE aux loss, from params and tokens on one device, or from this
    rank's shards on a mesh (the last stage's, and a 0-dim zero on the other
    stages of a pipeline; the tokens this rank's slice of each sequence
    under context parallelism). Returns (x, aux, the tied head weight in
    ``config.dtype``, whole over fsdp on the first and last stages)."""
    B, S = tokens.shape
    cdt = config.dtype
    wte = params["wte"].to(cdt)
    if spmd is None:
        x = F.embedding(tokens, wte) + params["wpe"].to(cdt)[:S][None]
    else:
        if config.moe_experts % spmd.ep:
            # ShardingRules would replicate the experts instead of splitting them.
            raise ValueError(f"{config.moe_experts} experts do not split over an expert axis "
                             f"of {spmd.ep}")
        dropout_seed = fold_batch_index(dropout_seed, spmd)
        if spmd.first_stage or spmd.last_stage:
            wte = spmd.gather(wte, "wte")
        if spmd.first_stage:
            # Positions at this context slice's global offset.
            off = spmd.seq_offset(S)
            wpe = spmd.gather(params["wpe"].to(cdt), "wpe")
            x = spmd.embed(tokens, wte, config.vocab_size) + wpe[off:off + S][None]
        else:  # the stage's input comes from the previous stage
            x = torch.empty((B, S, config.d_model), dtype=cdt, device=tokens.device)
    use_dropout = dropout_seed is not None and config.dropout > 0
    layers_seed = None
    if use_dropout:
        if spmd is None or spmd.first_stage:
            x = _dropout(x, config.dropout, fold_seed(dropout_seed, 0))
        layers_seed = fold_seed(dropout_seed, 1)

    save_attn = config.remat and config.remat_policy == "save_attn"

    def make_block_fn(attn, mb_idx, streams):
        def block_fn(x, layer, idx):
            seed = None
            if use_dropout:
                seed = fold_seed(layers_seed, idx)
                if mb_idx is not None:  # a mask of its own per microbatch
                    seed = fold_seed(seed, mb_idx)
            return _block(x, layer, config, attn, seed, sub_remat=save_attn, spmd=spmd)

        if config.remat and not save_attn:
            return remat(block_fn, config.remat_policy)
        return block_fn

    x, moe_aux = apply_stack(params["blocks"], x, make_block_fn, n_layer=config.n_layer,
                             attention_fn=attention_fn, spmd=spmd,
                             num_microbatches=num_microbatches)
    if spmd is None or spmd.last_stage:
        x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"]).to(cdt)
    return x, moe_aux, wte


def forward(
    params: Dict[str, Any],
    tokens,  # (B, S) int
    config: GPTConfig,
    attention_fn: Optional[Callable] = None,
    dropout_seed: Optional[int] = None,
    mesh=None,
    return_aux: bool = False,
    num_microbatches: Optional[int] = None,
):
    """Returns logits (B, S, vocab) in float32 (with ``return_aux``, a
    (logits, moe_aux_loss) pair). Pass ``dropout_seed`` to enable dropout
    (training); omit it for deterministic eval. On a ``mesh`` (a
    ``DeviceMesh``), params and tokens are DTensors (``create_train_state``,
    ``shard_batch``) and the logits a DTensor: batch over (data, fsdp), the
    sequence over context, vocab over tensor. With ``pipeline > 1`` the
    stack runs as a GPipe of ``num_microbatches`` (default 2P if it divides
    the batch, else P), and every stage takes the head of the last stage's
    output."""
    spmd = spmd_for(mesh)
    if spmd is not None:
        params, tokens = spmd.local(params), spmd.batch_local(tokens)
    x, moe_aux, wte = _hidden(params, tokens, config, attention_fn, dropout_seed, spmd,
                              num_microbatches)
    if spmd is None:
        logits = _lm_head(x, wte)
    else:
        if not (spmd.first_stage or spmd.last_stage):  # _hidden gathered it on those
            wte = spmd.gather(wte, "wte")
        x = stage_output(x, (*tokens.shape, config.d_model), config.dtype, spmd)
        logits = _lm_head(spmd.copy_to_tp(x, wte.shape[0] < config.vocab_size), wte)
        logits = spmd.global_batch(logits, config.vocab_size)
    return (logits, moe_aux) if return_aux else logits


def loss_fn(
    params: Dict[str, Any],
    batch: Dict[str, Any],  # {"tokens": (B, S+1)} or {"inputs", "targets"}
    config: GPTConfig,
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
    x, moe_aux, wte = _hidden(params, inputs, config, attention_fn, dropout_seed, spmd,
                              num_microbatches)
    loss = lm_head_loss(x, wte, targets, config.vocab_size, spmd, num_microbatches)
    if config.moe_experts:
        loss = loss + config.moe_aux_weight * moe_aux
    return loss
