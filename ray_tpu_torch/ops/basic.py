"""Small ops that the models and the mesh layer (``parallel/spmd.py``) share:
the product returned in f32 from compute-dtype operands, the seed fold, and
the causal LM loss."""

from __future__ import annotations

import torch


class HeadF32(torch.autograd.Function):
    """``x @ w.T`` from operands in the compute dtype, summed and returned in
    f32 (the JAX head's ``preferred_element_type=f32``): the logits are never
    rounded to bf16. The backward rounds the f32 cotangent to the operands'
    type, as the TPU's default-precision dot does with mixed operands."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.mm(x, w.t(), out_dtype=torch.float32)
        # aten::mm.dtype has no CPU kernel: the same products, taken in f32.
        return torch.mm(x.float(), w.float().t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w, g.t() @ x


def fold_seed(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data): the counterpart of ``fold_in``."""
    return (seed * 0x9E3779B97F4A7C15 + data + 1) % (1 << 63)


def causal_lm_loss(logits, targets):
    """Cross entropy as logsumexp - logit[target], mean over tokens."""
    lse = torch.logsumexp(logits, dim=-1)
    at_target = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (lse - at_target).mean()
