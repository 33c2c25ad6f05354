"""Plain PyTorch reference of GPT-2 pretraining, dense or with Switch top-1
experts in every block: the loss, its gradients and AdamW's first steps.

Written from the published descriptions (GPT-2: pre-norm blocks, causal
softmax attention, the tanh GELU, a head tied to the token embedding;
Switch Transformer, arXiv:2101.03961: a float32 router, top-1 experts, a
capacity of ceil(tokens a group * capacity factor / experts) with tokens over
it passed on by the residual alone, the gate scaling the expert's output, and
the load-balancing loss E * sum_e f_e * P_e) and from nothing of the program:
it imports neither ``ray_tpu_torch`` nor ``ray_tpu`` nor ``jax``. It reads the
parameters by the port's leaf names, which ``port_bench/archs/gpt2.py``
makes.

Every product is a float32 ``torch.matmul`` with TF32 off, unless
``precision="fp8"``: then each operand of every product but the router's
(which Switch keeps in float32) is rounded to float8 e4m3 at a per-tensor
scale, the backward's too. That is the check's control, the precision one
step below the configuration's bfloat16.

Rows are taken in blocks, gradients summed over them, so a batch of any size
fits. Switch's routing group is a row, so blocks change no route; its
load-balancing loss is a product of means over the whole batch, so a first
pass without gradients takes each layer's routed fractions f_e over all rows,
and each block then adds the gradient of E * sum_e f_e * P_e(block) weighted
by its share of the tokens, which sums to the whole batch's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # float8_e4m3fn


def _fp8(x):
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        return torch.matmul(qg, qb.transpose(-1, -2)), torch.matmul(qa.transpose(-1, -2), qg)


def matmul_for(precision):
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


def _layer_norm(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def _attention(x, p, layer, model, mm):
    B, S, d = x.shape
    nh = model["n_head"]
    hd = d // nh
    qkv = mm(x, p["qkv_w"][layer].reshape(d, 3 * d)).view(B, S, 3, nh, hd) + p["qkv_b"][layer]
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, nh, S, hd)
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    future = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    o = mm(probs, v).transpose(1, 2).reshape(B, S, d)
    return mm(o, p["out_w"][layer].reshape(d, d)) + p["out_b"][layer]


def _mlp(x, p, layer, mm):
    h = F.gelu(mm(x, p["fc_w"][layer]) + p["fc_b"][layer], approximate="tanh")
    return mm(h, p["proj_w"][layer]) + p["proj_b"][layer]


def route(x, router_w, capacity_factor):
    """Switch top-1 routing of x (B, S, d) in float32, each row a group:
    (probs (B, S, E), expert (B, S), gate (B, S), kept (B, S) bool)."""
    B, S, _ = x.shape
    E = router_w.shape[-1]
    capacity = max(math.ceil(S * capacity_factor / E), 1)
    probs = torch.softmax(torch.matmul(x, router_w), dim=-1)
    expert = probs.argmax(-1)
    gate = probs.gather(-1, expert[..., None])[..., 0]
    chosen = F.one_hot(expert, E)
    place = (chosen.cumsum(1) * chosen).sum(-1)  # 1-based place in its expert's queue
    return probs, expert, gate, place <= capacity


def _moe(x, p, layer, model, mm, fracs, aux_terms, token_share):
    m = p["moe"]
    B, S, d = x.shape
    E = m["router_w"].shape[-1]
    probs, expert, gate, kept = route(x, m["router_w"][layer], model["expert_capacity_factor"])
    flat, out = x.reshape(B * S, d), torch.zeros(B * S, d, dtype=x.dtype, device=x.device)
    expert, gate, kept = expert.reshape(-1), gate.reshape(-1), kept.reshape(-1)
    for e in range(E):
        rows = torch.nonzero((expert == e) & kept)[:, 0]
        if rows.numel() == 0:
            continue
        h = F.gelu(mm(flat[rows], m["fc_w"][layer, e]) + m["fc_b"][layer, e], approximate="tanh")
        y = mm(h, m["proj_w"][layer, e]) + m["proj_b"][layer, e]
        out = out.index_add(0, rows, y * gate[rows, None])
    routed = F.one_hot(expert, E).float().mean(0)
    f = routed if fracs is None else fracs[layer]
    aux_terms.append(E * torch.sum(f * probs.mean((0, 1))) * token_share)
    return out.view(B, S, d), routed


def forward_loss(params, tokens, model, precision="f32", fracs=None, token_share=1.0):
    """The mean next-token cross entropy of ``tokens`` (B, S + 1) plus, with
    experts, router_aux_loss_coef times the sum over layers of Switch's
    load-balancing loss, and each layer's routed fractions. With ``fracs``
    (each layer's f_e over the whole batch), the balancing terms are those
    fractions against this block's mean probabilities, times
    ``token_share``: the block's part of the whole batch's gradient."""
    mm = matmul_for(precision)
    eps = model["layer_norm_epsilon"]
    inputs, targets = tokens[:, :-1].long(), tokens[:, 1:].long()
    S = inputs.shape[1]
    x = params["wte"][inputs] + params["wpe"][:S]
    aux_terms, routed = [], []
    blocks = params["blocks"]
    for layer in range(model["n_layer"]):
        h = _layer_norm(x, blocks["ln1_scale"][layer], blocks["ln1_bias"][layer], eps)
        x = x + _attention(h, blocks, layer, model, mm)
        h = _layer_norm(x, blocks["ln2_scale"][layer], blocks["ln2_bias"][layer], eps)
        if model.get("num_experts"):
            y, f = _moe(h, blocks, layer, model, mm, fracs, aux_terms, token_share)
            routed.append(f)
        else:
            y = _mlp(h, blocks, layer, mm)
        x = x + y
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"], eps)
    logits = mm(x, params["wte"].t())
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1)) * token_share
    if aux_terms:
        loss = loss + model["router_aux_loss_coef"] * torch.stack(aux_terms).sum()
    return loss, routed


def _tree_leaves(tree):
    out = []
    for v in tree.values():
        out += _tree_leaves(v) if isinstance(v, dict) else [v]
    return out


def _tree_like(tree, flat):
    it = iter(flat)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it) for k, v in t.items()}

    return build(tree)


def loss_and_grads(params, tokens, model, precision="f32", rows_per_block=4):
    """The whole batch's loss (a float) and its gradient (a tree like
    ``params``), over blocks of ``rows_per_block`` rows."""
    B = tokens.shape[0]
    blocks = [tokens[i:i + rows_per_block] for i in range(0, B, rows_per_block)]
    fracs = None
    if model.get("num_experts") and len(blocks) > 1:
        with torch.no_grad():
            per_block = [forward_loss(params, b, model, precision)[1] for b in blocks]
        fracs = [sum(f[layer] * b.shape[0] for f, b in zip(per_block, blocks)) / B
                 for layer in range(model["n_layer"])]
    flat = _tree_leaves(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    tree = _tree_like(params, leaves)
    grads = [torch.zeros_like(p) for p in leaves]
    total = 0.0
    for b in blocks:
        loss, _ = forward_loss(tree, b, model, precision, fracs, b.shape[0] / B)
        for g, gb in zip(grads, torch.autograd.grad(loss, leaves, allow_unused=True)):
            if gb is not None:
                g.add_(gb)
        total += loss.item()
    return total, _tree_like(params, grads)


class AdamW:
    """Global-norm clipping, then Adam with decoupled weight decay on every
    leaf (Loshchilov and Hutter), bias-corrected, in float32."""

    def __init__(self, params, opt):
        self.opt = opt
        self.mu = [torch.zeros_like(p) for p in _tree_leaves(params)]
        self.nu = [torch.zeros_like(p) for p in _tree_leaves(params)]
        self.count = 0

    def clip(self, grads):
        flat = _tree_leaves(grads)
        norm = torch.sqrt(sum((g * g).sum() for g in flat))
        if norm >= self.opt["grad_clip"]:
            flat = [g / norm * self.opt["grad_clip"] for g in flat]
        return flat

    def step(self, params, grads):
        """The clipped gradient the update used (a tree), after updating
        ``params`` in place."""
        o = self.opt
        flat = self.clip(grads)
        self.count += 1
        bc1, bc2 = 1 - o["b1"] ** self.count, 1 - o["b2"] ** self.count
        with torch.no_grad():
            for p, g, mu, nu in zip(_tree_leaves(params), flat, self.mu, self.nu):
                mu.mul_(o["b1"]).add_((1 - o["b1"]) * g)
                nu.mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
                update = (mu / bc1) / (torch.sqrt(nu / bc2) + o["eps"]) + o["weight_decay"] * p
                p.sub_(o["learning_rate"] * update)
        return _tree_like(params, flat)


def train(params, batches, model, opt, precision="f32", rows_per_block=4, on_step=None):
    """Train ``params`` (updated in place) on each of ``batches`` in turn.
    Returns each step's loss; ``on_step(i, clipped_grads)`` sees each step's
    clipped gradient."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        adam, losses = AdamW(params, opt), []
        for i, tokens in enumerate(batches):
            loss, grads = loss_and_grads(params, tokens, model, precision, rows_per_block)
            clipped = adam.step(params, grads)
            losses.append(loss)
            if on_step is not None:
                on_step(i, clipped)
            del grads, clipped
        return losses
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
