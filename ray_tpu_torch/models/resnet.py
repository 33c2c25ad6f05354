"""ResNet family in PyTorch: the counterpart of ``ray_tpu/models/resnet.py``.

The JAX package's tree and layout: NHWC activations, HWIO conv kernels
(permuted to PyTorch's OIHW at use), GroupNorm in f32, bf16 convolutions with
f32 outputs, f32 logits; ``params["stage<i>"]`` is a list of block dicts.
Convolutions and the stem's max-pool pad as XLA's ``padding="SAME"`` does, which is asymmetric for
a stride-2 window on an even input (the 7x7/2 stem on 224 pads 2 before and 3
after), so each pads explicitly and then runs unpadded. Over a tensor axis each
rank computes its slice of every convolution's output channels
(``parallel/spmd.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.accelerators.gpu import resolve_device
from ray_tpu_torch.models.gpt import _lm_head
from ray_tpu_torch.ops.basic import causal_lm_loss
from ray_tpu_torch.parallel.spmd import spmd_for


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    # Stage depths, e.g. (3, 4, 6, 3) for ResNet-50.
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    bottleneck: bool = True
    width: int = 64
    groupnorm_groups: int = 32
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @property
    def expansion(self) -> int:
        return 4 if self.bottleneck else 1

    # ---- presets ----
    @classmethod
    def resnet18(cls, **kw):
        return cls(stage_sizes=(2, 2, 2, 2), bottleneck=False, **kw)

    @classmethod
    def resnet34(cls, **kw):
        return cls(stage_sizes=(3, 4, 6, 3), bottleneck=False, **kw)

    @classmethod
    def resnet50(cls, **kw):
        return cls(stage_sizes=(3, 4, 6, 3), bottleneck=True, **kw)

    @classmethod
    def resnet101(cls, **kw):
        return cls(stage_sizes=(3, 4, 23, 3), bottleneck=True, **kw)

    @classmethod
    def nano(cls, **kw):
        """Tiny config for CPU tests (CIFAR-shaped inputs)."""
        kw.setdefault("num_classes", 10)
        kw.setdefault("width", 8)
        kw.setdefault("groupnorm_groups", 4)
        return cls(stage_sizes=(1, 1), bottleneck=False, **kw)


# --------------------------------------------------------------------------- init
def _param_spec(config: ResNetConfig) -> Dict[str, Any]:
    """The param tree with each leaf as (shape, init): "conv" (He-normal over
    the kernel's fan-in), "head" (normal(0.01)), "ones" or "zeros"."""
    w = config.width
    spec: Dict[str, Any] = {
        "stem": {"conv": ((7, 7, 3, w), "conv"), "gn_scale": ((w,), "ones"),
                 "gn_bias": ((w,), "zeros")}
    }
    cin = w
    for si, n_blocks in enumerate(config.stage_sizes):
        ch = w * 2**si
        cout = ch * config.expansion
        blocks: List[Dict[str, Any]] = []
        for _ in range(n_blocks):
            if config.bottleneck:
                b = {"conv1": ((1, 1, cin, ch), "conv"), "conv2": ((3, 3, ch, ch), "conv"),
                     "conv3": ((1, 1, ch, cout), "conv")}
                sizes = [ch, ch, cout]
            else:
                b = {"conv1": ((3, 3, cin, ch), "conv"), "conv2": ((3, 3, ch, cout), "conv")}
                sizes = [ch, cout]
            # The last norm's scale starts at zero: each block starts as identity.
            for ni, c in enumerate(sizes):
                b[f"gn{ni + 1}_scale"] = ((c,), "zeros" if ni == len(sizes) - 1 else "ones")
                b[f"gn{ni + 1}_bias"] = ((c,), "zeros")
            if cin != cout:
                # Every stride-2 block too: stage channels double.
                b["proj"] = ((1, 1, cin, cout), "conv")
            blocks.append(b)
            cin = cout
        spec[f"stage{si}"] = blocks
    spec["head"] = {"w": ((cin, config.num_classes), "head"), "b": ((config.num_classes,), "zeros")}
    return spec


def _spec_map(fn, spec):
    if isinstance(spec, dict):
        return {k: _spec_map(fn, v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_spec_map(fn, v) for v in spec]
    return fn(*spec)


def init_params(config: ResNetConfig, seed=0, device=None, place=None) -> Dict[str, Any]:
    """Random ResNet params from ``seed`` (an int or a ``torch.Generator``) on
    ``device`` (``None``: the GPU; raises when there is none; ``"meta"``:
    shapes only), each leaf through ``place`` as in ``gpt.init_params``."""
    device = resolve_device(device)
    pd = config.param_dtype
    put = place or (lambda t: t)
    if device.type == "meta":
        gen = None
    elif isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=device).manual_seed(int(seed))

    def make(shape, init):
        if init in ("ones", "zeros"):
            return put(torch.full(shape, 1.0 if init == "ones" else 0.0, dtype=pd, device=device))
        if gen is None:
            return put(torch.empty(shape, dtype=pd, device=device))
        std = math.sqrt(2.0 / (shape[0] * shape[1] * shape[2])) if init == "conv" else 0.01
        return put((torch.randn(shape, generator=gen, device=gen.device) * std).to(device, pd))

    return _spec_map(make, _param_spec(config))


def param_logical_axes(config: ResNetConfig) -> Dict[str, Any]:
    """Those of ``ray_tpu/models/resnet.py``: conv kernels shard their
    output-channel dim over ``mlp``; the classifier head shards embed ->
    vocab like an LM head."""

    def ax(path, spec):
        if isinstance(spec, dict):
            return {k: ax(path + (k,), v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [ax(path + (i,), v) for i, v in enumerate(spec)]
        shape = spec[0]
        if path[-2:] == ("head", "w"):
            return ("embed", "vocab")
        if len(shape) == 4:  # conv kernel (kh, kw, cin, cout)
            return (None, None, None, "mlp")
        return (None,) * len(shape)

    return ax((), _param_spec(config))


def num_params(config: ResNetConfig) -> int:
    counts = []
    _spec_map(lambda shape, init: counts.append(math.prod(shape)), _param_spec(config))
    return sum(counts)


# --------------------------------------------------------------------------- forward
def _group_norm(x, scale, bias, groups, eps=1e-5):
    """GroupNorm of x (N, H, W, C) in f32, over each group's channels and all
    positions; ``groups`` falls back to the largest divisor of C below it."""
    C = x.shape[-1]
    g = min(groups, C)
    while C % g:
        g -= 1
    # F.group_norm takes the JAX package's mean and variance over (H, W, C/g)
    # and the same per-channel scale and bias, and saves only its input and
    # the statistics for the backward.
    return F.group_norm(x.float().permute(0, 3, 1, 2), g, scale, bias, eps).permute(0, 2, 3, 1)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, stride: int, value: float = 0.0):
    """Pad x (N, H, W, C) as "SAME" would for a k x k window at ``stride``."""
    (ht, hb), (wl, wr) = _same_pads(x.shape[1], k, stride), _same_pads(x.shape[2], k, stride)
    if ht or hb or wl or wr:
        x = F.pad(x, (0, 0, wl, wr, ht, hb), value=value)
    return x


@contextlib.contextmanager
def _tf32_convs():
    """cuDNN may use TF32 inside the block. Only this flag is set: the
    ``torch.backends.cudnn.flags`` context manager resets every flag it is not
    given, ``enabled`` to False among them."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _ConvBF16F32Out(torch.autograd.Function):
    """A convolution of bf16 operands with an f32 output, as
    ``preferred_element_type=jnp.float32`` gives it: the operands are upcast and
    convolved in f32, with TF32 allowed for this call only. TF32's 10-bit
    mantissa holds every bf16 value, so each product is exact and the sums stay
    f32. The backward takes the output's gradient in bf16 and convolves in
    bf16, as autograd through a bf16 convolution does, and saves the bf16
    operands only."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _tf32_convs():
            return F.conv2d(x.float(), w.float(), stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, w, g, ctx.stride)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(x, w.shape, g, ctx.stride)
        return gx, gw, None


def _conv(x, w, stride=1, cdt=None):
    """Convolution of x (N, H, W, Cin) with w (kh, kw, Cin, Cout), "SAME"
    padding. The products run on operands rounded to ``cdt``; in bf16 the
    output stays f32 up to the GroupNorm, as the JAX package keeps it."""
    x = _pad_same(x.to(cdt), w.shape[0], stride).permute(0, 3, 1, 2)
    w = w.to(cdt).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    if cdt == torch.bfloat16:
        y = _ConvBF16F32Out.apply(x, w, stride)
    else:
        y = F.conv2d(x, w, stride=stride)
    return y.permute(0, 2, 3, 1)


def _tp_group_norm(x, scale, bias, groups, spmd, eps=1e-5):
    """GroupNorm of this rank's channel slice x (N, H, W, C / tp) of a
    C-channel activation split over the tensor group; ``scale`` and ``bias``
    whole (C,). Where the groups fall whole in each slice the statistics are
    the slice's own; else each group's mean and then variance come from the
    per-channel sums of every slice, gathered (the activations never are)."""
    C = x.shape[-1] * spmd.tp
    g = min(groups, C)
    while C % g:
        g -= 1
    scale, bias = spmd.tp_slice(scale), spmd.tp_slice(bias)
    if g % spmd.tp == 0:
        return _group_norm(x, scale, bias, g // spmd.tp, eps)
    xf = x.float()
    n, per = x.shape[1] * x.shape[2] * (C // g), C // g

    def group_mean(per_channel):  # (N, C/tp) sums -> each local channel's group mean
        whole = spmd.gather_channels(per_channel).view(x.shape[0], g, per).sum(-1) / n
        # A plain slice: this rank's part of the sums' gradient, which the
        # gather's backward adds up across the group.
        return whole.repeat_interleave(per, dim=-1).chunk(spmd.tp, -1)[spmd.tp_rank]

    d = xf - group_mean(xf.sum((1, 2)))[:, None, None, :]
    var = group_mean((d * d).sum((1, 2)))[:, None, None, :]
    return d * torch.rsqrt(var + eps) * scale + bias


def _norm(x, scale, bias, config: ResNetConfig, spmd):
    """The config's GroupNorm of x, or of this rank's channel slice of it
    over the tensor axis."""
    if spmd is not None and spmd.tp > 1:
        return _tp_group_norm(x, scale, bias, config.groupnorm_groups, spmd)
    return _group_norm(x, scale, bias, config.groupnorm_groups)


def _block_fwd(x, b, config: ResNetConfig, stride: int, spmd=None):
    """One block. Over the tensor axis (``spmd.tp > 1``), x and the result
    are this rank's channel slices: the input is gathered whole before each
    convolution, and each convolution computes this rank's output channels."""
    cdt = config.dtype
    whole = spmd.gather_channels if spmd is not None and spmd.tp > 1 else (lambda t: t)

    def norm(h, i):
        return _norm(h, b[f"gn{i}_scale"], b[f"gn{i}_bias"], config, spmd)

    def gn_relu(h, i):  # relu after rounding to cdt: the same values, half the saved bytes
        return F.relu(norm(h, i).to(cdt))

    x_in = whole(x)
    if config.bottleneck:
        h = gn_relu(_conv(x_in, b["conv1"], 1, cdt), 1)
        h = gn_relu(_conv(whole(h), b["conv2"], stride, cdt), 2)
        h = norm(_conv(whole(h), b["conv3"], 1, cdt), 3)
    else:
        h = gn_relu(_conv(x_in, b["conv1"], stride, cdt), 1)
        h = norm(_conv(whole(h), b["conv2"], 1, cdt), 2)
    if "proj" in b:
        residual = _conv(x_in, b["proj"], stride, cdt)
    elif stride != 1:
        raise ValueError("a stride-2 block without a projection kernel")
    else:
        residual = x
    return F.relu((h + residual.float()).to(cdt))


def _forward_local(params, images, config: ResNetConfig, spmd):
    """Logits (B, num_classes) f32 from this rank's shards (all of them off a
    mesh); over the tensor axis, this rank's slice of the classes where the
    head splits them."""
    if spmd is not None:
        if spmd.pp > 1 or spmd.cp > 1:
            raise NotImplementedError(
                "ResNet has no layer stack to pipeline and no sequence to split: it runs "
                "on data, fsdp, tensor and expert meshes"
            )
        params, images = spmd.local(params), spmd.batch_local(images)
        params = {**params, "head": {**params["head"],
                                     "w": spmd.gather(params["head"]["w"], "head.w")}}
    split = spmd is not None and spmd.tp > 1
    cdt = config.dtype
    stem = params["stem"]
    x = _conv(images, stem["conv"], 2, cdt)
    x = F.relu(_norm(x, stem["gn_scale"], stem["gn_bias"], config, spmd).to(cdt))
    # 3x3 max-pool, stride 2, "SAME" with -inf padding.
    x = _pad_same(x, 3, 2, value=-math.inf)
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    for si in range(len(config.stage_sizes)):
        for bi, b in enumerate(params[f"stage{si}"]):
            x = _block_fwd(x, b, config, 2 if (si > 0 and bi == 0) else 1, spmd)
    x = x.float().mean(dim=(1, 2))  # global average pool
    w, bias = params["head"]["w"], params["head"]["b"].float()
    if split:
        classes_split = w.shape[1] < config.num_classes
        # A head split over the classes makes a part of the features'
        # gradient on each rank; a replicated one makes all of it.
        x = spmd.gather_channels(x, sum_grad=classes_split)
        if classes_split:
            bias = spmd.tp_slice(bias)
    return _lm_head(x.to(cdt), w.to(cdt).t()) + bias


def forward(
    params: Dict[str, Any],
    images,  # (B, H, W, 3) float
    config: ResNetConfig,
    attention_fn=None,  # API parity with the LM families (unused)
    dropout_seed=None,
    mesh=None,
):
    """Class logits (B, num_classes) in float32. On a mesh, from this rank's
    shards (the head gathered over fsdp; channels and classes split over the
    tensor axis), returned as a DTensor with the batch over (data, fsdp) and
    the classes over tensor where the head splits them."""
    del attention_fn, dropout_seed
    spmd = spmd_for(mesh)
    logits = _forward_local(params, images, config, spmd)
    return logits if spmd is None else spmd.global_batch(logits, config.num_classes)


def loss_fn(
    params: Dict[str, Any],
    batch: Dict[str, Any],  # {"images": (B, H, W, 3), "labels": (B,)}
    config: ResNetConfig,
    attention_fn=None,
    dropout_seed=None,
    mesh=None,
):
    """Softmax cross entropy over classes (mean over the batch; on a mesh,
    over the global batch)."""
    del attention_fn, dropout_seed
    spmd = spmd_for(mesh)
    logits = _forward_local(params, batch["images"], config, spmd)
    if spmd is None:
        return causal_lm_loss(logits, batch["labels"])
    labels = spmd.batch_local(batch["labels"])
    return spmd.batch_mean(spmd.token_ce(logits, labels, config.num_classes))
