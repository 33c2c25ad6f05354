"""The yardstick's arithmetic: the H100's peaks, a step's model FLOPs and
the attention kernels' least time.

``bound`` and ``attention_bounds`` are copies of ``chip_smoke.py``'s
functions of the same names (with the operation and byte counts returned
beside the time, and v's head dim apart from q's and k's). A step's model
FLOPs and its attention shapes come from the configuration's architecture
(``archs/<model_type>.py``).
"""

from __future__ import annotations

from port_bench import archs

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet, 700 W)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def bound(flops, nbytes):
    """The least time in ms of ``flops`` operations and ``nbytes`` bytes, and
    which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bounds(bh, seq, hd, elt=2, hd_v=None):
    """The causal forward and backward kernels on (bh, seq) with q and k of
    head dim ``hd`` and v of ``hd_v`` (``hd`` where not given): for each, a
    dict of its operations, bytes, least ms and what bounds it. Products over
    the (query, key) pairs the causal mask keeps, at the bf16 peak: forward
    q k^T at ``hd`` and p v at ``hd_v``; backward q k^T, ds k and ds^T q at
    ``hd``, do v^T and p^T do at ``hd_v``. Against each input read once and
    each output written once at the memory rate: forward q, k at ``hd``, v, o
    at ``hd_v`` and an f32 lse; backward q, k, dq, dk at ``hd``, v, do, dv at
    ``hd_v``, and f32 lse and delta."""
    hd_v = hd if hd_v is None else hd_v
    pairs = bh * seq * (seq + 1) / 2
    rows = bh * seq
    out = {}
    for name, flops, nbytes in (
            ("fwd", 2 * pairs * (hd + hd_v), rows * (2 * hd + 2 * hd_v) * elt + rows * 4),
            ("bwd", 2 * pairs * (3 * hd + 2 * hd_v),
             rows * (4 * hd + 3 * hd_v) * elt + 2 * rows * 4)):
        ms, what = bound(flops, nbytes)
        out[name] = {"flops": flops, "bytes": nbytes, "ms": ms, "bound": what}
    return out


def attention_step_ms(model, traffic):
    """The least ms of one step's attention on one GPU, ``fwd`` and ``bwd``:
    each shape's least time times its calls a step, summed over the shapes
    of ``attention_calls``."""
    out = {"fwd": 0.0, "bwd": 0.0}
    for bh, seq, hd, hd_v, calls in archs.of(model).attention_calls(model, traffic):
        b = attention_bounds(bh, seq, hd, hd_v=hd_v)
        for name in out:
            out[name] += b[name]["ms"] * calls
    return out


def train_flops_per_token(model, seq):
    """Forward and backward: three times the products of the architecture's
    forward (``forward_flops_per_token``)."""
    return 3 * archs.of(model).forward_flops_per_token(model, seq)
