"""The port's attention (ray_tpu_torch.ops.flash_attention) against the JAX
package's, on the CPU: the port runs the plain versions of its CUDA kernels
through the same autograd function the GPU path uses; the JAX side runs its
Pallas kernels in interpret mode. Inputs come from numpy with a fixed seed.

Tolerances (those of tests/test_ops.py): f32 forward and lse 2e-5, gradients
5e-4, bf16 inputs 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import _fwd as jax_fwd
from ray_tpu.ops.flash_attention import blockwise_attention as jax_blockwise
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu.ops.flash_attention import xla_attention as jax_xla
from ray_tpu_torch.ops.flash_attention import (
    _fwd,
    blockwise_attention,
    flash_attention,
    xla_attention,
)

SHAPE = (2, 2, 256, 64)
SCALE = SHAPE[-1] ** -0.5


@pytest.fixture(scope="module")
def qkvg():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4))


def _t(x, dtype=torch.float32, grad=False):
    return torch.tensor(x, dtype=dtype, requires_grad=grad)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_lse_match_pallas(qkvg, causal):
    q, k, v, _ = qkvg
    bh = SHAPE[0] * SHAPE[1]
    flat = lambda x: x.reshape(bh, SHAPE[2], SHAPE[3])  # noqa: E731
    # 128-blocks: the Pallas kernel walks two q and two k blocks, diagonal included.
    o_ref, lse_ref = jax_fwd(
        jnp.asarray(flat(q)), jnp.asarray(flat(k)), jnp.asarray(flat(v)),
        causal, SCALE, 128, 128, True,
    )
    o, lse = _fwd(_t(flat(q)), _t(flat(k)), _t(flat(v)), causal, SCALE)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0], atol=2e-5)

    out = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    out_ref = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal, backend="pallas",
                        interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_xla_attention_matches(qkvg, causal):
    q, k, v, _ = qkvg
    out = xla_attention(_t(q), _t(k), _t(v), causal=causal)
    ref = jax_xla(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_pallas_grad(qkvg, causal):
    q, k, v, g = qkvg

    def jax_loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, backend="pallas", interpret=True)
        return (o * jnp.asarray(g)).sum()

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad((o * _t(g)).sum(), (tq, tk, tv))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4)


def test_bf16_inputs(qkvg):
    q, k, v, _ = qkvg
    out = flash_attention(*(_t(x, torch.bfloat16) for x in (q, k, v)), causal=True)
    assert out.dtype == torch.bfloat16
    ref = jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True,
                    backend="pallas", interpret=True)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=3e-2
    )


def test_ragged_seq_matches_xla():
    # S = 100 has no block the TPU kernel could tile (it falls back to XLA
    # there); the port's flash path takes any S.
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 2, 100, 64)).astype(np.float32) for _ in range(3))
    out = flash_attention(_t(q), _t(k), _t(v), causal=True)
    ref = jax_xla(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_blockwise_attention_matches(qkvg):
    q, k, v, g = qkvg
    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    out = blockwise_attention(tq, tk, tv, causal=True, block_k=64)
    ref = jax_blockwise(*map(jnp.asarray, (q, k, v)), causal=True, block_k=64)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5)

    got = torch.autograd.grad((out * _t(g)).sum(), (tq, tk, tv))
    ref_g = jax.grad(
        lambda q, k, v: (jax_blockwise(q, k, v, causal=True, block_k=64) * jnp.asarray(g)).sum(),
        argnums=(0, 1, 2),
    )(*map(jnp.asarray, (q, k, v)))
    for a, b in zip(got, ref_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4)


def test_flash_backend_names():
    rng = np.random.default_rng(2)
    q = _t(rng.standard_normal((1, 1, 16, 64)).astype(np.float32))
    ref = xla_attention(q, q, q)
    for backend in (None, "flash", "xla", "blockwise"):
        out = flash_attention(q, q, q, backend=backend)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, backend="pallas")


def test_misaligned_pointer_raises_and_aligned_passes():
    # The bf16 kernels read by TMA, which takes 16-byte aligned addresses; the
    # wrapper raises on any other and never copies.
    from ray_tpu_torch.ops.flash_attention import _check_aligned

    base = torch.zeros(64, dtype=torch.bfloat16)
    _check_aligned(q=base)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_aligned(q=base, k=base[1:])


@pytest.mark.parametrize(
    "err,match",
    [(100000 + 201, "CUresult 201"), (719, "CUDA error 719")],
)
def test_launch_errors_are_decoded(err, match):
    from ray_tpu_torch.ops.flash_attention import _raise_on

    _raise_on(0, "flash_fwd")
    with pytest.raises(RuntimeError, match=match):
        _raise_on(err, "flash_fwd")
