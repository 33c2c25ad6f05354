"""The plain reference agrees with the port at a nano size on the CPU, in
float32 on both sides: the loss, the first gradient as AdamW takes it, and
one AdamW update."""

import dataclasses

import pytest
import torch

from conftest import nano
from port_bench import check, weights
from port_bench.loop import Worker, reference_readings
from port_bench.reference import gpt2


@pytest.mark.parametrize("cell", ["gpt2_small.pretrain", "gpt2_small_moe8.pretrain"])
def test_reference_matches_the_port_in_f32(cell):
    c = nano(cell)
    c["traffic"]["checked_steps"] = 1
    w = Worker(c, 2**31 + 5, torch.device("cpu"))
    w.build()
    w.cfg = dataclasses.replace(w.cfg, dtype=torch.float32)
    from ray_tpu_torch.models import make_train_step

    w.step_fn = make_train_step(w.cfg, w.opt)
    program = w.checked_steps()
    ref = reference_readings(c, 2**31 + 5, torch.device("cpu"))
    g = check.gaps(program, ref)
    assert g["loss_gap"] < 1e-5
    assert g["grad_gap"] < 1e-4
    assert g["update_gap"] < 1e-4
    assert g["left_out"] == ["blocks.qkv_b.k"]  # the key's bias: rounding only


def test_fp8_products_round_operands():
    a = torch.randn(8, 16)
    b = torch.randn(16, 4)
    exact = a @ b
    low = gpt2.matmul_for("fp8")(a, b)
    rel = ((low - exact).norm() / exact.norm()).item()
    assert 1e-3 < rel < 0.1


def test_row_blocks_do_not_change_the_moe_loss_or_gradient():
    c = nano("gpt2_small_moe8.pretrain")
    params = weights.init_params(c["model"], 9, "cpu")
    tokens = torch.randint(0, 250, (4, 33))
    whole, g_whole = gpt2.loss_and_grads(params, tokens, c["model"], rows_per_block=4)
    parts, g_parts = gpt2.loss_and_grads(params, tokens, c["model"], rows_per_block=1)
    assert abs(whole - parts) < 1e-5
    for (name, a), (_, b) in zip(weights.leaves(g_whole), weights.leaves(g_parts)):
        assert torch.allclose(a, b, atol=1e-6, rtol=1e-4), name
