"""The trace arithmetic the per-layer readers use, on made-up traces and on
a profiler trace of the CPU."""

import pytest

from port_bench import trace
from conftest import cell as cell_named
from port_bench.cells import reader, resolve
from port_bench.run import Run


def made_up(device, steps=1, window_us=1000.0):
    names = sorted({n for n, _, _ in device})
    return {"steps": steps, "window_us": window_us,
            "busy_us": trace.length(trace.union([(a, b) for _, a, b in device])),
            "names": names, "device": [(names.index(n), a, b) for n, a, b in device],
            "ranges": [], "idle_us_by_host_op": [["aten::item", 1.0]]}


def test_union_and_overlap():
    u = trace.union([(0, 2), (1, 3), (5, 6)])
    assert u == [[0, 3], [5, 6]]
    assert trace.overlap(u, trace.union([(2, 5.5)])) == 1.5


def test_readers_on_a_made_up_rank():
    cell = cell_named("gpt2_small.pretrain_dp4")
    fwd = cell["model"]["n_head"] * 16
    device = [("flash_fwd_wgmma_kernel<64>", 0, 100), ("ampere_sgemm_128x64_nn", 100, 300),
              ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 250, 450),
              ("void at::native::vectorized_elementwise_kernel", 450, 500),
              ("flash_bwd_wgmma_kernel<64>", 500, 800), ("flash_bwd_dq_convert_kernel", 800, 810),
              ("Memcpy HtoD (Pinned -> Device)", 810, 820)]
    rank = {"trace": made_up(device), "window": {"peak_bytes": 1, "seconds": 1.0, "tokens": 1}}
    run = Run(cell, [rank], fit_start=0.0)
    assert reader("gemm_ms")(run) == pytest.approx(0.2)
    assert reader("elementwise_ms")(run) == pytest.approx(0.05)
    assert reader("nccl_exposed_ms")(run) == pytest.approx(0.15)
    assert reader("device_idle")(run) == pytest.approx(100 * (1 - 820 / 1000))
    least = 0.0303  # ms at B 16 x S 1024, d 64
    assert reader("attn_fwd_roofline")(run) == pytest.approx(100 * least / 0.1, rel=2e-2)
    assert 0 < reader("attn_bwd_roofline")(run) < 100
    assert fwd == 192


def test_a_reader_with_nothing_to_read_returns_nothing():
    cell = resolve("gpt2_small.pretrain")
    run = Run(cell, [{"trace": None, "window": {"peak_bytes": None}}], fit_start=0.0)
    for name in ("gemm_ms", "attn_fwd_roofline", "nccl_exposed_ms", "device_idle", "step_mfu"):
        assert reader(name)(run) is None


def test_collect_reads_a_cpu_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            for _ in range(3):
                with record_function("port_bench.step"):
                    (x @ x).relu_()
    t = trace.collect(prof, steps=3)
    assert t["busy_us"] == 0 and t["window_us"] > 0 and not t["device"]
    assert any(t["names"][r[0]] == "port_bench.step" for r in t["ranges"])
    assert t["idle_us_by_host_op"]
