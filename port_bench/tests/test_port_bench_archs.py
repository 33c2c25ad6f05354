"""The architectures: GPT-2's module gives the numbers the harness gave
before it moved there (written here from the harness of before), attention
bounds with v's head dim apart, the readers that go through an
architecture's shapes on a trace of whole steps, and a traced window's
route counts and regions on the CPU."""

import pytest
import torch

from conftest import nano
from port_bench import archs, flops, trace, weights
from port_bench.cells import reader, resolve
from port_bench.run import Run

CELLS = ("gpt2_small.pretrain", "gpt2_small_moe8.pretrain")

# The harness before the move, at B 32 x S 1024.
TRAIN_FLOPS = {"gpt2_small.pretrain": 798087168.0, "gpt2_small_moe8.pretrain": 798529536.0}
BOUNDS_384 = {"fwd": (51589939200.0, 202899456, "bytes"),
              "bwd": (128974848000.0, 355467264, "operations")}
# On a synthetic trace of two whole steps (``whole_steps``), 192 steps of the
# window in 40 s.
READS = {"gpt2_small.pretrain": (62.763732425953144, 41.99979093702222, 12.692442622943902),
         "gpt2_small_moe8.pretrain": (62.763732425953144, 41.99979093702222,
                                      12.699477857544025)}

# The seeded tree at the nano size (seed 2**31 + 99): each unit's norm.
SHARED = {"blocks.ln1_scale": 11.313708305358887, "blocks.ln1_bias": 0.0,
          "blocks.qkv_w.q": 1.8317785263061523, "blocks.qkv_w.k": 1.8224416971206665,
          "blocks.qkv_w.v": 1.79915452003479, "blocks.qkv_b.q": 0.0, "blocks.qkv_b.k": 0.0,
          "blocks.qkv_b.v": 0.0, "blocks.out_w": 0.8986387252807617, "blocks.out_b": 0.0,
          "blocks.ln2_scale": 11.313708305358887, "blocks.ln2_bias": 0.0}
NORMS = {
    "gpt2_small.pretrain": {
        "wte": 2.5841126441955566, "wpe": 1.2905348539352417, **SHARED,
        "blocks.fc_w": 3.604635238647461, "blocks.fc_b": 0.0,
        "blocks.proj_w": 1.799193263053894, "blocks.proj_b": 0.0,
        "lnf_scale": 8.0, "lnf_bias": 0.0},
    "gpt2_small_moe8.pretrain": {
        "wte": 2.562889337539673, "wpe": 1.2802798748016357, **SHARED,
        "blocks.moe.router_w": 0.6438547968864441, "blocks.moe.fc_w": 10.247200965881348,
        "blocks.moe.fc_b": 0.0, "blocks.moe.proj_w": 5.102036952972412,
        "blocks.moe.proj_b": 0.0, "lnf_scale": 8.0, "lnf_bias": 0.0},
}


@pytest.mark.parametrize("cell", CELLS)
def test_gpt2_keeps_the_counts_of_before(cell):
    c = resolve(cell)
    model, traffic = c["model"], c["traffic"]
    assert flops.train_flops_per_token(model, 1024) == TRAIN_FLOPS[cell]
    calls = archs.of(model).attention_calls(model, traffic)
    assert calls == [(32 * 12, 1024, 64, 64, 12)]
    assert archs.attention_launches(model, traffic) == 12
    b = flops.attention_bounds(384, 1024, 64)
    for name, (ops, nbytes, what) in BOUNDS_384.items():
        assert (b[name]["flops"], b[name]["bytes"], b[name]["bound"]) == (ops, nbytes, what)
    step = flops.attention_step_ms(model, traffic)
    assert step == {k: 12 * b[k]["ms"] for k in ("fwd", "bwd")}


@pytest.mark.parametrize("cell", CELLS)
def test_gpt2_keeps_the_seeded_tree_and_its_units(cell):
    model = nano(cell)["model"]
    arch = archs.of(model)
    tree = arch.init_params(model, 2**31 + 99, "cpu")
    units = arch.units(tree)
    assert list(units) == list(NORMS[cell])
    assert weights.unit_norms(units) == pytest.approx(NORMS[cell], rel=1e-6)
    qkv = tree["blocks"]["qkv_w"]
    assert torch.equal(units["blocks.qkv_w.k"], qkv[:, :, 1])


def test_an_unknown_architecture_names_the_known_ones():
    with pytest.raises(KeyError, match="gpt2"):
        archs.of({"model_type": "no_such_arch"})
    with pytest.raises(KeyError, match="gpt2"):
        archs.reference({"reference": "no_such_reference"})


@pytest.mark.parametrize("bh,seq,hd,hd_v", [(384, 1024, 64, None), (384, 1024, 64, 64),
                                            (512, 4096, 192, 128), (16, 8, 128, 64)])
def test_attention_bounds_count_v_apart(bh, seq, hd, hd_v):
    b = flops.attention_bounds(bh, seq, hd, hd_v=hd_v)
    v = hd if hd_v is None else hd_v
    pairs, rows = bh * seq * (seq + 1) / 2, bh * seq
    assert b["fwd"]["flops"] == 2 * pairs * (hd + v)
    assert b["bwd"]["flops"] == 2 * pairs * (3 * hd + 2 * v)
    assert b["fwd"]["bytes"] == 2 * rows * (2 * hd + 2 * v) + 4 * rows
    assert b["bwd"]["bytes"] == 2 * rows * (4 * hd + 3 * v) + 8 * rows
    for name in ("fwd", "bwd"):
        ms, what = flops.bound(b[name]["flops"], b[name]["bytes"])
        assert (b[name]["ms"], b[name]["bound"]) == (ms, what)
    if hd_v is not None and hd_v == hd:
        assert b == flops.attention_bounds(bh, seq, hd)


def test_mla_training_attention_counts_qk_192_and_v_128():
    # MLA's training attention: q and k of 128 + 64 (rope), v of 128.
    b = flops.attention_bounds(32 * 16, 4096, 192, hd_v=128)
    pairs = 32 * 16 * 4096 * 4097 / 2
    assert b["fwd"]["flops"] == pairs * 640 and b["bwd"]["flops"] == pairs * 1664
    assert b["fwd"]["bound"] == b["bwd"]["bound"] == "operations"


def whole_steps(cell, steps=2):
    """A trace of ``steps`` whole steps: a layer's forward call, a product,
    and a layer's backward calls, each layer's of its own length."""
    device, t = [], 0.0
    n = cell["model"]["n_layer"]
    for _ in range(steps):
        for i in range(n):
            device.append(("flash_fwd_wgmma_kernel<64>", t, t + 91.0 + i))
            t += 100.0 + i
        device.append(("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", t, t + 500.0))
        t += 500.0
        for i in range(n):
            device.append(("flash_bwd_wgmma_kernel<64>", t, t + 290.0 + 2 * i))
            t += 300.0 + 2 * i
            device.append(("flash_bwd_dq_convert_kernel", t, t + 9.5))
            t += 10.0
    names = sorted({x for x, _, _ in device})
    return {"steps": steps, "window_us": t,
            "busy_us": trace.length(trace.union([(a, b) for _, a, b in device])),
            "names": names, "device": [(names.index(x), a, b) for x, a, b in device],
            "ranges": [], "idle_us_by_host_op": []}


@pytest.mark.parametrize("cell", CELLS)
def test_rooflines_and_mfu_read_as_before_on_whole_steps(cell):
    c = resolve(cell)
    rank = {"trace": whole_steps(c),
            "window": {"peak_bytes": 1, "seconds": 40.0, "tokens": 192 * 32768}}
    run = Run(c, [rank], fit_start=0.0)
    got = [reader(m)(run) for m in ("attn_fwd_roofline", "attn_bwd_roofline", "step_mfu")]
    assert got == pytest.approx(list(READS[cell]), rel=1e-9)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_window_carries_regions_and_route_counts(cell):
    from port_bench.loop import Worker, run_window

    c = nano(cell)
    w = Worker(c, 2**31 + 61, torch.device("cpu"))
    w.build()
    w.checked_steps()
    window, traced = run_window(w, 0.2, lambda metrics: None, c["traffic"]["checked_steps"],
                                trace_steps=c["traffic"]["trace_steps"])
    # On the CPU nothing runs on a device, so no region has device time.
    assert "regions" in traced and traced["regions"] is None
    routes = traced["moe_routes"]
    run = Run(c, [{"trace": traced, "window": window}], fit_start=0.0)
    pct = reader("moe_dropped_pct")(run)
    if c["model"].get("num_experts"):
        t = c["traffic"]
        assert routes["routed"] == (t["host_trace_steps"] * t["rows_per_gpu"] * t["seq"]
                                    * c["model"]["n_layer"])
        assert 0 < routes["dropped"] < routes["routed"]
        assert pct == pytest.approx(100 * routes["dropped"] / routes["routed"])
    else:
        assert routes == {"routed": 0, "dropped": 0} and pct is None
