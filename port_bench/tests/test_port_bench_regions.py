"""``regions.split`` on made-up event tuples and on the events of a CPU
profile, and the readers of the regions' metrics on a made-up run."""

import pytest

from port_bench import regions, trace
from port_bench.cells import reader, resolve
from port_bench.run import Run

EW = "void at::native::vectorized_elementwise_kernel<4>"
GEMM = "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN"
STEPS = 2


def ev(kind, name, start, end, tid=1, corr=0, linked=0, seq=-1, fwd=0):
    return (kind, name, start, end, tid, corr, linked, seq, fwd)


def made_up():
    """A window [0, 200] on the forward thread 1 and the backward thread 2:

    - forward: ``gpt.qkv`` holds ``gpt.ln``; an op in each (sequence 5 and
      6), an op before them that makes no node but records sequence 6, and
      an op in no range that copies the batch in;
    - backward: the node of sequence 6 launches a kernel and a memset;
    - recompute: the node of sequence 5 opens ``gpt.ln`` again and sets
      memory inside it;
    - unattributed: a node whose forward op the trace lacks, and a kernel no
      op launched; one kernel runs past the window's end.
    """
    return [
        ev("range", trace.WINDOW, 0, 200),
        ev("range", "port_bench.step", 1, 199),
        ev("range", "gpt.qkv", 10, 20),
        ev("range", "gpt.ln", 11, 14),
        ev("op", "aten::slice", 5, 6, corr=100, seq=6),  # no node: the next one's number
        ev("op", "aten::mul", 12, 13, corr=101, seq=5),
        ev("op", "aten::mm", 16, 17, corr=102, seq=6),
        ev("op", "aten::copy_", 30, 31, corr=103),
        ev("node", "MmBackward0", 50, 70, tid=2, corr=201, seq=6, fwd=1),
        ev("op", "aten::mm", 55, 56, tid=2, corr=202),
        ev("op", "aten::zeros", 57, 58, tid=2, corr=203),
        ev("node", "MulBackward0", 80, 100, tid=2, corr=204, seq=5, fwd=1),
        ev("range", "gpt.ln", 82, 90, tid=2),
        ev("op", "aten::zero_", 85, 86, tid=2, corr=205),
        ev("node", "UnbindBackward0", 110, 120, tid=2, corr=206, seq=99, fwd=1),
        ev("op", "aten::stack", 111, 112, tid=2, corr=207),
        # device activities, each linked to the op that launched it
        ev("device", EW, 20, 22, linked=101),  # forward, gpt.ln
        ev("device", GEMM, 22, 25, linked=102),  # forward, gpt.qkv
        ev("device", "Memcpy HtoD (Pinned -> Device)", 31, 32, linked=103),  # unattributed
        ev("device", GEMM, 60, 64, tid=2, linked=202),  # backward of gpt.qkv's mm
        ev("device", "Memset (Device)", 64, 65, tid=2, linked=203),  # backward, gpt.qkv
        ev("device", "Memset (Device)", 90, 91, tid=2, linked=205),  # recompute, gpt.ln
        ev("device", EW, 112, 114, tid=2, linked=207),  # unattributed: no forward op
        ev("device", EW, 130, 131),  # unattributed: no launching op
        ev("device", EW, 199, 203, linked=101),  # clipped to 1 ns
    ]


def as_dict(rows):
    out = {}
    for r, p, g, v in rows:
        out[(r, p, g)] = out.get((r, p, g), 0.0) + v
    return out


def test_split_attributes_each_phase_and_partitions_the_window():
    rows = as_dict(regions.split(made_up(), STEPS))
    ms = 1e-6 / STEPS  # one nanosecond, a step
    assert rows == pytest.approx({
        ("gpt.ln", "forward", "other"): 3 * ms,  # 2 ns, and 1 of the clipped one
        ("gpt.qkv", "forward", "gemm"): 3 * ms,
        ("gpt.qkv", "backward", "gemm"): 4 * ms,
        ("gpt.qkv", "backward", "copy"): 1 * ms,
        ("gpt.ln", "recompute", "copy"): 1 * ms,
        (None, "unattributed", "copy"): 1 * ms,
        (None, "unattributed", "other"): 3 * ms,
    })
    device = [(a, min(b, 200)) for k, _, a, b, *_ in made_up() if k == "device"]
    assert sum(rows.values()) == pytest.approx(sum(b - a for a, b in device) * ms)


def test_split_finds_nothing_without_ranges_or_device_work():
    evts = made_up()
    no_ranges = [e for e in evts if e[0] != "range" or e[1].startswith("port_bench.")]
    assert regions.split(no_ranges, STEPS) is None
    assert regions.split([e for e in evts if e[0] != "device"], STEPS) is None
    assert regions.split([e for e in evts if e[1] != trace.WINDOW], STEPS) is None


def _run(cell_name, rows, routes=None):
    rank = {"trace": {"regions": rows},
            "window": {"peak_bytes": 1, "seconds": 1.0, "tokens": 1, "moe_routes": routes}}
    return Run(resolve(cell_name), [rank], fit_start=0.0)


NEW = ("optimizer_ew_ms", "loss_ew_ms", "norm_ew_ms", "block_ew_ms", "unattributed_ew_ms",
       "recompute_ms", "moe_route_ms", "moe_dropped_pct")


def test_readers_on_a_made_up_run():
    rows = [["train.optimizer", "forward", "other", 8.0],
            ["train.optimizer", "forward", "gemm", 0.5],
            ["gpt.head_loss", "forward", "other", 10.0],
            ["gpt.head_loss", "backward", "other", 20.0],
            ["gpt.head_loss", "backward", "gemm", 3.0],
            ["gpt.ln", "forward", "other", 16.0],
            ["gpt.ln", "recompute", "other", 16.0],
            ["gpt.ln", "backward", "other", 32.0],
            ["gpt.qkv", "recompute", "gemm", 2.0],
            ["gpt.mlp", "forward", "other", 5.0],
            ["moe.route", "backward", "other", 4.0],
            ["moe.dispatch", "forward", "gemm", 1.5],
            ["moe.combine", "recompute", "other", 2.5],
            ["moe.experts", "forward", "other", 3.0],
            [None, "unattributed", "other", 0.5],
            [None, "unattributed", "copy", 0.25]]
    run = _run("gpt2_small_moe8.pretrain", rows, {"routed": 4000, "dropped": 1000})
    got = {name: reader(name)(run) for name in NEW}
    assert got == pytest.approx({
        "optimizer_ew_ms": 8.0, "loss_ew_ms": 30.0, "norm_ew_ms": 64.0,
        "block_ew_ms": 5.0 + 4.0 + 2.5 + 3.0, "unattributed_ew_ms": 0.5,
        "recompute_ms": 16.0 + 2.0 + 2.5, "moe_route_ms": 4.0 + 1.5 + 2.5,
        "moe_dropped_pct": 25.0})
    ew = sum(v for _, _, g, v in rows if g == "other")
    assert sum(got[n] for n in NEW[:5]) == pytest.approx(ew)


def test_readers_with_nothing_to_read_return_nothing():
    dense = [["gpt.ln", "forward", "other", 1.0]]
    assert reader("moe_route_ms")(_run("gpt2_small.pretrain", dense)) is None
    assert reader("moe_dropped_pct")(
        _run("gpt2_small.pretrain", dense, {"routed": 0, "dropped": 0})) is None
    cell = resolve("gpt2_small_moe8.pretrain")
    untraced = Run(cell, [{"trace": None, "window": {"peak_bytes": None}}], fit_start=0.0)
    # A program with no ranges, whose trace has no regions (None), and no counter.
    silent = Run(cell, [{"trace": {"busy_us": 1.0, "regions": None},
                         "window": {"peak_bytes": 1, "moe_routes": None}}], fit_start=0.0)
    for run in (untraced, silent):
        for name in NEW:
            assert reader(name)(run) is None, name


def test_collect_keeps_its_keys_and_regions_need_device_work():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            for _ in range(3):
                with record_function("port_bench.step"):
                    (x @ x).relu_()
    t = trace.collect(prof, steps=3)
    assert set(t) == {"steps", "window_us", "busy_us", "names", "device", "ranges",
                      "idle_us_by_host_op"}
    assert regions.collect(prof, 3) is None


@pytest.mark.parametrize("experts,policy", [(0, "save_attn"), (4, "save_attn"), (0, "dots")],
                         ids=["dense-save_attn", "moe-save_attn", "dense-dots"])
def test_split_on_a_cpu_profile_of_a_train_step(experts, policy):
    """Every op of a nano step launches one made-up kernel of 1 ns: each
    region's forward, its recompute and its backward are found in the
    profile's own events, and only the stacking of per-layer gradients and
    the loss's seed go unattributed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ray_tpu_torch.models import GPTConfig, create_train_state, default_optimizer
    from ray_tpu_torch.models import make_train_step

    cfg = GPTConfig.nano(dtype=torch.float32, moe_experts=experts, remat_policy=policy)
    opt = default_optimizer()
    state = create_train_state(cfg, 0, opt, device="cpu")
    step = make_train_step(cfg, opt)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 33))}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            step(state, batch)
    evts = list(regions.events(prof))
    fake = [ev("device", EW, a, a + 1, tid, linked=corr)
            for k, _, a, _, tid, corr, *_ in evts if k in ("op", "node")]
    rows = regions.split(evts + fake, steps=1)
    placed = as_dict(rows)
    assert sum(placed.values()) == pytest.approx(len(fake) * 1e-6)
    phases = {p for _, p, _ in placed}
    assert phases == {"forward", "recompute", "backward", "unattributed"}
    expected = {"gpt.embed", "gpt.ln", "gpt.qkv", "gpt.out", "gpt.mlp", "gpt.head_loss"}
    if experts:
        expected |= {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"}
    backward = {r for r, p, _ in placed if p == "backward"}
    assert expected <= backward
    recomputed = {r for r, p, _ in placed if p == "recompute"}
    assert {"gpt.ln", "gpt.qkv", "gpt.out", "gpt.mlp"} <= recomputed
    assert ("gpt.attention" in recomputed) == (policy == "dots")
    assert "train.optimizer" in {r for r, p, _ in placed if p == "forward"}
    unattributed = placed.get((None, "unattributed", "other"), 0.0)
    assert unattributed < 0.1 * sum(placed.values())


def _cuda_moe_step(experts=4):
    import torch

    from ray_tpu_torch.models import GPTConfig, create_train_state, default_optimizer
    from ray_tpu_torch.models import make_train_step

    # Heads of 64, as the CUDA kernels take; bf16 over f32 params.
    cfg = GPTConfig(n_layer=2, n_head=2, d_model=128, vocab_size=256, max_seq_len=256,
                    moe_experts=experts)
    opt = default_optimizer()
    state = create_train_state(cfg, 0, opt, device="cuda")
    step = make_train_step(cfg, opt)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 257), device="cuda")}
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    return cfg, step, state, batch


@pytest.mark.card
def test_route_counts_on_the_card_equal_a_recount(card):
    import torch

    from ray_tpu_torch.models import gpt, moe

    cfg, step, state, batch = _cuda_moe_step()
    routed = dropped = 0
    counted = {"routed": 0, "dropped": 0}
    plain = moe.route
    for _ in range(3):
        seen = []

        def recording(*args, **kw):
            r = plain(*args, **kw)
            seen.append((r.keep.numel(), int((~r.keep).sum())))
            return r

        moe.route = recording
        try:
            with torch.no_grad():
                gpt.forward(state.params, batch["tokens"][:, :-1], cfg)
        finally:
            moe.route = plain
        routed += sum(n for n, _ in seen)
        dropped += sum(d for _, d in seen)
        moe.reset_route_counts()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        counted = {k: v + moe.route_counts()[k] for k, v in counted.items()}
    assert counted == {"routed": routed, "dropped": dropped}
    assert routed == 3 * 4 * 256 * cfg.n_layer and 0 < dropped < routed


@pytest.mark.card
def test_regions_split_a_cuda_trace_of_a_train_step(card):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    _, step, state, batch = _cuda_moe_step()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            for _ in range(2):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
    evts = list(regions.events(prof))
    rows = regions.split(evts, steps=2)
    window = next((a, b) for k, n, a, b, *_ in evts if n == trace.WINDOW)
    device = [(max(a, window[0]), min(b, window[1])) for k, _, a, b, *_ in evts
              if k == "device" and b > window[0] and a < window[1]]
    assert sum(r[3] for r in rows) == pytest.approx(sum(b - a for a, b in device) / 1e6 / 2)
    placed = as_dict(rows)
    assert {"forward", "recompute", "backward"} <= {p for _, p, _ in placed}
    assert {"gpt.ln", "gpt.qkv", "gpt.attention", "moe.route", "moe.experts", "gpt.head_loss",
            "train.optimizer"} <= {r for r, _, _ in placed}
    ew = sum(v for (_, _, g), v in placed.items() if g == "other")
    assert placed.get((None, "unattributed", "other"), 0.0) < 0.05 * ew
