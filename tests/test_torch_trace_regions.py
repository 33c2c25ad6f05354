"""The train step's regions (``util.tracing.region``) and the MoE's route
counter (``models.moe.route_counts``) on the CPU, at the nano size, dense and
with 4 experts, under the ``save_attn`` and ``dots`` remat policies.

Under a profiler that traces the host, every region opens as a
``record_function`` range and each autograd node of the backward links, by
its sequence number and forward thread, to the forward op that made it;
without a profiler no range opens. The counter counts each forward's tokens
once, a checkpoint's recompute not again, and its drops equal a recount from
``route()``'s ``keep``; it counts nothing before its first reset, and counts
forwards under ``torch.inference_mode`` and training forwards alike.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.models import GPTConfig, create_train_state, default_optimizer, gpt, moe
from ray_tpu_torch.models import make_train_step
from ray_tpu_torch.util import tracing

E = 4
B, S = 2, 32
DENSE_REGIONS = {"gpt.embed", "gpt.ln", "gpt.qkv", "gpt.attention", "gpt.out", "gpt.mlp",
                 "gpt.head_loss", "train.optimizer"}
MOE_REGIONS = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"}
# Nodes whose forward op runs between the regions: the per-layer views of
# the stacked weights, and the sums of the MoE's aux losses into the loss.
PLUMBING = {"UnbindBackward0", "AddBackward0", "MulBackward0"}
CASES = [(experts, policy) for experts in (0, E) for policy in ("save_attn", "dots")]
IDS = [f"{'moe' if e else 'dense'}-{p}" for e, p in CASES]


def _config(experts, policy):
    return GPTConfig.nano(dtype=torch.float32, moe_experts=experts, remat_policy=policy)


def _step(cfg):
    """A train step, its state and a batch, after one step that warms it."""
    opt = default_optimizer(learning_rate=1e-3)
    state = create_train_state(cfg, 0, opt, device="cpu")
    step = make_train_step(cfg, opt)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=torch.Generator().manual_seed(1))}
    state, _ = step(state, batch)
    return step, state, batch


def _host_events(prof):
    return [e for e in prof.profiler.kineto_results.events()]


@pytest.mark.parametrize("experts,policy", CASES, ids=IDS)
def test_every_region_opens_under_a_host_profiler(experts, policy):
    step, state, batch = _step(_config(experts, policy))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    ranges = {e.name() for e in _host_events(prof) if e.is_user_annotation()}
    expected = DENSE_REGIONS | (MOE_REGIONS if experts else set())
    assert ranges == expected


def _inside(spans, t):
    return [name for name, a, b in spans if a <= t <= b]


@pytest.mark.parametrize("experts,policy", CASES, ids=IDS)
def test_backward_nodes_link_to_forward_ops_in_regions(experts, policy):
    step, state, batch = _step(_config(experts, policy))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    evts = _host_events(prof)
    ranges = {}
    for e in evts:
        if e.is_user_annotation():
            ranges.setdefault(e.start_thread_id(), []).append(
                (e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    nodes = [e for e in evts if e.scope() == 1]  # at::RecordScope::BACKWARD_FUNCTION
    # Ops that make no node record the sequence number the next node will
    # take: the node's own op is the last of its number to start.
    forward = {}
    for e in evts:
        if not e.is_user_annotation() and e.scope() == 0 and e.sequence_nr() >= 0 \
                and not e.name().startswith("autograd::engine::evaluate_function"):
            key = (e.start_thread_id(), e.sequence_nr())
            if key not in forward or e.start_ns() >= forward[key].start_ns():
                forward[key] = e
    assert nodes
    outside = set()
    for node in nodes:
        op = forward.get((node.fwd_thread_id(), node.sequence_nr()))
        assert op is not None, f"{node.name()}: no forward op of sequence {node.sequence_nr()}"
        if not _inside(ranges.get(op.start_thread_id(), []), op.start_ns()):
            outside.add(node.name())
    assert outside <= PLUMBING, outside - PLUMBING
    assert "UnbindBackward0" in outside


@pytest.mark.parametrize("experts", [0, E], ids=["dense", "moe"])
def test_no_range_opens_without_a_profiler(monkeypatch, experts):
    step, state, batch = _step(_config(experts, "save_attn"))
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    step(state, batch)
    assert opened == []
    assert tracing.region("gpt.ln") is tracing.region("moe.route")
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, batch)
    assert set(opened) == DENSE_REGIONS | (MOE_REGIONS if experts else set())


def _recount(cfg, params, tokens):
    """Each MoE layer's (routed, dropped) from ``route()``'s ``keep``, for one
    forward of ``tokens``."""
    seen, plain = [], moe.route

    def recording(*args, **kw):
        r = plain(*args, **kw)
        seen.append((r.keep.numel(), int((~r.keep).sum())))
        return r

    moe.route = recording
    try:
        with torch.no_grad():
            gpt.forward(params, tokens, cfg)
    finally:
        moe.route = plain
    return seen


@pytest.mark.parametrize("policy", ["save_attn", "dots", None], ids=["save_attn", "dots", "none"])
def test_route_counts_equal_a_recount_and_ignore_the_recompute(policy):
    cfg = GPTConfig.nano(dtype=torch.float32, moe_experts=E, remat=policy is not None,
                         remat_policy=policy, moe_capacity_factor=0.5)
    step, state, batch = _step(cfg)
    steps = 3
    routed = dropped = 0
    counted = {"routed": 0, "dropped": 0}
    for _ in range(steps):
        per_layer = _recount(cfg, state.params, batch["tokens"][:, :-1])
        assert len(per_layer) == cfg.n_layer
        routed += sum(n for n, _ in per_layer)
        dropped += sum(d for _, d in per_layer)
        moe.reset_route_counts()  # the recount's own forward counted too
        state, _ = step(state, batch)
        counted = {k: v + moe.route_counts()[k] for k, v in counted.items()}
    assert counted["routed"] == routed == B * S * cfg.n_layer * steps
    assert counted == {"routed": routed, "dropped": dropped}
    assert 0 < dropped < routed  # capacity 0.5 drops some of each row's tokens
    moe.reset_route_counts()
    assert moe.route_counts() == {"routed": 0, "dropped": 0}


def test_a_dense_step_counts_no_routes():
    step, state, batch = _step(_config(0, "save_attn"))
    moe.reset_route_counts()
    step(state, batch)
    assert moe.route_counts() == {"routed": 0, "dropped": 0}


def test_counting_starts_at_the_first_reset(monkeypatch):
    step, state, batch = _step(_config(E, "save_attn"))
    monkeypatch.setitem(moe._ROUTES, "on", False)
    monkeypatch.setitem(moe._ROUTES, "routed", 0)
    monkeypatch.setitem(moe._ROUTES, "kept", {})
    step(state, batch)
    assert moe._ROUTES["kept"] == {} and moe.route_counts() == {"routed": 0, "dropped": 0}
    moe.reset_route_counts()
    step(state, batch)
    assert moe.route_counts()["routed"] == B * S * GPTConfig.nano().n_layer


def test_counts_under_inference_mode_then_training_at_the_same_shape():
    cfg = GPTConfig.nano(dtype=torch.float32, moe_experts=E, moe_capacity_factor=0.5)
    step, state, batch = _step(cfg)
    tokens = batch["tokens"][:, :-1]
    moe.reset_route_counts()
    with torch.inference_mode():
        gpt.forward(state.params, tokens, cfg)
    state, _ = step(state, batch)  # a training forward of the same shape adds to the same counts
    shorter = tokens[:, : S // 2]
    with torch.inference_mode():
        gpt.forward(state.params, shorter, cfg)
    state, _ = step(state, batch)
    counts = moe.route_counts()
    assert counts["routed"] == (3 * B * S + B * S // 2) * cfg.n_layer
    assert 0 < counts["dropped"] < counts["routed"]
    assert [t.numel() for t in moe._ROUTES["kept"].values()] == [B * S]
