"""The host-side helpers of chip_smoke.py, on the CPU: the ptxas report its
build phase prints, the relative error its kernel checks use, the trainer
phase's check that its own workers are gone after shutdown, the RL
phases' numpy CartPole, runner setup and learner check, the pipeline
and context phases' ring check, launch counts and gangs, the expert,
tensor-ResNet, elastic and mesh-learner phases' gangs and their checks, and
the predictor, Data, Serve and Tune phases at nano size."""

import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__c4b42d03_18_flash_attention_cu_b294bfd022flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__c4b42d03_18_flash_attention_cu_b294bfd022flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 167 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__c4b42d03_18_flash_attention_cu_b294bfd022flash_bwd_wgmma_kernelILi128EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__c4b42d03_18_flash_attention_cu_b294bfd022flash_bwd_wgmma_kernelILi128EEEv14CUtensorMap_st
    664 bytes stack frame, 1428 bytes spill stores, 1428 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 664 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__c4b42d03_18_flash_attention_cu_b294bfd027flash_bwd_dq_convert_kernelEPK6float4P5uint2m' for 'sm_90a'
ptxas info    : Used 14 registers, 8 bytes smem, 380 bytes cmem[0]
"""


def test_ptxas_report_names_each_kernel():
    report = chip_smoke.ptxas_report(LOG)
    assert report["flash_fwd_wgmma_kernel<64>"] == {
        "spill_store_load_bytes": [0, 0], "registers": 167, "static_smem_bytes": 0}
    assert report["flash_bwd_wgmma_kernel<128>"]["spill_store_load_bytes"] == [1428, 1428]
    assert report["flash_bwd_dq_convert_kernel"] == {"registers": 14, "static_smem_bytes": 8}


@pytest.mark.parametrize("floor,expected", [(0.0, 0.5), (4.0, 0.25)])
def test_rel_err_floor(floor, expected):
    # ||a - b|| / max(||b||, floor): a floor only matters where b is near zero.
    b = torch.tensor([2.0, 0.0])
    a = torch.tensor([3.0, 0.0])
    assert chip_smoke.rel_err(a, b, floor) == pytest.approx(expected)


def test_trainer_cleanup_check_sees_only_this_runs_workers():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote
        class Pid:
            def pid(self):
                return os.getpid()

        pid = ray_tpu_torch.get(Pid.remote().pid.remote())
        pids = chip_smoke.runtime_worker_pids()
        assert pid in pids and all(chip_smoke.pid_alive(p) for p in pids)
        assert not chip_smoke.pid_alive(-1)
    finally:
        ray_tpu_torch.shutdown()
    deadline = time.time() + 10
    while any(chip_smoke.pid_alive(p) for p in pids) and time.time() < deadline:
        time.sleep(0.05)
    assert not any(chip_smoke.pid_alive(p) for p in pids)


def test_attention_bounds_at_the_llama_shape():
    # bh 32, S 8192, d 128, causal: forward 2 products of 2 * d operations per
    # kept (query, key) pair, 0.55 TFLOP, 0.556 ms at 989 TFLOP/s, against
    # q, k, v, o (268 MB) and the lse, 0.08 ms at 3.35 TB/s; backward 5
    # products, 1.37 TFLOP, 1.39 ms.
    (fwd_ms, fwd_by), (bwd_ms, bwd_by) = chip_smoke.attention_bounds(32, 8192, 128)
    pairs = 32 * 8192 * 8193 / 2
    assert fwd_ms == pytest.approx(4 * 128 * pairs / 989e12 * 1e3) == pytest.approx(0.5559, abs=1e-4)
    assert bwd_ms == pytest.approx(1.3898, abs=1e-4)
    assert fwd_by == bwd_by == "operations"
    # GPT-2 small's shape: the forward is bound by its bytes (PERF.md).
    (fwd_ms, fwd_by), (bwd_ms, bwd_by) = chip_smoke.attention_bounds(192, 1024, 64)
    assert (round(fwd_ms, 4), fwd_by) == (0.0303, "bytes")
    assert (round(bwd_ms, 4), bwd_by) == (0.0652, "operations")


def _kernel(**over):
    k = {"name": "flash_fwd", "route": "cuda", "source": "s.cu", "replaces": "f.py:59",
         "launches": 156, "max_abs_err": 0.01, "ms": 0.09, "plain_ms": 5.0, "bound_ms": 0.03,
         "bound_by": "bytes", "library_ms": 0.08,
         "launches_per_path": {"main_path": 156, "trainer": 156, "llama": 32, "moe": 96}}
    k.update(over)
    return k


PATHS = ["main_path", "trainer", "llama", "moe"]


def test_kernels_line_check_passes_a_whole_line():
    line = {"kernels": [_kernel(), _kernel(name="flash_bwd", bound_by="operations",
                                           library_ms=None)]}
    assert chip_smoke.check_kernels_line(line, PATHS) == []


@pytest.mark.parametrize("over,problem", [
    ({"library_ms": "drop"}, "flash_fwd: no library_ms"),
    ({"route": "library"}, "flash_fwd: route 'library'"),
    ({"bound_by": "time"}, "flash_fwd: bound_by 'time'"),
    ({"ms": 0}, "flash_fwd: ms 0"),
    ({"launches_per_path": {"main_path": 156, "trainer": 156, "llama": 0, "moe": 96}},
     "flash_fwd: no launch on llama"),
    ({"launches_per_path": {"main_path": 156, "trainer": 156, "llama": 32}},
     "flash_fwd: no launch on moe"),
])
def test_kernels_line_check_names_what_is_missing(over, problem):
    k = _kernel(**over)
    if over.get("library_ms") == "drop":
        del k["library_ms"]
    assert problem in chip_smoke.check_kernels_line({"kernels": [k]}, PATHS)


def test_llama_init_loss_expected():
    # ln 128256 plus half the logits' variance, 0.02^2 * 4096.
    import math

    assert chip_smoke.init_loss_expected(128256, 4096) == pytest.approx(
        math.log(128256) + 0.8192)


def test_shutdown_waits_for_worker_processes_still_exiting():
    # The trainer phase kills its worker actor at the end of fit() and checks
    # right after shutdown() that the process is gone. A CUDA worker takes a
    # while to exit after its kill (a CPU one dies at once), so shutdown()
    # waits for the processes it killed: here one that takes a second.
    import subprocess

    import ray_tpu_torch
    from ray_tpu_torch._private import scheduler, worker

    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote
        class Pid:
            def pid(self):
                return os.getpid()

        actor = Pid.remote()
        pid = ray_tpu_torch.get(actor.pid.remote())
        slow = scheduler._Proc(subprocess.Popen([sys.executable, "-c", "import time; time.sleep(1)"]))
        worker.global_worker.context.scheduler._exiting.append(slow)
        ray_tpu_torch.kill(actor)
    finally:
        ray_tpu_torch.shutdown()
    assert not slow.is_alive()
    assert not chip_smoke.pid_alive(pid)


# ------------------------------------------------------------------ the RL phases
def test_cartpole_reseeds_and_truncates():
    env = chip_smoke.CartPole(max_episode_steps=5)
    first = env.reset(seed=3)[0]
    np.testing.assert_array_equal(first, chip_smoke.CartPole().reset(seed=3)[0])
    assert first.dtype == np.float32 and np.all(np.abs(first) < 0.05)
    flags = [env.step(i % 2)[2:4] for i in range(5)]
    assert flags[-1] == (False, True) and not any(any(f) for f in flags[:-1])
    assert chip_smoke.CartPole().max_episode_steps == 500
    assert env.action_space.n == 2 and env.observation_space.shape == (4,)
    # A reset without a seed continues the generator of the last seeded one.
    assert not np.array_equal(env.reset()[0], first)


def test_runner_runs_on_the_cpu_with_the_threads_it_holds():
    from ray_tpu_torch.rllib import EnvRunner, MLPModule

    threads = torch.get_num_threads()
    try:
        runner = EnvRunner(chip_smoke.CartPole, MLPModule(4, 2), num_envs=2, rollout_length=8,
                           num_cpus=2)
        placement = runner.placement()
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(threads)
    assert placement["device"] == "cpu" and placement["num_threads"] == 2
    batch = runner.sample()
    assert batch["obs"].shape == (8, 2, 4) and batch["actions"].dtype == np.int64


def test_rl_rel_err_has_a_floor_of_one():
    assert chip_smoke.rl_rel_err(2.0, 4.0) == pytest.approx(0.5)
    assert chip_smoke.rl_rel_err(1e-3, 0.0) == pytest.approx(1e-3)
    assert chip_smoke.rl_rel_err(np.array([1.0, 3.0]), np.array([1.0, 2.0])) == pytest.approx(0.5)


def test_rl_learner_check_runs_on_the_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny learners: more threads only spin under parallel workers
    try:
        lines = chip_smoke.phase_rl_learner_check("cpu", device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert [line["loss"] for line in lines] == list(chip_smoke.RL_CHECK_KINDS) == [
        "ppo", "dqn", "c51", "a2c", "pg", "impala", "appo", "marwil", "sac", "td3", "cql"]
    # IMPALA's and APPO's batches are env-major: 16 envs of 64 steps.
    assert [line["rows"] for line in lines] == [128, 64, 64, 512, 512, 16, 16, 512, 128, 128, 256]
    assert lines[5]["batch_shape"] == [16, 64]
    for line in lines:
        assert line["updates"] == chip_smoke.RL_UPDATES and line["param_max_abs_err"] == 0
        assert set(line["max_rel_err_per_key"]) >= {"total_loss", "grad_norm"}


@pytest.fixture
def rl_on_the_cpu(monkeypatch):
    """The RL phases' learners on the CPU (as ``num_gpus_per_learner=0``
    gives), one torch thread, and a runtime of 4 CPUs; after the test, the
    runtime shut down and the workers the phases reported checked gone, as
    rl_shutdown checks them."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib.algorithms import algorithm
    from ray_tpu_torch.rllib.core import learner_group

    monkeypatch.setattr(algorithm, "default_device", lambda: torch.device("cpu"))
    monkeypatch.setattr(learner_group, "learner_device", lambda num_gpus: "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
    lines = []
    try:
        yield lines
    finally:
        ray_tpu_torch.shutdown()
        torch.set_num_threads(threads)
    pids = {pid for line in lines for pid in line["worker_pids"]}
    assert pids and not os.path.exists(session_dir)
    deadline = time.time() + 10
    while any(chip_smoke.pid_alive(p) for p in pids) and time.time() < deadline:
        time.sleep(0.1)
    assert not [p for p in pids if chip_smoke.pid_alive(p)]


RL_LINE_KEYS = {"phase", "placement", "iterations", "returns", "sample_s", "learn_s",
                "env_steps_per_s", "updates_per_s", "per_iteration", "worker_pids", "wall_s",
                "card"}


def test_rl_onpolicy_and_continuous_run_on_the_cpu(rl_on_the_cpu):
    # The phases at one iteration each (two for SAC and TD3: the first only
    # fills their buffers past learning_starts), bars off: lines and checks.
    lines = chip_smoke.phase_rl_onpolicy("cpu", device="cpu", max_iters=1, bars=False)
    lines += chip_smoke.phase_rl_continuous("cpu", device="cpu", max_iters=2, bars=False)
    rl_on_the_cpu += lines
    assert [(x["phase"], x["algo"]) for x in lines] == [
        ("rl_onpolicy", "a2c"), ("rl_onpolicy", "pg"), ("rl_onpolicy", "impala"),
        ("rl_onpolicy", "appo"), ("rl_continuous", "sac"), ("rl_continuous", "td3")]
    for line in lines:
        assert RL_LINE_KEYS <= set(line)
        assert line["iterations"] == (2 if line["phase"] == "rl_continuous" else 1)
        assert line["placement"]["learners"][0]["device"] == "cpu"
        assert [r["cuda_visible_devices"] for r in line["placement"]["runners"]] == ["", ""]
    assert [x["env_steps_per_iteration"] for x in lines] == [512, 8192, 1024, 1024, 256, 256]
    assert "mean_rho" in lines[2]["per_iteration"][0]
    assert {"mean_is_ratio", "kl_coeff"} <= set(lines[3]["per_iteration"][0])
    assert lines[4]["per_iteration"][1]["alpha"] > 0


def test_rl_apex_and_offline_run_on_the_cpu(rl_on_the_cpu, monkeypatch):
    from ray_tpu_torch.models import params_to_numpy
    from ray_tpu_torch.rllib import MLPModule

    apex = chip_smoke.phase_rl_apex("cpu", device="cpu", iters=3)
    assert RL_LINE_KEYS <= set(apex) and apex["iterations"] == 3
    assert [s["cuda_visible_devices"] for s in apex["placement"]["shards"]] == ["", ""]
    assert apex["worker_epsilons"] == apex["epsilon_schedule"]
    monkeypatch.setattr(chip_smoke, "OFFLINE_EPISODES", 4)
    # Four short episodes hold fewer rows than a 512-row batch, which a
    # Dataset's reader (drop_last) needs whole.
    config = chip_smoke.offline_config
    monkeypatch.setattr(chip_smoke, "offline_config",
                        lambda name, path: config(name, path).training(train_batch_size=16))
    weights = params_to_numpy(MLPModule(4, 2).init(0, device="cpu"))
    lines = chip_smoke.phase_rl_offline("cpu", weights, device="cpu", iters=1, bars=False)
    rl_on_the_cpu += [apex] + lines
    assert [(x["algo"], x["data"]) for x in lines] == [
        ("bc", "ppo"), ("marwil", "mixed"), ("cql", "cql"), ("bc", "ppo_dataset")]
    assert [x["reader"] for x in lines] == ["JsonReader"] * 3 + ["DatasetReader"]
    assert lines[-1]["dataset_rows"] > 0
    for line in lines:
        assert RL_LINE_KEYS <= set(line) and line["placement"]["runners"] == []
        assert [r["cuda_visible_devices"] for r in line["placement"]["evaluation_runners"]] == [""]
        assert line["evaluation_return_mean"] is not None and line["env_steps_per_s"] is None


def test_rl_iteration_reads_a_result():
    row = chip_smoke.rl_iteration({"training_iteration": 2, "sample_time_s": 0.5,
                                   "time_this_iter_s": 0.6}, 512)
    assert row["env_steps_per_s"] == 1024 and row["learn_s"] is None
    assert row["updates_per_s"] is None and row["return"] is None


def test_kernels_line_check_needs_the_mesh_gang_path():
    paths = PATHS + ["mesh_gang"]
    per_path = {"main_path": 156, "trainer": 156, "llama": 32, "moe": 96, "mesh_gang": 48}
    assert chip_smoke.check_kernels_line({"kernels": [_kernel(launches_per_path=per_path)]},
                                         paths) == []
    assert "flash_fwd: no launch on mesh_gang" in chip_smoke.check_kernels_line(
        {"kernels": [_kernel()]}, paths)


def test_collective_ms_reads_the_gloo_calls_of_a_profile():
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.util.collective.collective_group.nccl_group import NCCLGroup

    g = NCCLGroup(1, 0, "chip_smoke_profile", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            g.allreduce(torch.ones(1 << 16))
    out = chip_smoke.collective_ms_per_step(prof, 2)
    assert out["host_ms"] > 0 and out["nccl_kernel_ms"] == 0
    g.destroy()


def test_mesh_gang_loop_runs_on_the_cpu():
    # The mesh_gang phase's gang at a toy size on the CPU: get_mesh() over
    # two gloo ranks, each rank's report through the KV store, the steps'
    # losses the same on both ranks, nothing left after shutdown.
    from ray_tpu_torch.air import ScalingConfig

    cut = dict(n_layer=2, n_head=2, d_model=64, vocab_size=256, max_seq_len=128)
    config = {"model": "gpt2_small", "cut": cut, "global_batch": 4, "seq": 32, "warmup": 1,
              "timed": 1, "device": "cpu"}
    out = chip_smoke.run_mesh_gang(ScalingConfig(num_workers=2, mesh={"data": 2}), "gloo",
                                   config, "test_mesh_gang")
    r0, r1 = out["ranks"]
    assert (r0["rank"], r1["rank"], r0["world"], r0["backend"]) == (0, 1, 2, "gloo")
    from ray_tpu_torch.parallel import AXIS_ORDER

    assert r0["mesh_is_device_mesh"] and r0["mesh_dim_names"] == list(AXIS_ORDER)
    assert r0["mesh_shape"] == [2, 1, 1, 1, 1, 1]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    assert r0["tokens_per_gpu_per_step"] == 2 * 32
    assert r0["collective_ms_per_step"]["host_ms"] > 0
    assert not out["leftover_session_dirs"] and not out["leftover_worker_pids"]


# ------------------------------------------------------------------ pipeline and context
def test_ring_check_runs_on_the_cpu():
    # The ring's block loop and merge over virtual slices against the plain
    # ring and one full call, at the cases' shapes cut by 16 (the kernels'
    # plain versions; no times without a card).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lines = chip_smoke.phase_ring_check("cpu", device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert [line["case"] for line in lines] == ["llama3_8b", "gpt2_small", "f32"]
    assert [line["blocks"] for line in lines] == [10, 3, 10]
    assert all(line["ok"] and "ms" not in line for line in lines)


@pytest.mark.parametrize("mesh,n_layer,batch,expected", [
    ({"pipeline": 2}, 12, 16, [24, 24]),  # 6 layers x M 4
    ({"context": 2}, 12, 16, [12, 24]),  # rank r: r + 1 blocks a layer
    ({"data": 2, "context": 2}, 12, 64, [12, 24, 12, 24]),  # context is inside data
    ({"pipeline": 2, "data": 2}, 12, 64, [12] * 4),  # M 4 over 2 data ranks
    ({"pipeline": 4}, 32, 4, [32] * 4),  # 8 layers x M 4 (2P does not divide 4)
    ({"context": 4}, 4, 1, [4, 8, 12, 16]),
    ({"data": 4}, 12, 64, [12] * 4),
])
def test_pipe_ctx_expected_launches(mesh, n_layer, batch, expected):
    assert chip_smoke.pipe_ctx_expected_launches(mesh, n_layer, batch) == expected


def test_bubble_share():
    assert chip_smoke.bubble_share(2, 4) == pytest.approx(0.2)
    assert chip_smoke.bubble_share(4, 4) == pytest.approx(3 / 7)


def test_span_overlap_counts_time_both_run():
    # NCCL 0-10 and 20-30 us; attention 5-25 us: 5 + 5 us at once.
    both, a, b = chip_smoke.span_overlap_ms([(20, 30), (0, 10)], [(5, 15), (12, 25)])
    assert (both, a, b) == (pytest.approx(0.01), pytest.approx(0.02), pytest.approx(0.02))


def test_kernels_line_check_needs_the_pipeline_and_context_paths():
    paths = PATHS + ["pipeline_gang", "context_gang"]
    per_path = {"main_path": 156, "trainer": 156, "llama": 32, "moe": 96, "pipeline_gang": 72,
                "context_gang": 36}
    assert chip_smoke.check_kernels_line({"kernels": [_kernel(launches_per_path=per_path)]},
                                         paths) == []
    del per_path["context_gang"]
    assert "flash_fwd: no launch on context_gang" in chip_smoke.check_kernels_line(
        {"kernels": [_kernel(launches_per_path=per_path)]}, paths)


@pytest.mark.parametrize("mesh", [{"pipeline": 2}, {"context": 2}])
def test_pipe_ctx_gang_loop_runs_on_the_cpu(mesh):
    # The pipe_ctx_gang phase's gangs at a toy size on the CPU: the stages
    # (or context ranks) report the same losses, nothing is left after.
    from ray_tpu_torch.air import ScalingConfig

    cut = dict(n_layer=2, n_head=2, d_model=64, vocab_size=256, max_seq_len=128)
    config = {"model": "gpt2_small", "cut": cut, "global_batch": 4, "seq": 32, "warmup": 1,
              "timed": 1, "device": "cpu"}
    out = chip_smoke.run_mesh_gang(ScalingConfig(num_workers=2, mesh=mesh), "gloo", config,
                                   "test_pipe_ctx_gang")
    r0, r1 = out["ranks"]
    axis = next(iter(mesh))
    from ray_tpu_torch.parallel import AXIS_ORDER

    assert r0["mesh_shape"][AXIS_ORDER.index(axis)] == 2
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    assert all(x == x for x in r0["losses"])  # finite
    assert not out["leftover_session_dirs"] and not out["leftover_worker_pids"]


# ------------------------------------------------------------------ the rest of the mesh
@pytest.fixture
def no_cuda_clock(monkeypatch):
    """The CUDA clock and memory calls the phases make in this process, as
    no-ops on the CPU; one torch thread."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("model,mesh", [("moe", {"expert": 2}), ("resnet", {"tensor": 2})])
def test_expert_tp_gang_loops_run_on_the_cpu(model, mesh):
    # The expert_tp_gang phase's gangs at a toy size: each expert rank holds
    # half of the experts and the whole batch, each tensor rank half of every
    # convolution's output channels; both ranks report the same losses.
    from ray_tpu_torch.air import ScalingConfig

    if model == "moe":
        cut = dict(n_layer=2, n_head=2, d_model=64, vocab_size=256, max_seq_len=128,
                   moe_experts=4)
        config = {"model": "gpt2_small", "cut": cut, "global_batch": 4, "seq": 32}
    else:
        cut = dict(stage_sizes=(1, 1), bottleneck=False, width=8, groupnorm_groups=4,
                   num_classes=10)
        config = {"model": "resnet50", "cut": cut, "global_batch": 4, "seq": 1, "image": 32}
    config.update(warmup=1, timed=1, device="cpu")
    out = chip_smoke.run_mesh_gang(ScalingConfig(num_workers=2, mesh=mesh), "gloo", config,
                                   "test_expert_tp_gang")
    r0, r1 = out["ranks"]
    assert r0["losses"] == r1["losses"] and all(x == x for x in r0["losses"])
    if model == "moe":
        assert r0["local_shapes"]["moe.fc_w"] == [2, 2, 64, 256]  # (L, E / expert, d, F)
        assert r0["tokens_per_gpu_per_step"] == 4 * 32 // 2
    else:
        assert r0["local_shapes"] == {"stem.conv": [7, 7, 3, 4], "head.w": [16, 5]}
    assert not out["leftover_session_dirs"] and not out["leftover_worker_pids"]


def _digest_tree(w):
    return {"params": {"wte": torch.as_tensor(w)}, "count": 3}


def test_state_digest_is_the_bits():
    w = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    d = chip_smoke.state_digest(_digest_tree(w))
    assert d == chip_smoke.state_digest(_digest_tree(w.copy()))
    flipped = w.copy()
    flipped.view(np.int32)[1, 2] ^= 1  # one bit of one element
    assert chip_smoke.state_digest(_digest_tree(flipped)) != d
    assert chip_smoke.state_digest({"params": {"wte": torch.as_tensor(w)}, "count": 4}) != d


def test_check_resume_holds_the_resumed_state_to_what_the_ranks_held():
    # World 2 held states a, b at steps 1, 2; rank 1 was lost during step 3
    # (rank 0's step-3 state is not one the gang held); world 1 resumed at 2.
    name = "g"
    kv = {"g/digest/2/1/0": "a", "g/digest/2/1/1": "a", "g/digest/2/2/0": "b",
          "g/digest/2/2/1": "b", "g/digest/2/3/0": "x", "g/digest/1/3/0": "c",
          "g/resumed/0": {"step": 2, "digest": "b"}, "g/0": {}}
    assert chip_smoke.check_resume(kv, name) == []
    assert "differs from what the ranks held" in chip_smoke.check_resume(
        {**kv, "g/resumed/0": {"step": 2, "digest": "c"}}, name)[0]
    assert "the ranks' states differ" in chip_smoke.check_resume(
        {**kv, "g/digest/2/1/1": "z"}, name)[0]
    assert chip_smoke.check_resume({k: v for k, v in kv.items() if "resumed" not in k},
                                   name) == ["no resume was recorded"]
    assert chip_smoke.elastic_records(kv, name, "digest")[(2, 3)] == {0: "x"}


def test_elastic_reshard_runs_on_the_cpu(no_cuda_clock, capsys):
    # The whole elastic_reshard phase at a toy size (its checks raise):
    # rank 1 killed after round 3, the gang re-formed at world 1 from the
    # in-memory mirrors, the resumed state equal to what both ranks held, the
    # final loss equal to an uninterrupted one-rank run's.
    import json

    launches = chip_smoke.phase_elastic_reshard("cpu", device="cpu")
    assert launches == {"flash_fwd": 0, "flash_bwd": 0}  # the plain versions on the CPU
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "elastic_reshard" and line["resume_problems"] == []
    assert line["resumed"]["step"] in (2, 3) and line["resumed_world"] == 1
    assert len(line["resumed_rank_losses"]) == chip_smoke.ELASTIC_STEPS - line["resumed"]["step"]


def test_rl_mesh_learner_runs_on_the_cpu(no_cuda_clock):
    lines = chip_smoke.phase_rl_mesh_learner("cpu", device="cpu")
    assert [line["loss"] for line in lines] == ["ppo", "dqn", "dqn_weighted"]
    assert [line["rows_per_rank"] for line in lines] == [64, 32, 32]
    for line in lines:
        assert line["ranks_hold_equal_weights"]
        assert set(line["max_rel_err_per_key"]) >= {"total_loss", "grad_norm"}


def test_kernels_line_check_needs_the_expert_and_elastic_paths():
    per_path = {p: 12 for p in chip_smoke.KERNEL_PATHS}
    assert chip_smoke.check_kernels_line({"kernels": [_kernel(launches_per_path=per_path)]},
                                         chip_smoke.KERNEL_PATHS) == []
    for path in ("expert_gang", "elastic_reshard"):
        assert f"flash_fwd: no launch on {path}" in chip_smoke.check_kernels_line(
            {"kernels": [_kernel(launches_per_path={**per_path, path: 0})]},
            chip_smoke.KERNEL_PATHS)


def test_gang_loops_reach_a_worker_by_value():
    # Run as a script, chip_smoke is __main__: cloudpickle sends its
    # functions by value, with only the globals they name, so each loop
    # reaches a worker with the helpers it calls.
    import functools

    import cloudpickle

    cloudpickle.register_pickle_by_value(chip_smoke)
    try:
        sent = {name: cloudpickle.loads(cloudpickle.dumps(functools.partial(
            chip_smoke._per_rank_reports, getattr(chip_smoke, name))))
            for name in ("mesh_train_loop", "elastic_train_loop", "rl_mesh_learner_loop")}
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    for name, f in sent.items():
        assert f.func is not chip_smoke._per_rank_reports
        assert f.args[0] is not getattr(chip_smoke, name) and f.args[0].__name__ == name
    for name, helper in (("mesh_train_loop", "run_steps"), ("elastic_train_loop", "device_sync"),
                         ("rl_mesh_learner_loop", "rl_learner_inputs")):
        assert helper in sent[name].args[0].__globals__

# ------------------------------------------------------------------ the predictor, multi-agent RL
@pytest.fixture
def counted_cpu_attention(monkeypatch):
    """Each call of the attention's plain version on the CPU counted as a
    launch of its kernel, so a CPU rehearsal reads the launch counts the
    card's run reads."""
    import importlib

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")  # the module
    # Set to themselves first, so monkeypatch restores them afterwards.
    monkeypatch.setattr(fa, "_fwd", fa._fwd)
    monkeypatch.setattr(fa, "_bwd", fa._bwd)
    chip_smoke.count_plain_attention()
    fa.reset_launch_counts()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    fa.reset_launch_counts()


PREDICTOR_KEYS = {"save_s", "load_s", "pytree_pkl_bytes", "pytree_bits_equal",
                  "predictor_devices", "predictions_shape", "mean_nll", "loss_fn",
                  "mean_nll_abs_err", "predict_ms_median", "inference_tokens_per_s",
                  "launches_per_call", "peak_memory_gib", "wall_s", "card"}


def test_predictor_runs_on_the_cpu(counted_cpu_attention, capsys):
    import json

    from ray_tpu_torch.models import GPTConfig

    # The nano GPT in bf16 compute over f32 params, B 2 x S 32, 2 timed calls.
    cfg = GPTConfig.nano()
    launches = chip_smoke.phase_predictor("cpu", cfg=cfg, device="cpu", batch=2, seq=32, calls=2)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "predictor" and PREDICTOR_KEYS <= set(line)
    assert line["pytree_bits_equal"] and line["predictor_devices"] == ["cpu"]
    assert line["predictions_shape"] == [2, 32] and line["mean_nll_abs_err"] <= 1e-3
    assert len(line["predict_ms_timed"]) == 2
    # Three calls (one warmup), each the forward once per layer, no backward.
    assert launches == {"flash_fwd": 3 * cfg.n_layer, "flash_bwd": 0}
    # The kernels line: the predictor on the forward's paths only.
    per_path = {p: 12 for p in chip_smoke.KERNEL_PATHS}
    fwd = _kernel(launches_per_path={**per_path, "predictor": launches["flash_fwd"],
                                     "batch_predictor": 12, "serve": 12})
    bwd = _kernel(name="flash_bwd", launches_per_path={**per_path, "predictor": 0})
    paths = chip_smoke.KERNEL_PATHS_BY_KERNEL
    assert chip_smoke.check_kernels_line({"kernels": [fwd, bwd]}, paths) == []
    bwd_there = _kernel(name="flash_bwd", launches_per_path={**per_path, "predictor": 4})
    assert chip_smoke.check_kernels_line({"kernels": [fwd, bwd_there]}, paths) == [
        "flash_bwd: launched on predictor"]
    no_fwd = _kernel(launches_per_path={**per_path, "predictor": 0, "batch_predictor": 12,
                                        "serve": 12})
    assert chip_smoke.check_kernels_line({"kernels": [no_fwd, bwd]}, paths) == [
        "flash_fwd: no launch on predictor"]


def test_next_token_nll_is_the_loss_per_position():
    from ray_tpu_torch.models import GPTConfig, init_params, loss_fn

    cfg = GPTConfig.nano(dtype=torch.float32)
    params = init_params(cfg, 0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 255, (2, 17)))
    nll = chip_smoke.next_token_nll_fn(cfg)(params, {"tokens": tokens[:, :-1],
                                                     "targets": tokens[:, 1:]})
    assert nll.shape == (2, 16) and nll.dtype == torch.float32
    assert nll.mean().item() == pytest.approx(loss_fn(params, {"tokens": tokens}, cfg).item(),
                                              rel=1e-6)


def test_rl_multi_agent_runs_on_the_cpu(monkeypatch):
    # The phase at one iteration of each algorithm, bars off, on a runtime of
    # its own: its lines, and the shutdown check (no session directory, no
    # worker, no attention launch) over its workers.
    from ray_tpu_torch.rllib.algorithms import algorithm
    from ray_tpu_torch.rllib.core import learner_group

    monkeypatch.setattr(algorithm, "default_device", lambda: torch.device("cpu"))
    monkeypatch.setattr(learner_group, "learner_device", lambda num_gpus: "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lines, down = chip_smoke.run_rl_multi_agent("cpu", device="cpu", max_iters=1, bars=False)
    finally:
        torch.set_num_threads(threads)
    assert [x["algo"] for x in lines] == ["ppo", "dqn", "sac"]
    for line in lines:
        assert RL_LINE_KEYS <= set(line) and line["phase"] == "rl_multi_agent"
        assert line["policies"] == ["p0", "p1"]
        assert [p["device"] for p in line["placement"]["learners"]] == ["cpu", "cpu"]
        assert all(r["cuda_visible_devices"] == "" for r in line["placement"]["runners"])
    assert [x["env_steps_per_iteration"] for x in lines] == [512, 512, 256]
    # DQN runs once per seed of MA_DQN_SEEDS, its bar on their mean curve.
    assert [x["iterations"] for x in lines] == [1, len(chip_smoke.MA_DQN_SEEDS), 1]
    dqn = lines[1]
    assert [x["seed"] for x in dqn["per_seed"]] == list(chip_smoke.MA_DQN_SEEDS)
    assert len(dqn["mean_returns"]) == 1 and len(set(dqn["worker_pids"])) == 6
    ppo = lines[0]
    assert ppo["frozen_p1_bits_equal"] and ppo["trained_p0_moved"]
    assert ppo["restored_bits_equal"] and ppo["restored_kl_coeff_p1"] == 0.456
    assert lines[2]["policy_weights_differ"]
    assert down["phase"] == "rl_shutdown" and "rl_multi_agent" in down["new_phases_s_by_phase"]
    assert not down["leftover_session_dirs"] and not down["leftover_worker_pids"]
    assert set(down["run_worker_pids"]) >= set(ppo["restored_worker_pids"])
    assert not any(down["attention_kernel_launches"].values())


# ------------------------------------------------------------------ Data
def test_data_phases_run_on_the_cpu(monkeypatch, capsys):
    # batch_predictor and data_ingest at nano size on the CPU (the pool's
    # actors and the train worker count their plain attention calls as
    # launches), then their runtime's shutdown check.
    import json

    from ray_tpu_torch._private.accelerators import gpu
    from ray_tpu_torch.models import GPTConfig

    monkeypatch.setattr(gpu, "default_device", lambda: torch.device("cpu"))
    cfg = GPTConfig.nano()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = chip_smoke.run_data_phases("cpu", cfg=cfg, device="cpu", rows=8, batch=2,
                                              seq=32)
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    by_phase = {x["phase"]: x for x in lines}
    assert [x["phase"] for x in lines] == ["batch_predictor", "data_ingest", "data_shutdown"]
    bp, ingest = by_phase["batch_predictor"], by_phase["data_ingest"]
    # Four calls of 2 rows over two actors, each call the forward once a layer.
    assert bp["blocks"] == 4 and len(bp["actors"]) == 2
    assert bp["launches_per_call"] == [{"flash_fwd": cfg.n_layer, "flash_bwd": 0}] * 4
    assert bp["predictions_shape"] == [8, 32] and bp["bit_equal_to_in_process"]
    assert sum(a["calls"] for a in bp["actors"]) == 4
    assert all(a["visible"] == "" and a["device"] == "cpu" for a in bp["actors"])
    # Four steps of 2 rows, 12 + 12 launches a step at nano's depth.
    assert ingest["batch_devices"] == ["cpu"] * 4 and ingest["batch_dtypes"] == ["int32"] * 4
    assert ingest["launches_per_step"] == [{"flash_fwd": cfg.n_layer,
                                            "flash_bwd": cfg.n_layer}] * 4
    assert ingest["first_loss_abs_err"] <= chip_smoke.LOSS_TOL
    assert ingest["first_rows_are_the_first_block"]
    assert by_phase["data_shutdown"]["leftover_worker_pids"] == []
    assert launches == {"batch_predictor": {"flash_fwd": 4 * cfg.n_layer, "flash_bwd": 0},
                        "data_ingest": {"flash_fwd": 4 * cfg.n_layer,
                                        "flash_bwd": 4 * cfg.n_layer}}
    # The kernels line: batch_predictor on the forward only, data_ingest on both.
    per_path = {p: 12 for p in chip_smoke.KERNEL_PATHS}
    paths = chip_smoke.KERNEL_PATHS_BY_KERNEL
    fwd = _kernel(launches_per_path={**per_path, "predictor": 12, "serve": 12,
                                     **{k: v["flash_fwd"] for k, v in launches.items()}})
    bwd = _kernel(name="flash_bwd", launches_per_path={
        **per_path, "predictor": 0, **{k: v["flash_bwd"] for k, v in launches.items()}})
    assert chip_smoke.check_kernels_line({"kernels": [fwd, bwd]}, paths) == []
    no_ingest = _kernel(name="flash_bwd", launches_per_path={
        **per_path, "predictor": 0, "batch_predictor": 0, "data_ingest": 0})
    assert chip_smoke.check_kernels_line({"kernels": [fwd, no_ingest]}, paths) == [
        "flash_bwd: no launch on data_ingest"]
    bwd_in_pool = _kernel(name="flash_bwd", launches_per_path={
        **per_path, "predictor": 0, "batch_predictor": 2})
    assert chip_smoke.check_kernels_line({"kernels": [fwd, bwd_in_pool]}, paths) == [
        "flash_bwd: launched on batch_predictor"]


# ------------------------------------------------------------------ Serve
def test_serve_phase_runs_on_the_cpu(monkeypatch, capsys):
    # The serve phase at nano size on the CPU, on a runtime with one logical
    # GPU (the replicas hold 0.5 of it each; no CUDA is touched): each
    # replica counts its plain attention calls as launches.
    import json

    from ray_tpu_torch._private.accelerators import gpu
    from ray_tpu_torch.models import GPTConfig

    monkeypatch.setattr(gpu, "default_device", lambda: torch.device("cpu"))
    cfg = GPTConfig.nano()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = chip_smoke.run_serve_phase("cpu", cfg=cfg, device="cpu", rows=8, seq=32,
                                              clients=4, max_batch=4, mux_seeds=(1, 2, 3))
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["phase"] for x in lines] == ["serve", "serve_shutdown"]
    line, down = lines
    # 8 rows over HTTP, 8 over the handle and one cold request, on 2 replicas.
    assert sum(line["batch_sizes"]) == 17 and max(line["batch_sizes"]) <= 4
    assert len(line["replicas_seen"]) == 2 and len(line["replica_start_s"]) == 2
    assert {r["visible"] for r in line["replicas_seen"]} == {"0"}  # the logical GPU's id
    assert line["gpu_free_during_calls"] == [0.0] and line["gpu_free_after_shutdown"] == 1.0
    assert line["launches_per_batch_call"] == [{"flash_fwd": cfg.n_layer, "flash_bwd": 0}] * (
        line["batch_calls"])
    assert line["http"]["max_abs_err_vs_in_process"] <= chip_smoke.SERVE_TOL
    assert line["handle"]["max_abs_err_vs_in_process"] <= chip_smoke.SERVE_TOL
    mux = line["multiplex"]
    assert mux["cached_after_each"] == [["m1"], ["m1", "m2"], ["m2", "m3"], ["m3", "m1"]]
    assert [e["model"] for e in mux["evictions"]] == ["m1", "m2"]
    assert max(mux["abs_err_vs_in_process"]) <= chip_smoke.SERVE_TOL
    assert line["serve_actors_alive_after"] == [] and line["serve_pids_alive_after"] == []
    assert down["leftover_session_dirs"] == [] and down["leftover_worker_pids"] == []
    assert launches == {"flash_fwd": cfg.n_layer * (line["batch_calls"] + 4), "flash_bwd": 0}
    # The kernels line: Serve on the forward only.
    per_path = {p: 12 for p in chip_smoke.KERNEL_PATHS}
    paths = chip_smoke.KERNEL_PATHS_BY_KERNEL
    fwd = _kernel(launches_per_path={**per_path, "predictor": 12, "batch_predictor": 12,
                                     "serve": launches["flash_fwd"]})
    bwd = _kernel(name="flash_bwd", launches_per_path={**per_path, "serve": 0})
    assert chip_smoke.check_kernels_line({"kernels": [fwd, bwd]}, paths) == []
    no_serve = _kernel(launches_per_path={**per_path, "predictor": 12, "batch_predictor": 12})
    assert chip_smoke.check_kernels_line({"kernels": [no_serve, bwd]}, paths) == [
        "flash_fwd: no launch on serve"]


# ------------------------------------------------------------------ Tune
def test_tune_phase_runs_on_the_cpu(monkeypatch, capsys):
    # The tune phase at nano size on the CPU, on a runtime with one logical
    # GPU (each trial's worker or actor holds 0.5 of it; no CUDA is touched):
    # the Trainer sweep's workers and the PBT trial actors count their plain
    # attention calls as launches.
    import json

    from ray_tpu_torch._private.accelerators import gpu
    from ray_tpu_torch.models import GPTConfig

    monkeypatch.setattr(gpu, "default_device", lambda: torch.device("cpu"))
    cfg = GPTConfig.nano()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = chip_smoke.run_tune_phase("cpu", cfg=cfg, device="cpu", batch=2, pbt_batch=2,
                                             seq=32)
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["phase"] for x in lines] == ["tune", "tune_shutdown"]
    line, down = lines
    sweep, pbt = line["sweep"], line["pbt"]
    # Two trials of one worker each, 4 steps, the kernels once a layer each way.
    assert [t["lr"] for t in sweep["trials"]] == list(chip_smoke.TUNE_LRS)
    per_step = {"flash_fwd": cfg.n_layer, "flash_bwd": cfg.n_layer}
    assert all(t["launches_per_step"] == [per_step] * chip_smoke.TUNE_STEPS
               for t in sweep["trials"])
    assert sweep["first_losses_bit_equal"] and sweep["first_loss_abs_err"] <= chip_smoke.LOSS_TOL
    assert sweep["workers_overlap_s"] > 0 and 0.0 in sweep["gpu_free_seen_by_driver"]
    assert {v for t in sweep["trials"] for v in t["worker_visible"]} == {"0"}
    assert sweep["best_trial"] == sweep["lowest_last_loss_trial"]
    assert sweep["gpu_free_after"] == 1.0 and sweep["pids_alive_after"] == []
    # PBT: at least one exploit, the donor's params bit for bit, its config
    # with lr explored; the device probe lands in the journal as a CPU tensor.
    assert pbt["exploits"] and all(
        e["sha_on_card"] == e["sha_donor_checkpoint"] and e["config_is_donors_explored"]
        for e in pbt["exploits"])
    assert pbt["checkpoints"] >= 2 and pbt["journal_and_spec_probe_devices"] == ["cpu"]
    assert pbt["gpu_free_after"] == 1.0 and pbt["pids_alive_after"] == []
    assert down["leftover_session_dirs"] == [] and down["leftover_worker_pids"] == []
    steps = chip_smoke.TUNE_STEPS * 2 + sum(len(t["steps"]) for t in pbt["trials"])
    assert launches == {"flash_fwd": steps * cfg.n_layer, "flash_bwd": steps * cfg.n_layer}
    # The kernels line: Tune on both kernels.
    per_path = {p: 12 for p in chip_smoke.KERNEL_PATHS}
    paths = chip_smoke.KERNEL_PATHS_BY_KERNEL
    fwd = _kernel(launches_per_path={**per_path, "predictor": 12, "batch_predictor": 12,
                                     "serve": 12})
    bwd = _kernel(name="flash_bwd", launches_per_path=per_path)
    assert chip_smoke.check_kernels_line({"kernels": [fwd, bwd]}, paths) == []
    no_tune = _kernel(name="flash_bwd", launches_per_path={**per_path, "tune": 0})
    assert chip_smoke.check_kernels_line({"kernels": [fwd, no_tune]}, paths) == [
        "flash_bwd: no launch on tune"]


# ------------------------------------------------------------------ the CLI
def test_cli_job_phase_runs_on_the_cpu(monkeypatch, capsys):
    # The cli_job phase at nano size on the CPU: a head started by the CLI
    # with one logical GPU (no CUDA is touched), a submitted job whose Train
    # worker holds it and counts its plain attention calls as launches, the
    # state through the CLI and the dashboard, then stop.
    import json

    from ray_tpu_torch._private.accelerators import gpu
    from ray_tpu_torch.models import GPTConfig

    monkeypatch.setattr(gpu, "default_device", lambda: torch.device("cpu"))
    cfg = GPTConfig.nano()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = chip_smoke.phase_cli_job("cpu", cfg=cfg, device="cpu", batch=2, seq=32)
    finally:
        torch.set_num_threads(threads)
    (line,) = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert line["phase"] == "cli_job" and line["job_status"] == "SUCCEEDED"
    assert line["head"]["cluster_resources"]["GPU"] == 1.0
    assert line["entrypoint_visible"] == "" and line["worker"]["visible"] == ["0"]
    (worker,) = line["list_actors_during"]["worker"]
    (sup,) = line["list_actors_during"]["supervisor"]
    assert worker["resources"]["GPU"] == 1.0 and worker["gpu_ids"] == ["0"]
    assert "GPU" not in sup["resources"] and sup["gpu_ids"] == []
    assert line["gpu_during"]["available"] == 0.0 and line["gpu_after"]["available"] == 1.0
    per_step = {"flash_fwd": cfg.n_layer, "flash_bwd": cfg.n_layer}
    assert line["worker"]["launches_per_step"] == [per_step] * chip_smoke.CLI_JOB_STEPS
    assert launches == {k: v * chip_smoke.CLI_JOB_STEPS for k, v in per_step.items()}
    assert line["first_loss_abs_err"] <= chip_smoke.LOSS_TOL
    assert line["goodput"]["steps"] == chip_smoke.CLI_JOB_STEPS
    assert abs(line["goodput_bucket_sum_s"] - line["goodput"]["wall_s"]) <= 1e-2
    assert line["timeline"]["worker_task_events"] > 0
    assert all(line["dashboard"][k] for k in ("cluster_equals_status", "jobs_equal_cli",
                                              "train_equals_cli"))
    assert line["stop"]["alive_after"] == [] and not line["stop"]["session_dir_left"]
    assert line["head_aiohttp"]["mapped_in_process"] is False  # read while the head lived
    assert set(line["seconds"]) >= {"head_start_to_ready", "submit_to_running",
                                    "submit_to_first_step", "submit_to_succeeded"}
    # The kernels line: the CLI job on both kernels.
    per_path = {p: 12 for p in chip_smoke.KERNEL_PATHS}
    paths = chip_smoke.KERNEL_PATHS_BY_KERNEL
    fwd = _kernel(launches_per_path={**per_path, "predictor": 12, "batch_predictor": 12,
                                     "serve": 12})
    no_job = _kernel(name="flash_bwd", launches_per_path={**per_path, "cli_job": 0})
    assert chip_smoke.check_kernels_line({"kernels": [fwd, no_job]}, paths) == [
        "flash_bwd: no launch on cli_job"]
