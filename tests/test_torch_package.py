"""Rules of the port's package (ray_tpu_torch): it stands alone from JAX and
from ray_tpu, its entry points put new tensors on the GPU unless asked for the
CPU (and raise when there is none), and its CPU path never reaches the CUDA
build. All run on the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import default_device, detect_num_gpus
from ray_tpu_torch.models import (
    GPTConfig,
    create_train_state,
    default_optimizer,
    init_params,
    make_train_step,
    params_from_numpy,
    shard_batch,
)
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.flash_attention import _bwd_cuda, _fwd_cuda, flash_attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(ROOT, "ray_tpu_torch")


def _modules():
    names = ["ray_tpu_torch"]
    for info in pkgutil.walk_packages([PKG_DIR], prefix="ray_tpu_torch."):
        names.append(info.name)
    return names


def test_importing_every_module_loads_no_jax_and_no_ray_tpu():
    # Nor transformers: the HF import reads a model's config and state dict.
    # Nor optax (the RL optimizers are written out) nor gymnasium (imported
    # only when an env is made from a string id).
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'ray_tpu', 'transformers', 'optax', 'gymnasium'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_no_jax_and_no_ray_tpu():
    banned = re.compile(r"^\s*(import jax|from jax|import ray_tpu(?!_torch)|from ray_tpu(?!_torch)"
                        r"|import transformers|from transformers|import optax|from optax)", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG_DIR):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    gym = re.compile(r"^\s*(import|from) gymnasium", re.M)
    importers = []
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert not banned.search(src), path
        importers += [os.path.relpath(path, ROOT)] * len(gym.findall(src))
    # gymnasium: once, in AlgorithmConfig.env_creator, for a string env id.
    assert importers == ["ray_tpu_torch/rllib/algorithms/algorithm.py"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_when_cuda_is_absent(no_cuda):
    cfg = GPTConfig.nano(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(cfg, 0, default_optimizer())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_batch({"tokens": np.zeros((1, 2), np.int32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
    from ray_tpu_torch.rllib import MLPModule, PPOConfig, TorchLearner
    from ray_tpu_torch.rllib.algorithms.ppo import make_ppo_loss

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchLearner(MLPModule(4, 2), make_ppo_loss(PPOConfig()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PPOConfig().build()  # num_gpus_per_learner left at 1
    # Asked for by name, the CPU works.
    state = create_train_state(cfg, 0, default_optimizer(), device="cpu")
    assert state.params["wte"].device.type == "cpu"
    learner = TorchLearner(MLPModule(4, 2), make_ppo_loss(PPOConfig()), device="cpu")
    assert learner.placement()["device"] == "cpu"


def test_flash_attention_on_cpu_never_touches_the_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the CUDA build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((1, 2, 70, 64)), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    o = flash_attention(q, k, v)
    torch.autograd.grad(o.sum(), (q, k, v))


def test_kernel_wrappers_refuse_cpu_tensors_before_building(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda *a: pytest.fail("built for a CPU tensor"))
    x = torch.zeros((2, 64, 64))
    lse = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        _fwd_cuda(x, x, x, True, 0.125)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _bwd_cuda(x, x, x, x, lse, lse, True, 0.125)
    with pytest.raises(ValueError, match="head_dim"):
        _fwd_cuda(torch.zeros((2, 64, 32)), x, x, True, 0.125)


def test_strided_attention_inputs_raise():
    x = torch.zeros((2, 64, 2, 64)).transpose(1, 2)  # (B, nh, S, hd) view of (B, S, nh, hd)
    with pytest.raises(RuntimeError):
        flash_attention(x, x, x)


def test_build_is_keyed_by_source_hash():
    path = _build.library_path("flash_attention")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert os.path.basename(path).startswith("flash_attention-")


def test_what_is_not_ported_raises():
    # MoE, the "dots" remat policy and meshes over all six axes are ported
    # now; the name is kept from when they raised.
    cfg = GPTConfig.nano(dtype=torch.float32)
    tokens = {"tokens": torch.zeros((1, 9), dtype=torch.int32)}
    from ray_tpu_torch.models.gpt import loss_fn
    from ray_tpu_torch.parallel import MeshSpec

    for zoo_cfg in (GPTConfig.nano(dtype=torch.float32, moe_experts=2),
                    GPTConfig.nano(dtype=torch.float32, remat_policy="dots")):
        assert torch.isfinite(loss_fn(init_params(zoo_cfg, 0, device="cpu"), tokens, zoo_cfg))

    make_train_step(cfg, default_optimizer(), mesh=MeshSpec(expert=2))
    make_train_step(cfg, default_optimizer(), mesh=MeshSpec(data=2, fsdp=2, tensor=2))
    make_train_step(cfg, default_optimizer(), mesh=MeshSpec(pipeline=2, context=2))
    # A config of no known family is taken as GPT, as in the JAX package.
    from ray_tpu_torch.models.training import model_for

    assert model_for(object()) is __import__("ray_tpu_torch.models.gpt", fromlist=["gpt"])


def test_collective_parallel_and_model_exports_match_the_jax_packages():
    import ray_tpu_torch.models as tmodels
    import ray_tpu_torch.parallel as tparallel
    import ray_tpu_torch.util.collective as tcol

    # The JAX package's lists, read from its sources (importing them would
    # load JAX).
    import ast

    def exported(rel):
        with open(os.path.join(ROOT, rel)) as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
                return sorted(ast.literal_eval(node.value))

    assert sorted(tcol.__all__) == exported("ray_tpu/util/collective/__init__.py")
    assert len(tcol.__all__) == 20 and {"Backend", "ReduceOp", "sendrecv"} <= set(tcol.__all__)
    assert sorted(tparallel.__all__) == exported("ray_tpu/parallel/__init__.py")
    assert set(exported("ray_tpu/models/__init__.py")) <= set(tmodels.__all__)
    for name in tcol.__all__ + tparallel.__all__ + tmodels.__all__:
        assert hasattr(tcol if name in tcol.__all__ else
                       tparallel if name in tparallel.__all__ else tmodels, name), name


def test_item_2_entry_points_raise_not_implemented(tmp_path):
    # The five entry points that reach a module listed in NOT_YET_PORTED
    # raise NotImplementedError naming its item, not an ImportError.
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 2"):
        ray_tpu_torch.timeline()

    @ray_tpu_torch.remote
    def f(x):
        return x

    @ray_tpu_torch.remote
    class A:
        pass

    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 2"):
        f.bind(1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 2"):
        A.bind()
    # The head: with --dashboard-port, and when it recovers a journal that
    # holds a job still running.
    from ray_tpu_torch._private.gcs import GCS

    journal = str(tmp_path / "gcs.journal")
    gcs = GCS()
    gcs.kv_put(b"job::j1::status", b"RUNNING")
    gcs.save_to(journal)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for extra in (["--dashboard-port", "0"], ["--persist", journal]):
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.head", "--num-cpus", "1", *extra],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            _, err = proc.communicate(timeout=60)
        finally:
            proc.kill()
            import glob
            import shutil

            for d in glob.glob(f"/dev/shm/ray_tpu_torch_head_{proc.pid}_*"):
                shutil.rmtree(d, ignore_errors=True)
        assert proc.returncode != 0
        assert "NotImplementedError" in err and "ROADMAP.md Queue 1 item 2" in err, err[-2000:]


def test_detect_num_gpus_reads_visible_devices(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,3")
    assert detect_num_gpus() == 3
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert detect_num_gpus() == 0
    assert ray_tpu_torch.__version__


# Modules the port's code imports (at module or function level) that the port
# does not have yet, each with the ROADMAP.md item that brings it. A slice that
# ports one of them must take it out of this set: the walk below must find
# exactly these unresolved.
NOT_YET_PORTED = {
    "ray_tpu_torch.dag",  # the DAG API (.bind): Queue 1 item 2
    "ray_tpu_torch.dashboard",  # the head's REST dashboard: Queue 1 item 2
    "ray_tpu_torch.job_submission.client",  # job submission: Queue 1 item 2
    "ray_tpu_torch.util.state",  # state API and timeline(): Queue 1 item 2
}


def _module_exists(name):
    path = os.path.join(ROOT, *name.split("."))
    return os.path.isfile(os.path.join(path, "__init__.py")) or os.path.isfile(path + ".py")


def _top_level_names(name):
    import ast

    path = os.path.join(ROOT, *name.split("."))
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) else path + ".py"
    names = set()
    with open(path) as f:
        for node in ast.parse(f.read()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0] for a in node.names)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                names.add(node.target.id)
    return names


def _port_imports():
    """Every ray_tpu_torch.* module the port's sources import, at any level,
    with the files that import it."""
    import ast

    found = {}
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            mod = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
            pkg = mod[: -len(".__init__")] if mod.endswith(".__init__") else mod.rpartition(".")[0]
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    base = node.module or ""
                    if node.level:
                        parts = pkg.split(".")[: len(pkg.split(".")) - node.level + 1]
                        base = ".".join(parts + ([node.module] if node.module else []))
                    for a in node.names:
                        sub = f"{base}.{a.name}"
                        # `from pkg import name`: a submodule of pkg, unless pkg
                        # is missing itself or defines the name.
                        if _module_exists(base) and (
                                _module_exists(sub) or a.name not in _top_level_names(base)):
                            names.append(sub)
                        else:
                            names.append(base)
                for name in names:
                    if name.split(".")[0] == "ray_tpu_torch":
                        found.setdefault(name, set()).add(os.path.relpath(path, ROOT))
    return found


def test_every_port_import_resolves_or_is_listed_as_not_yet_ported():
    imports = _port_imports()
    unresolved = {name for name in imports if not _module_exists(name)}
    assert unresolved == NOT_YET_PORTED, {n: sorted(imports.get(n, ())) for n in
                                          unresolved ^ NOT_YET_PORTED}
    # The runtime's worker entry point is the port's own, in both spawn paths.
    for rel in ("_private/scheduler.py", "_private/node_daemon.py"):
        with open(os.path.join(PKG_DIR, rel)) as f:
            src = f.read()
        assert '"ray_tpu_torch._private.worker_entry"' in src, rel


def test_sources_use_the_ports_own_environment_keys_and_session_paths():
    env_key = re.compile(r"RAY_TPU_(?!TORCH_)")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG_DIR):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith((".py", ".c", ".cpp", ".cu", ".h"))]
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert not env_key.search(src), (path, env_key.search(src).group(0))
        assert "ray_tpu_session_" not in src, path


def test_shutdown_leaves_no_session_directory():
    import glob

    ray_tpu_torch.init(num_cpus=2)
    session_dir = ray_tpu_torch._private.worker.global_worker.session_dir
    assert os.path.basename(session_dir).startswith("ray_tpu_torch_session_")
    assert os.path.isdir(session_dir)

    @ray_tpu_torch.remote
    def one():
        return 1

    assert ray_tpu_torch.get(one.remote()) == 1
    ray_tpu_torch.shutdown()
    assert not os.path.exists(session_dir)
    assert session_dir not in glob.glob("/dev/shm/ray_tpu_torch_session_*")


def test_gpu_seams_of_the_train_stack():
    from ray_tpu_torch.air import ScalingConfig, session
    from ray_tpu_torch.air.checkpoint import load_pytree, save_pytree
    from ray_tpu_torch.train.torch import TorchConfig
    from ray_tpu_torch.util.placement_group import placement_group

    gpu = ScalingConfig(num_workers=2, use_gpu=True)
    assert gpu._resources == {"GPU": 1.0, "CPU": 1.0}
    assert ScalingConfig(use_gpu=True, gpus_per_worker=0.5)._resources["GPU"] == 0.5
    assert "GPU" not in ScalingConfig(resources_per_worker={"GPU": 2})._resources
    with pytest.raises(ValueError, match="not both"):
        ScalingConfig(use_gpu=True, gpus_per_worker=2, resources_per_worker={"GPU": 1})
    assert TorchConfig().resolve_backend(gpu._resources) == "nccl"
    assert TorchConfig().resolve_backend(ScalingConfig()._resources) == "gloo"
    assert TorchConfig(backend="gloo").resolve_backend(gpu._resources) == "gloo"
    for not_ported in (lambda: save_pytree({}, "unused"),
                       lambda: load_pytree("unused"),
                       lambda: placement_group([{"GPU": 1}], strategy="TPU_SLICE")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
            not_ported()
    from ray_tpu_torch.parallel import MeshSpec

    assert ScalingConfig(num_workers=4).mesh_spec() == MeshSpec(data=4)
    assert ScalingConfig(num_workers=4, mesh={"fsdp": 4}).mesh_spec() == MeshSpec(fsdp=4)
    assert ScalingConfig(num_workers=4, mesh={"data": 2, "expert": 2}).mesh_spec() == \
        MeshSpec(data=2, expert=2)
    with pytest.raises(TypeError):
        ScalingConfig(num_workers=2, mesh={"rows": 2})
    spec = MeshSpec(data=2, tensor=2)
    assert ScalingConfig(num_workers=4, mesh=spec).mesh_spec() is spec
    session._set_session(object())
    try:
        assert session.get_mesh() is None  # a session that builds no mesh
    finally:
        session._set_session(None)
