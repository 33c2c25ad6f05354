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


def test_data_runs_without_pyarrow_and_pandas(tmp_path):
    # The card's machine has neither: importing ray_tpu_torch.data and every
    # numpy-block path must not need them. This process blocks them in
    # sys.modules; its workers find stubs that raise on import.
    for name in ("pyarrow", "pandas"):
        (tmp_path / f"{name}.py").write_text(f"raise ImportError('{name} is blocked')\n")
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import numpy as np\n"
        "import ray_tpu_torch\n"
        "from ray_tpu_torch import data as rd\n"
        "ray_tpu_torch.init(num_cpus=2)\n"
        "try:\n"
        "    class Add:\n"
        "        def __call__(self, b):\n"
        "            return {'id': b['id'] + 1, 'g': b['id'] % 3}\n"
        "    ds = rd.range(40, parallelism=4).map_batches(Add, compute='actors', num_actors=1)\n"
        "    ds = ds.random_shuffle(seed=1).sort('id')\n"
        "    assert [r['id'] for r in ds.take_all()] == list(range(1, 41))\n"
        "    assert len(ds.groupby('g').count().take_all()) == 3\n"
        "    xs = rd.from_numpy(np.arange(12.0).reshape(6, 2)).iter_torch_batches(\n"
        "        batch_size=4, device='cpu')\n"
        "    assert [tuple(b['data'].shape) for b in xs] == [(4, 2), (2, 2)]\n"
        "    assert rd.from_items([{'a': 1}, {'a': 2}]).sum('a') == 3\n"
        "finally:\n"
        "    ray_tpu_torch.shutdown()\n"
        "assert sys.modules['pyarrow'] is None and sys.modules['pandas'] is None\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), ROOT])
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_tune_runs_without_pandas(tmp_path):
    # The card's machine has no pandas: importing Tune and running a sweep
    # (a scheduler, a searcher and a restore) must not need it; only
    # ResultGrid.get_dataframe imports it. This process blocks it in
    # sys.modules; its workers find a stub that raises on import.
    (tmp_path / "pandas.py").write_text("raise ImportError('pandas is blocked')\n")
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "import ray_tpu_torch\n"
        "from ray_tpu_torch import tune, workflow\n"
        "from ray_tpu_torch.air import RunConfig\n"
        "from ray_tpu_torch.tune.schedulers import ASHAScheduler\n"
        f"root = {str(tmp_path)!r}\n"
        "ray_tpu_torch.init(num_cpus=2)\n"
        "try:\n"
        "    def f(config):\n"
        "        from ray_tpu_torch.air import session\n"
        "        for i in range(3):\n"
        "            session.report({'score': config['x'] * (i + 1)})\n"
        "    grid = tune.Tuner(f, param_space={'x': tune.grid_search([1, 2])},\n"
        "        tune_config=tune.TuneConfig(metric='score', mode='max',\n"
        "            scheduler=ASHAScheduler(max_t=3, grace_period=1)),\n"
        "        run_config=RunConfig(name='e', storage_path=root)).fit()\n"
        "    assert grid.get_best_result().metrics['score'] == 6\n"
        "    again = tune.Tuner.restore(root + '/e').fit()\n"
        "    assert sorted(r.metrics['score'] for r in again) == [3, 6]\n"
        "    try:\n"
        "        grid.get_dataframe()\n"
        "    except ImportError:\n"
        "        pass\n"
        "    else:\n"
        "        raise AssertionError('get_dataframe without pandas')\n"
        "finally:\n"
        "    ray_tpu_torch.shutdown()\n"
        "assert sys.modules['pandas'] is None\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), ROOT])
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


WEB_PACKAGES = ("aiohttp", "fastapi", "starlette", "uvicorn")


def test_serve_runs_without_web_packages(tmp_path):
    # The card's machine has no aiohttp, fastapi or starlette: Serve's proxy
    # is the standard library's. PYTHONPATH starts with packages of those
    # names that raise on import, so the proxy's and replicas' workers meet
    # them too; an HTTP round trip and a streamed reply must still work.
    for name in WEB_PACKAGES[:3]:
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(f"raise ImportError('{name} is blocked')\n")
    code = (
        "import json, sys, urllib.request\n"
        "import ray_tpu_torch\n"
        "from ray_tpu_torch import serve\n"
        "ray_tpu_torch.init(num_cpus=2)\n"
        "try:\n"
        "    @serve.deployment\n"
        "    class Echo:\n"
        "        def __call__(self, req):\n"
        "            import sys\n"
        "            bad = [m for m in ('aiohttp', 'fastapi', 'starlette') if m in sys.modules]\n"
        "            return {'got': req.json(), 'bad': bad}\n"
        "    @serve.deployment\n"
        "    class Gen:\n"
        "        def __call__(self, req):\n"
        "            yield 'a;'\n"
        "            yield 'b;'\n"
        "    serve.start(http_options={'port': 0})\n"
        "    serve.run(Echo.bind(), route_prefix='/echo', port=0)\n"
        "    serve.run(Gen.bind(), route_prefix='/gen', port=0)\n"
        "    base = f'http://127.0.0.1:{serve.http_port()}'\n"
        "    r = urllib.request.Request(base + '/echo', data=b'[1, 2]', method='POST')\n"
        "    with urllib.request.urlopen(r, timeout=30) as resp:\n"
        "        assert json.loads(resp.read()) == {'got': [1, 2], 'bad': []}\n"
        "    with urllib.request.urlopen(base + '/gen', timeout=30) as resp:\n"
        "        assert resp.headers['Transfer-Encoding'] == 'chunked'\n"
        "        assert resp.read() == b'a;b;'\n"
        "finally:\n"
        "    serve.shutdown()\n"
        "    ray_tpu_torch.shutdown()\n"
        "bad = [m for m in ('aiohttp', 'fastapi', 'starlette', 'uvicorn') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), ROOT])
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr
    # And no file of the port names them.
    named = re.compile(r"\b(" + "|".join(WEB_PACKAGES) + r")\b", re.I)
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith((".py", ".c", ".cpp", ".cu", ".h")):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not named.search(fh.read()), os.path.join(dirpath, f)


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
    import ray_tpu_torch.autoscaler as tautoscaler
    import ray_tpu_torch.models as tmodels
    import ray_tpu_torch.parallel as tparallel
    import ray_tpu_torch.util as tutil
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

    # The GPU counterparts of the TPU names, and nothing else, differ: the
    # gang of one bundle a host and the cloud provider.
    gpu_for_tpu = {"tpu_slice_placement_group": "gpu_slice_placement_group",
                   "TpuQueuedResourcesProvider": "GcpGpuInstancesProvider"}
    for port_mod, rel in ((tutil, "ray_tpu/util/__init__.py"),
                          (tautoscaler, "ray_tpu/autoscaler/__init__.py")):
        assert sorted(port_mod.__all__) == sorted(gpu_for_tpu.get(n, n) for n in exported(rel))
        assert all(hasattr(port_mod, n) for n in port_mod.__all__)
    assert sorted(tcol.__all__) == exported("ray_tpu/util/collective/__init__.py")
    assert len(tcol.__all__) == 20 and {"Backend", "ReduceOp", "sendrecv"} <= set(tcol.__all__)
    assert sorted(tparallel.__all__) == exported("ray_tpu/parallel/__init__.py")
    assert set(exported("ray_tpu/models/__init__.py")) <= set(tmodels.__all__)
    for name in tcol.__all__ + tparallel.__all__ + tmodels.__all__:
        assert hasattr(tcol if name in tcol.__all__ else
                       tparallel if name in tparallel.__all__ else tmodels, name), name


def _head(*extra, env=None):
    """A head process of the port's; returns it and its ready line's JSON."""
    import json

    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.head", "--num-cpus", "1", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    assert line.startswith("RAY_TPU_TORCH_HEAD_READY "), line + proc.stderr.read()[-2000:]
    return proc, json.loads(line.split(" ", 1)[1])


def test_item_2_entry_points_work(tmp_path):
    # The three entry points that raised NotImplementedError naming item 2
    # before the state API, the dashboard and job submission were ported.
    import json
    import urllib.request

    from ray_tpu_torch._private.gcs import GCS

    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote
        def one():
            return 1

        assert ray_tpu_torch.get(one.remote()) == 1
        events = ray_tpu_torch.timeline(str(tmp_path / "tl.json"))
        assert any(e["cat"] == "task" and e["name"] == "one" for e in events), events
        with open(tmp_path / "tl.json") as f:
            assert len(json.load(f)) == len(events)
    finally:
        ray_tpu_torch.shutdown()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # The head's dashboard: --dashboard-port 0 binds a free port and serves
    # the cluster's rollup.
    proc, info = _head("--dashboard-port", "0", env=env)
    try:
        url = f"http://127.0.0.1:{info['dashboard_port']}/api/cluster"
        with urllib.request.urlopen(url, timeout=30) as resp:
            cluster = json.loads(resp.read())
        assert cluster["nodes"] == 1 and cluster["cluster_resources"]["CPU"] == 1.0
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0
    assert not os.path.exists(info["session_dir"])
    # A journal that holds a job still running: the head recovers it as
    # FAILED, with the reason, and saves both on the way out.
    journal = str(tmp_path / "gcs.journal")
    gcs = GCS()
    gcs.kv_put(b"job::j1::status", b"RUNNING")
    gcs.kv_put(b"job::j2::status", b"SUCCEEDED")
    gcs.save_to(journal)
    proc, info = _head("--persist", journal, env=env)
    proc.terminate()
    assert proc.wait(timeout=30) == 0
    back = GCS()
    assert back.load_from(journal)
    assert back.kv_get(b"job::j1::status") == b"FAILED"
    assert b"in flight when the head restarted" in back.kv_get(b"job::j1::message")
    assert back.kv_get(b"job::j2::status") == b"SUCCEEDED"
    assert back.kv_get(b"job::j2::message") is None


def test_operator_modules_import_no_torch():
    # The CLI, the state API, the dashboard and job submission are host code:
    # `python -m ray_tpu_torch status` pays one process start, not a CUDA
    # library load. So are the cluster's modules (the autoscaler, placement,
    # chaos) and the util host libraries over actors.
    code = (
        "import sys\n"
        "import ray_tpu_torch.__main__, ray_tpu_torch.scripts.cli, ray_tpu_torch.dashboard\n"
        "import ray_tpu_torch.util.state, ray_tpu_torch.job_submission\n"
        "import ray_tpu_torch.cluster_utils, ray_tpu_torch._private.launch\n"
        "import ray_tpu_torch._private.critical_path\n"
        "import ray_tpu_torch.autoscaler, ray_tpu_torch.util.chaos\n"
        "import ray_tpu_torch.util.gpu_topology_policy, ray_tpu_torch.util.placement_group\n"
        "import ray_tpu_torch.util.queue, ray_tpu_torch.util.multiprocessing\n"
        "import ray_tpu_torch.util.joblib\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stdout + proc.stderr


def test_joblib_backend_without_joblib_raises_only_when_registered(tmp_path):
    # The card's machine has no joblib: importing the port's util.joblib must
    # not need it, and registering the backend raises the reference's
    # ImportError. This process blocks joblib in sys.modules.
    code = (
        "import sys\n"
        "sys.modules['joblib'] = None\n"
        "from ray_tpu_torch.util import joblib as rjoblib\n"
        "try:\n"
        "    rjoblib.register_ray()\n"
        "except ImportError as e:\n"
        "    print(e)\n"
        "    assert isinstance(e.__cause__, ImportError)\n"
        "else:\n"
        "    raise AssertionError('registered without joblib')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "joblib is required for the ray_tpu_torch joblib backend"


def test_node_topology_labels(monkeypatch):
    import socket

    from ray_tpu_torch._private.accelerators.gpu import NVLINK_DOMAIN_ENV, node_topology_labels

    monkeypatch.delenv(NVLINK_DOMAIN_ENV, raising=False)
    assert node_topology_labels(0) == {} and node_topology_labels(0.0) == {}
    assert node_topology_labels(8) == {"gpu_nvlink_domain": socket.gethostname()}
    monkeypatch.setenv(NVLINK_DOMAIN_ENV, "nvl72-rack-3")
    assert node_topology_labels(0.5) == {"gpu_nvlink_domain": "nvl72-rack-3"}


def test_detect_num_gpus_reads_visible_devices(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,3")
    assert detect_num_gpus() == 3
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert detect_num_gpus() == 0
    assert ray_tpu_torch.__version__


# Modules the port's code imports (at module or function level) that the port
# does not have yet, each with the ROADMAP.md item that brings it. A slice that
# ports one of them must take it out of this set: the walk below must find
# exactly these unresolved. Empty since the operator surface was ported.
NOT_YET_PORTED = set()


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
    # save_pytree/load_pytree are ported (tests/test_torch_predictor.py):
    # a round trip. TPU_SLICE placement has its GPU counterpart, GPU_SLICE,
    # which the error names (tests/test_torch_placement.py).
    import tempfile

    with tempfile.TemporaryDirectory() as path:
        tree = {"w": torch.arange(4.0), "b": [np.float32(1.5)]}
        save_pytree(tree, path)
        back = load_pytree(path)
        assert torch.equal(back["w"], tree["w"]) and back["b"] == [np.float32(1.5)]
    with pytest.raises(ValueError, match="GPU_SLICE"):
        placement_group([{"GPU": 1}], strategy="TPU_SLICE")
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
