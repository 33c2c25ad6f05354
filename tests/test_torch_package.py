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
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ray_tpu' or m.startswith('ray_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_no_jax_and_no_ray_tpu():
    banned = re.compile(r"^\s*(import jax|from jax|import ray_tpu(?!_torch)|from ray_tpu(?!_torch))", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG_DIR):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            assert not banned.search(f.read()), path


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
    # Asked for by name, the CPU works.
    state = create_train_state(cfg, 0, default_optimizer(), device="cpu")
    assert state.params["wte"].device.type == "cpu"


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
    cfg = GPTConfig.nano(dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(GPTConfig.nano(moe_experts=2), 0, device="cpu")
    params = init_params(cfg, 0, device="cpu")
    tokens = {"tokens": torch.zeros((1, 9), dtype=torch.int32)}
    from ray_tpu_torch.models.gpt import loss_fn

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loss_fn(params, tokens, GPTConfig.nano(dtype=torch.float32, remat_policy="dots"))

    class Mesh:  # the torch DeviceMesh interface the check reads
        def size(self):
            return 4

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(cfg, default_optimizer(), mesh=Mesh())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(object(), default_optimizer())


def test_detect_num_gpus_reads_visible_devices(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,3")
    assert detect_num_gpus() == 3
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert detect_num_gpus() == 0
    assert ray_tpu_torch.__version__
