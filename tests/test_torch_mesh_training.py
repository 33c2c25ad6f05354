"""Training on a mesh through the port (ray_tpu_torch.parallel, models) against
the JAX package on the CPU.

- One 4-rank gloo gang (subprocesses that never import JAX, under a time
  limit of their own) trains nano GPT on ``{data 4}``, ``{fsdp 4}``,
  ``{data 2, tensor 2}``, ``{pipeline 2, data 2}``, ``{pipeline 2, tensor
  2}`` and ``{data 2, context 2}``, nano Llama (GQA) on ``{fsdp 2, tensor
  2}`` and ``{pipeline 2, context 2}`` (RoPE at global positions inside a
  stage), nano MoE GPT on ``{data 2, fsdp 2}`` and ``{pipeline 2, data 2}``
  (the aux over real ticks) and nano ResNet on ``{fsdp 4}``, 3 steps each in
  f32, from the JAX package's initial weights carried across with
  ``params_from_numpy``. The JAX package's ``make_train_step`` runs the same
  mesh shape over 4 of the 8 virtual devices ``tests/conftest.py`` gives it
  (over a context axis, on ``inputs``/``targets`` split from the tokens, as
  ``tests/test_models.py`` feeds it). Losses rtol 1e-4 (the JAX package's
  own bar for a mesh against one device, ``tests/test_models.py``), grad
  norms rtol 1e-4; the losses also against the port on one device, except
  MoE on a pipeline, whose aux is by definition a mean over microbatches
  (the JAX package's too) and so not one device's.
- The gathered params after 3 steps, against the JAX package's mesh run and
  the port's own single-device run: atol 1e-5 at every element whose first
  gradient in the JAX package (one device) lies outside ``ADAM_BAND``. Inside
  it, Adam's update g / (|g| + eps), eps 1e-8, is most sensitive to the
  gradient's rounding: on this batch GPT's ``fc_w[1, 58, 172]`` has a first
  gradient of -4e-9 (mean |g| 1.7e-3), 11% apart between the two packages on
  one device, and its param 3.3e-5 apart after 3 steps; any reordered f32
  sum, a mesh's included, moves it as far. The band is fixed by the JAX
  package's gradient, so a fault of the port cannot widen it; it holds at
  most ``MAX_BAND_SHARE`` of any leaf's elements and ``MAX_BAND_SHARE_MODEL``
  of a model's (at init the attention logits are small, so the q and k
  weights hold most of it), and an element in it must still be within 1e-5,
  or have moved the way the reference's moved and by no more than the most
  3 steps can move a param apart, 3 x lr.
- ``forward(mesh=)`` after those steps gives the global logits as a
  DTensor, equal to one device's forward of the gathered params.
- A 2-worker ``TorchTrainer`` with ``ScalingConfig(mesh={"fsdp": 2})``,
  ``{"pipeline": 2}`` or ``{"context": 2}`` and ``TorchConfig(device="cpu")``:
  ``session.get_mesh()`` is a ``DeviceMesh`` with the six axis names, each
  rank holds its shard (a stage its layer, a context rank its half of each
  sequence), and the losses equal the port's single-device run (rtol 1e-5).
  Without ``device="cpu"`` the mesh wants the GPU and raises.
- A mesh with expert parallelism raises.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.models import GPTConfig as JGPTConfig
from ray_tpu.models import LlamaConfig as JLlamaConfig
from ray_tpu.models import ResNetConfig as JResNetConfig
from ray_tpu.models import create_train_state as j_create
from ray_tpu.models import default_optimizer as j_optimizer
from ray_tpu.models import make_train_step as j_step
from ray_tpu.models import shard_batch as j_shard_batch
from ray_tpu.models.training import model_for as j_model_for
from ray_tpu.parallel import MeshSpec as JMeshSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, LR, B, S = 3, 1e-3, 4, 32
RESNET_B, RESNET_HW = 8, 32
LOSS_RTOL = GNORM_RTOL = 1e-4
PARAM_ATOL = 1e-5
ADAM_BAND = (1e-10, 1e-6)  # two decades below Adam's eps to two above
MAX_BAND_SHARE, MAX_BAND_SHARE_MODEL = 0.025, 0.005
GANG_TIMEOUT_S = 240
KINDS = ("gpt", "llama", "moe", "resnet")
CASES = [
    ("gpt", {"data": 4}),
    ("gpt", {"fsdp": 4}),
    ("gpt", {"data": 2, "tensor": 2}),
    ("llama", {"fsdp": 2, "tensor": 2}),
    ("moe", {"data": 2, "fsdp": 2}),
    ("resnet", {"fsdp": 4}),
    ("gpt", {"pipeline": 2, "data": 2}),
    ("gpt", {"pipeline": 2, "tensor": 2}),
    ("gpt", {"data": 2, "context": 2}),
    ("llama", {"pipeline": 2, "context": 2}),
    ("moe", {"pipeline": 2, "data": 2}),
]

# Each rank of the gang: joins a gloo process group, then for each case
# builds the mesh, shards the carried weights, trains STEPS steps and (rank 0)
# writes the losses, grad norms and gathered params.
RANK_PROGRAM = r"""
import datetime, json, pickle, sys
import numpy as np, torch, torch.distributed as dist
args, rank = json.loads(sys.argv[1]), int(sys.argv[2])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args['port']}", rank=rank,
                        world_size=4, timeout=datetime.timedelta(seconds=120))
from ray_tpu_torch.models import (GPTConfig, LlamaConfig, ResNetConfig, TrainState,
                                  default_optimizer, make_train_step, shard_batch)
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.training import model_for, tree_leaves, tree_map
from ray_tpu_torch.parallel import MeshSpec, ShardingRules, shard_params

CONFIGS = {"gpt": lambda: GPTConfig.nano(dtype=torch.float32),
           "llama": lambda: LlamaConfig.nano(dtype=torch.float32),
           "moe": lambda: GPTConfig.nano(dtype=torch.float32, moe_experts=4),
           "resnet": lambda: ResNetConfig.nano(dtype=torch.float32)}
with open(args["inputs"], "rb") as f:
    inputs = pickle.load(f)
for i, (kind, axes) in enumerate(args["cases"]):
    cfg = CONFIGS[kind]()
    model = model_for(cfg)
    mesh = MeshSpec(**axes).build(device="cpu")
    full = params_from_numpy(inputs["params"][kind], "cpu")
    params = shard_params(full, mesh, ShardingRules(), model.param_logical_axes(cfg))
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = default_optimizer(learning_rate=args["lr"])
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    batch = shard_batch(inputs["batch"][kind], mesh)
    step = make_train_step(cfg, opt, mesh=mesh)
    losses, gnorms = [], []
    for _ in range(args["steps"]):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    gathered = tree_map(lambda v: v.full_tensor().detach().numpy(), state.params)
    x = batch["images"] if kind == "resnet" else shard_batch(
        {"inputs": inputs["batch"][kind]["tokens"][:, :-1]}, mesh)["inputs"]
    with torch.no_grad():
        logits = model.forward(state.params, x, cfg, mesh=mesh)
    forward = {"shape": list(logits.shape), "local_shape": list(logits.to_local().shape),
               "logits": logits.full_tensor().numpy()}
    if rank == 0:
        with open(args["out"][i], "wb") as f:
            pickle.dump({"losses": losses, "gnorms": gnorms, "params": gathered,
                         "forward": forward}, f)
dist.destroy_process_group()
"""


def _flatten(tree, prefix=""):
    """Nested dicts and lists -> {"a/0/b": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    return {p: v for k, sub in items for p, v in _flatten(sub, f"{prefix}{k}/").items()}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_config(kind):
    if kind == "llama":
        return JLlamaConfig.nano(dtype=jnp.float32)
    if kind == "resnet":
        return JResNetConfig.nano(dtype=jnp.float32)
    return JGPTConfig.nano(dtype=jnp.float32, **({"moe_experts": 4} if kind == "moe" else {}))


def _port_config(kind):
    from ray_tpu_torch.models import GPTConfig, LlamaConfig, ResNetConfig

    if kind == "llama":
        return LlamaConfig.nano(dtype=torch.float32)
    if kind == "resnet":
        return ResNetConfig.nano(dtype=torch.float32)
    return GPTConfig.nano(dtype=torch.float32, **({"moe_experts": 4} if kind == "moe" else {}))


def _batches():
    """One host batch per kind: tokens for the LMs, images and labels for ResNet."""
    tokens = np.random.default_rng(0).integers(0, 256, (B, S + 1)).astype(np.int32)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((RESNET_B, RESNET_HW, RESNET_HW, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (RESNET_B,)).astype(np.int32)
    lm = {"tokens": tokens}
    return {"gpt": lm, "llama": lm, "moe": lm, "resnet": {"images": images, "labels": labels}}


def _jax_run(kind, axes, batch):
    """The JAX package on the same mesh shape: losses, grad norms, params."""
    spec = JMeshSpec(**axes)
    mesh = spec.build(jax.devices()[: spec.num_devices])
    cfg, opt = _jax_config(kind), j_optimizer(learning_rate=LR)
    state = j_create(cfg, jax.random.PRNGKey(0), opt, mesh=mesh)
    step = j_step(cfg, opt, mesh=mesh, donate=False)
    if axes.get("context", 1) > 1:
        batch = {"inputs": batch["tokens"][:, :-1], "targets": batch["tokens"][:, 1:]}
    batch = j_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    losses, gnorms = [], []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return losses, gnorms, _flatten(jax.tree.map(np.asarray, state.params))


def _jax_first_grad(kind, params, batch):
    """The JAX package's gradient at the initial weights on one device, per leaf."""
    cfg = _jax_config(kind)
    model = j_model_for(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.jit(jax.grad(lambda p: model.loss_fn(p, jbatch, cfg)))(params)
    return _flatten(jax.tree.map(np.asarray, grads))


def _port_single(kind, params, batch):
    """The port on one device: losses and params after STEPS steps."""
    from ray_tpu_torch.models import TrainState, default_optimizer, make_train_step
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.models.training import tree_map

    cfg = _port_config(kind)
    opt = default_optimizer(learning_rate=LR)
    p = params_from_numpy(params, "cpu", requires_grad=True)
    state = TrainState(params=p, opt_state=opt.init(p), step=0)
    step = make_train_step(cfg, opt)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    losses = []
    for _ in range(STEPS):
        state, m = step(state, tbatch)
        losses.append(m["loss"].item())
    return losses, _flatten(tree_map(lambda t: t.detach().numpy(), state.params))


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The port's 4-rank gang over every case, started first and run beside
    the JAX package's runs; then both sides' results."""
    tmp = tmp_path_factory.mktemp("mesh")
    batches = _batches()
    init = {kind: jax.tree.map(np.asarray, j_create(_jax_config(kind), jax.random.PRNGKey(0),
                                                    j_optimizer(learning_rate=LR)).params)
            for kind in KINDS}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"params": init, "batch": batches}, f)
    args = {"port": _free_port(), "lr": LR, "steps": STEPS, "inputs": str(tmp / "inputs.pkl"),
            "cases": CASES, "out": [str(tmp / f"out{i}.pkl") for i in range(len(CASES))]}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", RANK_PROGRAM, json.dumps(args), str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        ref = [_jax_run(kind, axes, batches[kind]) for kind, axes in CASES]
        first = {kind: _jax_first_grad(kind, init[kind], batches[kind]) for kind in KINDS}
        single = {kind: _port_single(kind, init[kind], batches[kind]) for kind in KINDS}
        logs = []
        for p in procs:
            out, _ = p.communicate(timeout=GANG_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(l[-3000:] for l in logs)
    ours = []
    for path in args["out"]:
        with open(path, "rb") as f:
            ours.append(pickle.load(f))
    return {"ref": ref, "ours": ours, "single": single, "first": first,
            "init": {kind: _flatten(init[kind]) for kind in KINDS}}


def adam_band(first_grad):
    """The elements whose first gradient lies in ``ADAM_BAND``."""
    g = np.abs(first_grad)
    return (g >= ADAM_BAND[0]) & (g < ADAM_BAND[1])


def assert_params_close(got, want, init, band, name):
    """atol ``PARAM_ATOL`` outside ``band``; inside it, within the atol or
    moved the reference's way by at most ``STEPS * LR`` more or less."""
    np.testing.assert_allclose(got[~band], want[~band], atol=PARAM_ATOL, err_msg=name)
    d = np.abs(got - want)[band]
    same_way = (np.sign(got - init) == np.sign(want - init))[band]
    ok = (d <= PARAM_ATOL) | (same_way & (d <= STEPS * LR))
    assert np.all(ok), (name, np.flatnonzero(band)[~ok][:10], d[~ok][:10])


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{k}-" + "_".join(f"{a}{n}" for a, n in m.items()) for k, m in CASES])
def test_mesh_train_steps_match_jax(gang, case):
    kind, axes = CASES[case]
    ref_losses, ref_gnorms, ref_params = gang["ref"][case]
    ours = gang["ours"][case]
    np.testing.assert_allclose(ours["losses"], ref_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(ours["gnorms"], ref_gnorms, rtol=GNORM_RTOL)
    single_losses, single_params = gang["single"][kind]
    one_device = not (kind == "moe" and axes.get("pipeline", 1) > 1)
    if one_device:
        np.testing.assert_allclose(ours["losses"], single_losses, rtol=LOSS_RTOL)
    assert ours["losses"][-1] < ours["losses"][0]
    got_params, first, init = _flatten(ours["params"]), gang["first"][kind], gang["init"][kind]
    assert set(got_params) == set(ref_params) == set(single_params) == set(first)
    bands = {name: adam_band(first[name]) for name in first}
    in_band = sum(int(b.sum()) for b in bands.values())
    assert in_band <= MAX_BAND_SHARE_MODEL * sum(b.size for b in bands.values()), in_band
    for name in sorted(got_params):
        band = bands[name]
        assert band.mean() <= MAX_BAND_SHARE, (name, band.mean())
        for want in (ref_params[name], single_params[name])[:2 if one_device else 1]:
            assert_params_close(got_params[name], want, init[name], band, name)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{k}-" + "_".join(f"{a}{n}" for a, n in m.items()) for k, m in CASES])
def test_mesh_forward_is_the_global_logits(gang, case):
    # forward(mesh=) returns the logits as a DTensor of the global batch,
    # equal to one device's forward of the gathered params.
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.models.training import model_for

    kind, axes = CASES[case]
    out = gang["ours"][case]["forward"]
    batch = _batches()[kind]
    cfg = _port_config(kind)
    x = batch["images"] if kind == "resnet" else batch["tokens"][:, :-1]
    with torch.no_grad():
        want = model_for(cfg).forward(params_from_numpy(gang["ours"][case]["params"], "cpu"),
                                      torch.as_tensor(x), cfg).numpy()
    assert out["shape"] == list(want.shape)
    rows = want.shape[0] // (axes.get("data", 1) * axes.get("fsdp", 1))
    cols = want.shape[-1] // axes.get("tensor", 1)
    seq = [want.shape[1] // axes.get("context", 1)] if want.ndim == 3 else []
    assert out["local_shape"] == [rows, *seq, cols]
    np.testing.assert_allclose(out["logits"], want, atol=1e-5, rtol=1e-5)


def _make_fsdp_loop():
    def loop(config):
        import numpy as np
        import torch
        from torch.distributed.device_mesh import DeviceMesh

        from ray_tpu_torch.air import session
        from ray_tpu_torch.models import (GPTConfig, create_train_state, default_optimizer,
                                          make_train_step, shard_batch)

        mesh = session.get_mesh()
        assert isinstance(mesh, DeviceMesh) and session.get_mesh() is mesh
        cfg = GPTConfig.nano(dtype=torch.float32)
        opt = default_optimizer(learning_rate=config["lr"])
        state = create_train_state(cfg, 0, opt, mesh=mesh)
        batch = shard_batch({"tokens": np.asarray(config["tokens"])}, mesh)
        step = make_train_step(cfg, opt, mesh=mesh)
        losses = []
        for _ in range(config["steps"]):
            state, m = step(state, batch)
            losses.append(m["loss"].item())
        session.report({"losses": losses, "mesh_dim_names": list(mesh.mesh_dim_names),
                        "mesh_shape": list(mesh.mesh.shape),
                        "fc_w_local": list(state.params["blocks"]["fc_w"].to_local().shape),
                        "batch_local": {k: list(v.to_local().shape) for k, v in batch.items()}})

    return loop


def _trainer_losses(mesh, tokens):
    """``_make_fsdp_loop`` through a 2-worker ``TorchTrainer`` on ``mesh``
    (on the CPU), and the port's single-device losses on the same tokens."""
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.models import GPTConfig, create_train_state, default_optimizer
    from ray_tpu_torch.models import make_train_step, shard_batch
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    ray_tpu_torch.init(num_cpus=4)
    try:
        result = TorchTrainer(
            _make_fsdp_loop(),
            train_loop_config={"lr": LR, "steps": STEPS, "tokens": tokens.tolist()},
            scaling_config=ScalingConfig(num_workers=2, mesh=mesh),
            backend_config=TorchConfig(device="cpu"),
        ).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None, result.error
    cfg = GPTConfig.nano(dtype=torch.float32)
    opt = default_optimizer(learning_rate=LR)
    state = create_train_state(cfg, 0, opt, device="cpu")
    step = make_train_step(cfg, opt)
    batch = shard_batch({"tokens": tokens}, device="cpu")
    losses = []
    for _ in range(STEPS):
        state, out = step(state, batch)
        losses.append(out["loss"].item())
    return result.metrics, losses


def test_torch_trainer_fsdp_mesh_matches_one_device():
    tokens = np.random.default_rng(1).integers(0, 256, (B, S + 1)).astype(np.int32)
    m, losses = _trainer_losses({"fsdp": 2}, tokens)
    assert m["mesh_dim_names"] == ["data", "fsdp", "pipeline", "expert", "context", "tensor"]
    assert m["mesh_shape"] == [1, 2, 1, 1, 1, 1]
    assert m["fc_w_local"] == [2, 32, 256]  # (L, d/fsdp, F)
    np.testing.assert_allclose(m["losses"], losses, rtol=1e-5)


@pytest.mark.parametrize("axis", ["pipeline", "context"])
def test_torch_trainer_pipeline_and_context_meshes_match_one_device(axis):
    # A stage holds its one of the two layers; a context rank holds half of
    # each sequence, the tokens split into inputs and targets.
    tokens = np.random.default_rng(1).integers(0, 256, (B, S + 1)).astype(np.int32)
    m, losses = _trainer_losses({axis: 2}, tokens)
    assert m["mesh_dim_names"] == ["data", "fsdp", "pipeline", "expert", "context", "tensor"]
    assert m["mesh_shape"] == [1, 1, 2, 1, 1, 1] if axis == "pipeline" else [1, 1, 1, 1, 2, 1]
    if axis == "pipeline":
        assert m["fc_w_local"] == [1, 64, 256]  # (L/P, d, F)
        assert m["batch_local"] == {"tokens": [B, S + 1]}
    else:
        assert m["fc_w_local"] == [2, 64, 256]
        assert m["batch_local"] == {"inputs": [B, S // 2], "targets": [B, S // 2]}
    np.testing.assert_allclose(m["losses"], losses, rtol=1e-5)


def _make_mesh_loop():
    def loop(config):
        from ray_tpu_torch.air import session

        session.report({"mesh_device": session.get_mesh().device_type})

    return loop


def test_trainer_mesh_wants_the_gpu_unless_the_cpu_is_asked_for():
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    ray_tpu_torch.init(num_cpus=2)
    try:
        result = TorchTrainer(_make_mesh_loop(), scaling_config=ScalingConfig(num_workers=1),
                              backend_config=TorchConfig(device="cpu")).fit()
        assert result.error is None and result.metrics["mesh_device"] == "cpu"
        with pytest.raises(Exception) as failed:
            result = TorchTrainer(_make_mesh_loop(), scaling_config=ScalingConfig(num_workers=1)).fit()
            raise result.error or AssertionError("the mesh was built without a GPU")
    finally:
        ray_tpu_torch.shutdown()
    text = f"{failed.value!r} {failed.value.__cause__!r}"
    assert "no CUDA device is available" in text, text


def test_pipeline_context_and_expert_axes_raise():
    # Since pipeline and context parallelism were ported only the expert
    # axis raises; the name is kept from when all three did.
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.models import GPTConfig, create_train_state, default_optimizer
    from ray_tpu_torch.parallel import MeshSpec

    cfg = GPTConfig.nano(dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 3"):
        ScalingConfig(num_workers=2, mesh={"expert": 2})
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 3"):
        create_train_state(cfg, 0, default_optimizer(), mesh=MeshSpec(expert=2))
    for axis in ("pipeline", "context"):
        ScalingConfig(num_workers=2, mesh={axis: 2})  # ported: accepted


if __name__ == "__main__":
    # The share of each leaf's elements in ADAM_BAND, per model, at the
    # initial weights and batch the gang trains from.
    batches = _batches()
    for kind in KINDS:
        params = jax.tree.map(np.asarray, j_create(_jax_config(kind), jax.random.PRNGKey(0),
                                                   j_optimizer(learning_rate=LR)).params)
        first = _jax_first_grad(kind, params, batches[kind])
        bands = {name: adam_band(g) for name, g in first.items()}
        total = sum(int(b.sum()) for b in bands.values())
        size = sum(b.size for b in bands.values())
        print(kind, f"model {total}/{size} = {total / size:.4%}", {
            name: f"{int(b.sum())}/{b.size} = {b.mean():.4%}" for name, b in bands.items() if b.any()})
