"""The port's Train stack (ray_tpu_torch.train) against the JAX package's on
the CPU.

- GPT nano in f32 through the port's ``TorchTrainer`` (1 worker, weights from
  the JAX package's init carried across with ``params_from_numpy``) against
  the JAX package's nano step through its ``JaxTrainer``, same weights and
  batch, 3 steps: losses and grad norms within rtol 1e-5, the tolerance of
  ``tests/test_torch_training.py``.
- A 2-worker gloo DDP loop through the port's ``TorchTrainer`` against
  ``ray_tpu.train.torch.TorchTrainer``: the same final weights, exactly.
- A checkpoint of torch tensors through ``session.report(checkpoint=...)``
  arrives in ``Result.checkpoint`` as detached CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import GPTConfig as JGPTConfig
from ray_tpu.models import create_train_state as j_create
from ray_tpu.models import default_optimizer as j_optimizer

STEPS = 3
LR = 1e-3
RTOL = 1e-5


def _nano_inputs():
    state = j_create(JGPTConfig.nano(dtype=jnp.float32), jax.random.PRNGKey(0),
                     j_optimizer(learning_rate=LR))
    params = jax.tree.map(np.asarray, state.params)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 33)).astype(np.int32)
    return {"params": params, "tokens": tokens}


# Loops are made by factories so cloudpickle ships them by value: a function
# defined at the top of a test module pickles by reference, which a worker
# cannot import.
def _make_jax_nano_loop():
    def loop(config):
        import jax
        import jax.numpy as jnp

        from ray_tpu.air import session
        from ray_tpu.models import GPTConfig, TrainState, default_optimizer, make_train_step

        cfg = GPTConfig.nano(dtype=jnp.float32)
        opt = default_optimizer(learning_rate=config["lr"])
        params = jax.tree.map(jnp.asarray, config["params"])
        state = TrainState(params=params, opt_state=opt.init(params), step=jnp.asarray(0))
        step = make_train_step(cfg, opt, donate=False)
        losses, gnorms = [], []
        for _ in range(config["steps"]):
            state, m = step(state, {"tokens": jnp.asarray(config["tokens"])})
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            session.report({"losses": list(losses), "grad_norms": list(gnorms)})

    return loop


def _make_port_nano_loop():
    def loop(config):
        import torch

        from ray_tpu_torch.air import session
        from ray_tpu_torch.models import GPTConfig, TrainState, default_optimizer, make_train_step
        from ray_tpu_torch.models.convert import params_from_numpy

        cfg = GPTConfig.nano(dtype=torch.float32)
        opt = default_optimizer(learning_rate=config["lr"])
        params = params_from_numpy(config["params"], "cpu", requires_grad=True)
        state = TrainState(params=params, opt_state=opt.init(params), step=0)
        step = make_train_step(cfg, opt)
        losses, gnorms = [], []
        for _ in range(config["steps"]):
            state, m = step(state, {"tokens": torch.as_tensor(config["tokens"])})
            losses.append(m["loss"].item())
            gnorms.append(m["grad_norm"].item())
            session.report({"losses": list(losses), "grad_norms": list(gnorms)})

    return loop


def _make_ddp_loop(prepare_model, session):
    """The DDP loop of tests/test_train_torch.py, reporting its final weights
    through ``session`` (each package's own)."""

    def loop(config):
        import torch
        import torch.distributed as dist
        import torch.nn.functional as F

        torch.manual_seed(0)
        model = prepare_model(torch.nn.Linear(4, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        rank = dist.get_rank() if dist.is_initialized() else 0
        g = torch.Generator().manual_seed(100 + rank)
        w_true = torch.arange(1.0, 5.0)
        for _ in range(20):
            x = torch.randn(16, 4, generator=g)
            opt.zero_grad()
            F.mse_loss(model(x), x @ w_true[:, None]).backward()
            opt.step()
        lin = model.module if hasattr(model, "module") else model
        metrics = {"world_size": dist.get_world_size() if dist.is_initialized() else 1,
                   "weight": lin.weight.detach().flatten().tolist(),
                   "bias": lin.bias.detach().tolist()}
        session.report(metrics)

    return loop


@pytest.fixture(scope="module")
def reference():
    """The JAX package's runs, made before the port's runtime starts: the nano
    step through JaxTrainer and the DDP loop through its TorchTrainer."""
    from ray_tpu.air import ScalingConfig, session
    from ray_tpu.train.jax import JaxTrainer
    from ray_tpu.train.torch import TorchTrainer, prepare_model

    inputs = _nano_inputs()
    ray_tpu.init(num_cpus=4)
    try:
        nano = JaxTrainer(
            _make_jax_nano_loop(),
            train_loop_config={**inputs, "lr": LR, "steps": STEPS},
            scaling_config=ScalingConfig(num_workers=1),
        ).fit()
        ddp = TorchTrainer(
            _make_ddp_loop(prepare_model, session),
            scaling_config=ScalingConfig(num_workers=2),
        ).fit()
    finally:
        ray_tpu.shutdown()
    return {"inputs": inputs, "nano": nano, "ddp": ddp}


@pytest.fixture(scope="module")
def port(reference):
    """The port's runtime, started after the reference's has shut down."""
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_torch_trainer_nano_matches_jax_trainer(reference, port):
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    result = TorchTrainer(
        _make_port_nano_loop(),
        train_loop_config={**reference["inputs"], "lr": LR, "steps": STEPS},
        scaling_config=ScalingConfig(num_workers=1),
    ).fit()
    assert result.error is None and reference["nano"].error is None
    ours, ref = result.metrics, reference["nano"].metrics
    assert len(ours["losses"]) == len(ref["losses"]) == STEPS
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=RTOL)
    np.testing.assert_allclose(ours["grad_norms"], ref["grad_norms"], rtol=RTOL)
    assert ours["losses"][-1] < ours["losses"][0]


def test_two_worker_gloo_ddp_matches_ray_tpu(reference, port):
    from ray_tpu_torch.air import ScalingConfig, session
    from ray_tpu_torch.train.torch import TorchTrainer, prepare_model

    result = TorchTrainer(
        _make_ddp_loop(prepare_model, session), scaling_config=ScalingConfig(num_workers=2)
    ).fit()
    assert result.error is None and reference["ddp"].error is None
    ours, ref = result.metrics, reference["ddp"].metrics
    assert ours["world_size"] == ref["world_size"] == 2
    assert ours["weight"] == ref["weight"] and ours["bias"] == ref["bias"]


def test_checkpoint_of_torch_tensors_arrives_as_cpu_tensors(port):
    from ray_tpu_torch.air import Checkpoint, ScalingConfig, session
    from ray_tpu_torch.train.torch import TorchTrainer

    def loop(config):
        import torch

        w = torch.ones(3, requires_grad=True) * 2  # a non-leaf: pickles only detached
        state = {"w": w, "nested": [torch.arange(4), {"b": torch.zeros(2)}], "step": 3}
        session.report({"step": 3}, checkpoint=Checkpoint.from_dict(state))

    result = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=1)).fit()
    assert result.error is None
    got = result.checkpoint.to_dict()
    assert got["step"] == 3
    w, (idx, inner) = got["w"], got["nested"]
    for t in (w, idx, inner["b"]):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu" and not t.requires_grad
    assert w.tolist() == [2.0, 2.0, 2.0] and idx.tolist() == [0, 1, 2, 3]
    assert inner["b"].tolist() == [0.0, 0.0]
