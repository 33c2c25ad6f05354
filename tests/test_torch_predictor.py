"""The predictor and pytree checkpoints of the port, on the CPU.

- ``TorchPredictor(device="cpu")`` against ``JaxPredictor`` on the same numpy
  checkpoint: the linear case of tests/test_batch_predictor.py (with
  ``feature_columns`` and ``__call__``) and a nano GPT's per-token NLL
  (weights from JAX through ``params_from_numpy``), 1e-5 in f32; the missing
  key's error word for word; ``device=None`` raising without a GPU.
- ``BatchPredictor.predict`` over a Dataset: the JAX package's pool of
  ``JaxPredictor`` actors and the port's pool of ``TorchPredictor(device=
  "cpu")`` actors (``num_gpus_per_worker=0``) give each row the same nano
  GPT NLLs (1e-5 in f32), ``keep_columns`` carried through; with the default
  ``num_gpus_per_worker`` on two logical GPUs' worth of one card, the pool's
  actors share device "0" and hold the node's whole ``GPU`` while they live.
- ``save_pytree``/``load_pytree``: nested dicts, lists and tuples of f32 and
  bf16 tensors, numpy arrays and scalars, equal bit for bit with their types
  and dtypes; a ``pytree.pkl`` the JAX package's fallback writes; the
  orbax-only directory's error; a sharded leaf (a DTensor on two gloo ranks)
  gathered whole.
"""

import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.air.checkpoint as jckpt
from ray_tpu.air.checkpoint import Checkpoint as JaxCheckpoint
from ray_tpu.models import gpt as jgpt
from ray_tpu.train import JaxPredictor
from ray_tpu_torch.air.checkpoint import Checkpoint, load_pytree, save_pytree
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.train import BatchPredictor, Predictor, TorchPredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

ATOL = 1e-5


def _linear_params():
    # y = x @ w + b with known weights (tests/test_batch_predictor.py).
    return {"w": np.array([[2.0], [3.0]], np.float32), "b": np.float32(1.0)}


def _apply_jax(params, feats):
    return feats @ params["w"] + params["b"]


def _apply_torch(params, feats):
    return feats @ params["w"] + params["b"]


def test_linear_predictor_matches_jax():
    batch = {"a": np.array([1.0, 2.0, -0.5]), "b": np.array([0.0, 1.0, 4.0])}
    jp = JaxPredictor.from_checkpoint(JaxCheckpoint(data_dict={"params": _linear_params()}),
                                      apply_fn=_apply_jax, feature_columns=["a", "b"])
    tp = TorchPredictor.from_checkpoint(Checkpoint(data_dict={"params": _linear_params()}),
                                        apply_fn=_apply_torch, feature_columns=["a", "b"],
                                        device="cpu")
    assert isinstance(tp, Predictor)
    want = jp.predict(batch)["predictions"]
    got = tp.predict(batch)
    assert set(got) == {"predictions"} and isinstance(got["predictions"], np.ndarray)
    np.testing.assert_allclose(got["predictions"], want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["predictions"].ravel(), [3.0, 8.0, 12.0])
    # __call__ (the map_batches class-UDF protocol) is predict.
    np.testing.assert_array_equal(tp(batch)["predictions"], got["predictions"])
    assert all(t.device.type == "cpu" for t in tp.params.values())


def test_gpt_next_token_nll_matches_jax():
    jcfg = jgpt.GPTConfig.nano(dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.nano(dtype=torch.float32)
    weights = jax.tree.map(np.asarray, jgpt.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(0, 255, (2, 33)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}

    def jax_nll(params, b):
        logits = jgpt.forward(params, b["tokens"], jcfg)
        target = jnp.take_along_axis(logits, b["targets"][..., None], -1)[..., 0]
        return jax.nn.logsumexp(logits, -1) - target

    want = JaxPredictor.from_checkpoint(JaxCheckpoint(data_dict={"model": weights}),
                                        apply_fn=jax_nll, params_key="model",
                                        predictions_column="nll").predict(batch)["nll"]
    tp = TorchPredictor.from_checkpoint(
        Checkpoint(data_dict={"model": params_from_numpy(weights, "cpu")}),
        apply_fn=chip_smoke.next_token_nll_fn(tcfg), params_key="model",
        predictions_column="nll", device="cpu")
    got = tp.predict(batch)["nll"]
    assert got.shape == (2, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # The mean is the causal LM loss of the same tokens.
    assert float(got.mean()) == pytest.approx(
        float(jgpt.loss_fn(weights, {"tokens": jnp.asarray(tokens)}, jcfg)), abs=ATOL)


def test_missing_params_key_raises_as_jax():
    errors = []
    for cls, ckpt, apply in ((JaxPredictor, JaxCheckpoint, _apply_jax),
                             (TorchPredictor, Checkpoint, _apply_torch)):
        with pytest.raises(ValueError, match="no 'params'") as e:
            cls.from_checkpoint(ckpt(data_dict={"weights": 1}), apply_fn=apply)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_predictor_on_the_gpu_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchPredictor(_linear_params(), _apply_torch)


def _nano_rows(n=8, seq=16):
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 255, (n, seq + 1)).astype(np.int32)
    return [{"tokens": t[:-1], "targets": t[1:], "id": i} for i, t in enumerate(tokens)]


def test_batch_predictor_scoring_waits_for_data():
    # The name is the one this case had while the Data library was unported;
    # it now scores a Dataset through both packages' actor pools.
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu import data as jdata
    from ray_tpu.train import BatchPredictor as JaxBatchPredictor
    from ray_tpu_torch import data as tdata

    jcfg = jgpt.GPTConfig.nano(dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.nano(dtype=torch.float32)
    weights = jax.tree.map(np.asarray, jgpt.init_params(jcfg, jax.random.PRNGKey(0)))
    rows = _nano_rows()

    def jax_nll(params, b):
        logits = jgpt.forward(params, b["tokens"], jcfg)
        target = jnp.take_along_axis(logits, b["targets"][..., None], -1)[..., 0]
        return jax.nn.logsumexp(logits, -1) - target

    ray_tpu.init(num_cpus=4)
    try:
        want = JaxBatchPredictor.from_checkpoint(
            JaxCheckpoint(data_dict={"params": weights}), JaxPredictor, apply_fn=jax_nll,
        ).predict(jdata.from_items(rows, parallelism=4), feature_columns=["tokens", "targets"],
                  keep_columns=["id"], batch_size=2, num_workers=2).take_all()
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        bp = BatchPredictor.from_checkpoint(
            Checkpoint(data_dict={"params": params_from_numpy(weights, "cpu")}), TorchPredictor,
            apply_fn=chip_smoke.next_token_nll_fn(tcfg), device="cpu")
        got = bp.predict(tdata.from_items(rows, parallelism=4),
                         feature_columns=["tokens", "targets"], keep_columns=["id"],
                         batch_size=2, num_workers=2, num_gpus_per_worker=0).take_all()
    finally:
        ray_tpu_torch.shutdown()
    assert len(got) == len(want) == len(rows)
    assert all(sorted(r) == ["id", "predictions"] for r in got)
    got = {int(r["id"]): r["predictions"] for r in got}
    want = {int(r["id"]): r["predictions"] for r in want}
    assert sorted(got) == sorted(want) == list(range(len(rows)))
    for i in got:
        assert got[i].shape == (16,) and got[i].dtype == np.float32
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=ATOL)


def test_batch_predictor_shares_one_gpu_by_default():
    # num_gpus_per_worker=None: the pool together holds one GPU, 1/2 each,
    # packed onto one device id. Logical GPUs: no CUDA is touched.
    import ray_tpu_torch
    from ray_tpu_torch import data as tdata

    class Where(Predictor):
        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            return cls()

        def predict(self, batch):
            seen = os.environ.get("CUDA_VISIBLE_DEVICES")
            free = ray_tpu_torch.available_resources().get("GPU", 0.0)
            return {"visible": np.array([seen] * len(batch["id"])),
                    "gpu_free": np.full(len(batch["id"]), free), "pid": np.full(len(batch["id"]), os.getpid())}

    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        bp = BatchPredictor.from_checkpoint(Checkpoint(data_dict={"params": {}}), Where)
        rows = bp.predict(tdata.range(16, parallelism=4), batch_size=4,
                          num_workers=2).take_all()
        assert len(rows) == 16
        assert {str(r["visible"]) for r in rows} == {"0"}
        assert {float(r["gpu_free"]) for r in rows} == {0.0}
        assert len({int(r["pid"]) for r in rows}) == 2
        # The pool's actors are killed when the run ends; their shares return.
        deadline = time.monotonic() + 30
        while ray_tpu_torch.available_resources().get("GPU") != 1.0:
            assert time.monotonic() < deadline, ray_tpu_torch.available_resources()
            time.sleep(0.1)
        with pytest.raises(ValueError, match="asks for 3 GPU .* cluster has 1"):
            bp.predict(tdata.range(4), num_workers=3, num_gpus_per_worker=1).take_all()
    finally:
        ray_tpu_torch.shutdown()


# ------------------------------------------------------------------ pytree checkpoints
def _tree():
    g = torch.Generator().manual_seed(0)
    return {"f32": torch.randn((3, 4), generator=g),
            "bf16": torch.randn((5,), generator=g).to(torch.bfloat16),
            "layers": [{"w": torch.randn((2, 2), generator=g), "n": np.arange(3)},
                       (torch.ones(1), np.float32(2.5), 7)],
            "step": 11, "name": "nano", "scale": np.float64(0.125)}


def _assert_same(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def test_pytree_round_trips_bit_for_bit(tmp_path):
    tree = _tree()
    save_pytree(tree, str(tmp_path))
    assert os.listdir(tmp_path) == ["pytree.pkl"]
    loaded = load_pytree(str(tmp_path))
    _assert_same(tree, loaded)
    # A tensor that needs grad comes back detached, and a later in-place
    # update of the original leaves the saved tree as it was.
    w = torch.ones(3, requires_grad=True)
    save_pytree({"w": w}, str(tmp_path))
    with torch.no_grad():
        w.add_(1.0)
    back = load_pytree(str(tmp_path))["w"]
    assert not back.requires_grad and torch.equal(back, torch.ones(3))


def test_pytree_written_by_the_jax_fallback_loads(tmp_path):
    # The JAX package's portable path (ray_tpu/air/checkpoint.py:199-200):
    # its host tree pickled to <path>/pytree.pkl, numpy leaves.
    jcfg = jgpt.GPTConfig.nano(dtype=jnp.float32)
    params = jgpt.init_params(jcfg, jax.random.PRNGKey(1))
    with open(tmp_path / "pytree.pkl", "wb") as fh:
        pickle.dump(jckpt._tree_to_host({"params": params, "step": 3}), fh)
    loaded = load_pytree(str(tmp_path))
    assert loaded["step"] == 3
    leaves = jax.tree.leaves(loaded["params"])
    assert leaves and all(isinstance(x, np.ndarray) for x in leaves)
    tparams = params_from_numpy(loaded["params"], "cpu")
    tokens = np.random.default_rng(1).integers(0, 255, (1, 17)).astype(np.int32)
    got = tgpt.loss_fn(tparams, {"tokens": torch.as_tensor(tokens)},
                       tgpt.GPTConfig.nano(dtype=torch.float32)).item()
    assert got == pytest.approx(float(jgpt.loss_fn(params, {"tokens": jnp.asarray(tokens)}, jcfg)),
                                rel=1e-5)


def test_orbax_only_directory_raises(tmp_path):
    os.makedirs(tmp_path / "pytree")
    with pytest.raises(ValueError, match="orbax checkpoint"):
        load_pytree(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no pytree.pkl"):
        load_pytree(str(tmp_path / "pytree"))


_RANK = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    sys.path.insert(0, {root!r})
    from ray_tpu_torch.air.checkpoint import load_pytree, save_pytree

    rank = int(sys.argv[1])
    dist.init_process_group("gloo", init_method={addr!r}, rank=rank, world_size=2)
    mesh = init_device_mesh("cpu", (2,))
    full = torch.arange(24.0).reshape(6, 4)
    w = distribute_tensor(full, mesh, [Shard(0)])
    assert isinstance(w, DTensor) and w.to_local().shape == (3, 4)
    # Every rank saves (the gather is a collective), each to its own path.
    save_pytree({{"w": w, "step": 2}}, {path!r} + f"/rank{{rank}}")
    back = load_pytree({path!r} + f"/rank{{rank}}")
    assert type(back["w"]) is torch.Tensor and torch.equal(back["w"], full), back
    dist.destroy_process_group()
    print("ok", rank)
""")


def test_dtensor_leaf_is_gathered_whole(tmp_path):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    addr = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    code = _RANK.format(root=ROOT, addr=addr, path=str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.strip().splitlines()[-1] for o in outs] == ["ok 0", "ok 1"]
