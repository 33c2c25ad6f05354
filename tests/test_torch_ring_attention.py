"""Ring and Ulysses attention in the port (``ray_tpu_torch.parallel.ring_attention``)
against the JAX package's (``ray_tpu.parallel.ring_attention``) on the CPU, in f32.

- The ring's block loop and merge over C virtual slices in one process
  (``ring_forward``/``ring_backward`` with ``VirtualRing``: the code the
  distributed ring runs, minus the sends; the flash kernels' plain versions
  on the CPU) against ``ring_attention_sharded`` on a C-device virtual mesh:
  the output and dq, dk, dv, causal and not, C 2 and 4, atol 1e-5.
- A 4-rank gloo gang (subprocesses that never import JAX) runs the kernel
  ring (``ring_attention``), the plain ring (``ring_attention_plain``,
  autograd through ``ppermute``) and ``ulysses_attention`` (autograd through
  ``all_to_all``) over the world (C 4) and over two 2-rank groups (C 2),
  each rank on its slice of the same inputs; the slices put together against
  ``ring_attention_sharded`` and ``ulysses_attention`` under ``shard_map``,
  atol 1e-5.
"""

import functools
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
from jax.sharding import PartitionSpec as P

from ray_tpu._private.jax_compat import shard_map
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel.ring_attention import ring_attention_sharded, ulysses_attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 4, 64, 64)  # (batch, heads, seq, head_dim)
ATOL = 1e-5
GANG_TIMEOUT_S = 120
GANG_CASES = [(kind, n, causal) for kind in ("ring", "plain") for n in (2, 4)
              for causal in (True, False)] + [("ulysses", 2, True), ("ulysses", 4, True)]


def _inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]  # q, k, v, do


@functools.lru_cache(maxsize=None)
def _jax_ref(kind, n, causal):
    """The JAX package's output and (dq, dk, dv) on ``_inputs``, for the
    cotangent ``do`` (kind "ring" or "ulysses")."""
    q, k, v, do = _inputs()
    mesh = JMeshSpec(context=n).build(jax.devices()[:n])
    if kind == "ulysses":
        spec = P(None, None, "context", None)
        fn = shard_map(functools.partial(ulysses_attention, axis_name="context", axis_size=n,
                                         causal=causal),
                       mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)
    else:
        fn = functools.partial(ring_attention_sharded, mesh, causal=causal)
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(t) for t in (out, *vjp(jnp.asarray(do)))]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("n", [2, 4])
def test_virtual_ring_matches_jax(n, causal):
    from ray_tpu_torch.parallel.ring_attention import VirtualRing, ring_backward, ring_forward

    q, k, v, do = _inputs()
    b, h, s, d = SHAPE

    def slices(x):  # (b, h, s, d) -> n slices (b*h, s/n, d)
        return list(torch.as_tensor(x).reshape(b * h, n, s // n, d).unbind(1))

    def whole(parts):
        return torch.stack(parts, 1).reshape(SHAPE).numpy()

    qs, ks, vs, dos = slices(q), slices(k), slices(v), slices(do)
    ranks, scale = list(range(n)), d ** -0.5
    os_, lses = ring_forward(qs, ks, vs, ranks, n, causal, scale, VirtualRing())
    grads = ring_backward(qs, ks, vs, os_, lses, dos, ranks, n, causal, scale, VirtualRing())
    ref = _jax_ref("ring", n, causal)
    for name, got, want in zip(("o", "dq", "dk", "dv"), (os_, *grads), ref):
        np.testing.assert_allclose(whole(got), want, atol=ATOL, err_msg=name)


RANK_PROGRAM = r"""
import datetime, json, pickle, sys
import torch, torch.distributed as dist
args, rank = json.loads(sys.argv[1]), int(sys.argv[2])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args['port']}", rank=rank,
                        world_size=4, timeout=datetime.timedelta(seconds=60))
from ray_tpu_torch.parallel.ring_attention import (ring_attention, ring_attention_plain,
                                                   ulysses_attention)
FNS = {"ring": ring_attention, "plain": ring_attention_plain, "ulysses": ulysses_attention}
with open(args["inputs"], "rb") as f:
    q, k, v, do = (torch.as_tensor(x) for x in pickle.load(f))
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
out = []
for kind, n, causal in args["cases"]:
    group = dist.group.WORLD if n == 4 else pairs[rank // 2]
    me = dist.get_rank(group)
    s_local = q.shape[2] // n
    cut = lambda x: x[:, :, me * s_local:(me + 1) * s_local].contiguous().requires_grad_()
    ql, kl, vl = cut(q), cut(k), cut(v)
    o = FNS[kind](ql, kl, vl, group, causal=causal)
    o.backward(cut(do).detach())
    out.append([t.detach().numpy() for t in (o, ql.grad, kl.grad, vl.grad)])
with open(args["out"].format(rank), "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    inputs = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = {"port": port, "inputs": str(tmp / "inputs.pkl"), "cases": GANG_CASES,
            "out": str(tmp / "out{}.pkl")}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", RANK_PROGRAM, json.dumps(args), str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        ref = [_jax_ref("ulysses" if kind == "ulysses" else "ring", n, causal)
               for kind, n, causal in GANG_CASES]
        logs = [p.communicate(timeout=GANG_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(l[-3000:] for l in logs)
    ours = []
    for r in range(4):
        with open(args["out"].format(r), "rb") as f:
            ours.append(pickle.load(f))
    return ref, ours


@pytest.mark.parametrize("case", range(len(GANG_CASES)),
                         ids=[f"{k}-C{n}-{'causal' if c else 'noncausal'}"
                              for k, n, c in GANG_CASES])
def test_gang_matches_jax(gang, case):
    ref, ours = gang
    _, n, _ = GANG_CASES[case]
    # The world (C 4), or each of the two pairs (C 2) on the same inputs.
    groups = [[0, 1, 2, 3]] if n == 4 else [[0, 1], [2, 3]]
    for ranks in groups:
        for i, name in enumerate(("o", "dq", "dk", "dv")):
            got = np.concatenate([ours[r][case][i] for r in ranks], axis=2)
            np.testing.assert_allclose(got, ref[case][i], atol=ATOL, err_msg=f"{name} {ranks}")
