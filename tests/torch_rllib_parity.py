"""Helpers the RLlib parity tests share (tests/test_torch_rllib_*.py): the
JAX and the port's algorithm driven by the same stub actors, and the
comparisons of losses, gradients and trees.

Stub actors: ``Stub(obj)`` answers ``handle.method.remote(*args)`` with a
``Ref`` holding ``obj.method(*args)``; ``get``/``wait`` patched into both
packages resolve them at once. Both algorithms see the same rollouts,
shards and files, so the only difference left is the learner's framework.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.training import tree_leaves, tree_map

# Losses, aux and gradients: |ours - JAX| <= ATOL + RTOL * |JAX| (f32).
ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread in this process for each test, as the port's RL
    actors run (the learners here are tiny)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Ref:
    """A finished call's result, as an actor call's ObjectRef stands for it."""

    def __init__(self, value):
        self.value = value


class _Method:
    def __init__(self, fn):
        self._fn = fn

    def remote(self, *args, **kwargs):
        return Ref(self._fn(*args, **kwargs))


class Stub:
    """An actor handle over a local object: every method has ``.remote``."""

    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, name):
        return _Method(getattr(self._obj, name))


class _StubClass:
    """What ``remote(cls)`` returns when patched: ``.options(...).remote(*a)``
    builds a Stub over ``cls(*a)``."""

    def __init__(self, cls):
        self._cls = cls

    def options(self, **_):
        return self

    def remote(self, *args, **kwargs):
        return Stub(self._cls(*args, **kwargs))


class FixedRunner:
    """An env runner whose every fragment is the same rollout."""

    def __init__(self, rollout):
        self.rollout = rollout

    def set_weights(self, weights):
        pass

    def set_exploration(self, value):
        pass

    def sample(self, explore=None):
        return self.rollout

    def episode_stats(self, clear=True):
        return {"episodes": 0}


def _get(x, timeout=None):
    return [_get(r) for r in x] if isinstance(x, list) else x.value if isinstance(x, Ref) else x


def _wait(refs, num_returns=1, timeout=None):
    return list(refs[:num_returns]), list(refs[num_returns:])


def patch_runtimes(monkeypatch):
    """Both packages' get, wait and remote resolve stubs in this process."""
    for pkg in (ray_tpu, ray_tpu_torch):
        monkeypatch.setattr(pkg, "get", _get)
        monkeypatch.setattr(pkg, "wait", _wait)
        monkeypatch.setattr(pkg, "remote", _StubClass)


def build_both(monkeypatch, jax_cfg, cfg, rollouts=()):
    """The JAX and the port's algorithm (learner on the CPU), built with no
    runner, then given the same stub runners (one per rollout), the JAX
    learner's weights and its extra state (targets)."""
    patch_runtimes(monkeypatch)
    ja = jax_cfg.env_runners(num_env_runners=0).build()
    ta = cfg.env_runners(num_env_runners=0).learners(num_gpus_per_learner=0).build()
    ta.learner_group.set_weights(jax_numpy(ja.learner_group.get_weights()))
    extra = ja.learner_group.get_extra()
    if extra is not None:
        ta.learner_group.set_extra(jax_numpy(extra))
    for a in (ja, ta):
        a.env_runners = [Stub(FixedRunner(ro)) for ro in rollouts]
    return ja, ta


def jax_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def assert_trees_close(ours, theirs, atol=1e-5):
    """Leaf for leaf, ``theirs`` (a JAX tree, keys sorted) in ``ours``' order."""
    theirs = tree_map(lambda _, t: np.asarray(t), ours, theirs)
    for a, b in zip(tree_leaves(ours), tree_leaves(theirs)):
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=atol)


def close(ours, theirs, what=""):
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(theirs, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def assert_loss_matches(jloss, tloss, jm, tm, weights, batch, extra=None):
    """One loss of each package on the same weights, batch and extra state:
    the loss, every aux value and every gradient leaf within ATOL/RTOL."""
    import jax.numpy as jnp

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jextra = None if extra is None else jax.tree.map(jnp.asarray, extra)

    def jf(p):
        return jloss(jm, p, jbatch, jextra) if extra is not None else jloss(jm, p, jbatch)

    (jl, jaux), jg = jax.value_and_grad(jf, has_aux=True)(jax.tree.map(jnp.asarray, weights))
    tw = params_from_numpy(weights, "cpu")
    for leaf in tree_leaves(tw):
        leaf.requires_grad_(True)
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    if extra is not None:
        tl, taux = tloss(tm, tw, tbatch, params_from_numpy(extra, "cpu"))
    else:
        tl, taux = tloss(tm, tw, tbatch)
    grads = torch.autograd.grad(tl, tree_leaves(tw), allow_unused=True)
    close(tl.item(), jl, "loss")
    assert taux.keys() == jaux.keys()
    for k in jaux:
        close(taux[k].detach(), jaux[k], k)
    it = iter(grads)
    tgrads = tree_map(lambda t: next(it), tw)
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        node = tgrads
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        node = np.zeros_like(g) if node is None else node.numpy()
        close(node, g, str(path))
    return float(jl)
