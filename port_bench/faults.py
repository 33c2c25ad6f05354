"""Faults planted in the port's timed path, to show that the check fails
them. ``plant(name)`` patches the port's modules in this process only; a
benchmark run never plants one (``run.py``'s command line has no way to ask
for it): the control (``control.py``) and the tests do.

- ``unchanged``: the step returns its state unchanged (the optimizer's
  update does nothing but return the gradient's norm).
- ``half_batch``: the loss is taken over the first half of the batch's rows,
  its mean over those alone (in the function the architecture's
  ``HALF_BATCH`` names).
- ``no_exchange``: on a mesh, each rank's gradient keeps its own part and
  skips the all-reduce between the ranks.

``plant`` returns a function that takes the fault out again.
"""

from __future__ import annotations

FAULTS = ("unchanged", "half_batch", "no_exchange")


def plant(name, model):
    """Plant fault ``name`` in the port's step of ``model`` (a configuration
    file's contents)."""
    import importlib

    from port_bench import archs
    from ray_tpu_torch.models import training

    if name == "unchanged":
        owner, attr = training.AdamW, "update_"

        def broken(self, params, grads, opt_state):
            return training.global_norm(grads)
    elif name == "half_batch":
        module, attr = archs.of(model).HALF_BATCH
        owner = importlib.import_module(module)
        loss_fn = getattr(owner, attr)

        def broken(params, batch, *args, **kw):
            return loss_fn(params, {k: _first_half(v) for k, v in batch.items()}, *args, **kw)
    elif name == "no_exchange":
        owner, attr = training, "_reduce_grad"

        def broken(g, param):
            from torch.distributed.tensor import DTensor

            if not isinstance(g, DTensor) or tuple(g.placements) == tuple(param.placements):
                return g
            return DTensor.from_local(g.to_local(), param.device_mesh, param.placements,
                                      run_check=False, shape=param.shape, stride=param.stride())
    else:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    original = getattr(owner, attr)
    setattr(owner, attr, broken)
    return lambda: setattr(owner, attr, original)


def _first_half(t):
    if hasattr(t, "to_local"):
        from ray_tpu_torch.parallel.mesh import batch_spec, host_local_to_global

        local = t.to_local()
        return host_local_to_global(t.device_mesh, batch_spec(), local[: local.shape[0] // 2])
    return t[: t.shape[0] // 2]
