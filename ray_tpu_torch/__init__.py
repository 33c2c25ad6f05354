"""ray_tpu_torch: the PyTorch and CUDA port of ``ray_tpu``, for NVIDIA Hopper.

The port is a package of its own: it imports ``torch``, numpy, cloudpickle and
the standard library, never ``jax`` and nothing of ``ray_tpu``. It holds the
one-node runtime (``init``/``remote``/``get``/``put``/``wait``, actors,
placement groups: the in-process scheduler, worker subprocesses and the
shared-memory object store), the Train stack (``ray_tpu_torch.train``:
``DataParallelTrainer``, ``TorchTrainer``), the per-worker GPT-2 train step
(``ray_tpu_torch.models``) and the flash-attention kernels hand-written in CUDA
(``ray_tpu_torch.ops``). A node's GPUs are its ``GPU`` resource; an actor that
holds ``GPU: n`` sees ``n`` specific device ids in ``CUDA_VISIBLE_DEVICES``.
Entry points that create tensors put them on the GPU unless the caller passes
``device="cpu"``. Its environment keys start ``RAY_TPU_TORCH_``.

Public API parity anchor: ``python/ray/__init__.py`` of the reference.
"""

from ray_tpu_torch._private.accelerators.gpu import (
    default_device,
    detect_num_gpus,
    device_kind,
)
from ray_tpu_torch import exceptions
from ray_tpu_torch._private.worker import (
    DynamicObjectRefGenerator,
    ObjectRef,
    ObjectRefGenerator,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    shutdown,
    wait,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle, method
from ray_tpu_torch.remote_function import RemoteFunction

__version__ = "0.1.0"


def timeline(filename=None):
    """Unified chrome trace of the runtime (reference: `ray timeline`):
    per-stage task lifecycle intervals (submit -> queued -> lease_granted ->
    args_fetched -> exec_start -> exec_end -> result_stored) merged with
    tracing spans (submit/execute/custom) and collective-op intervals on
    shared trace ids. Returns the event list; writes JSON when `filename`
    is given — load it at chrome://tracing or https://ui.perfetto.dev."""
    from ray_tpu_torch.util import state as _state

    return _state.timeline(filename)


def remote(*args, **kwargs):
    """`@ray_tpu_torch.remote` decorator for functions and classes (reference:
    `worker.py:2942` overloads). Supports bare and parameterized forms."""
    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")

    def decorator(target):
        if isinstance(target, type):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    return decorator


__all__ = [
    "DynamicObjectRefGenerator",
    "ObjectRef",
    "ObjectRefGenerator",
    "ActorClass",
    "ActorHandle",
    "RemoteFunction",
    "available_resources",
    "cancel",
    "cluster_resources",
    "exceptions",
    "get",
    "get_actor",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "method",
    "nodes",
    "put",
    "remote",
    "shutdown",
    "timeline",
    "wait",
    "__version__",
    "default_device",
    "detect_num_gpus",
    "device_kind",
]
