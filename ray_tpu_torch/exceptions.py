"""Exception types, mirroring the reference's `python/ray/exceptions.py`."""

from __future__ import annotations

from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


# Alias matching the reference's naming for drop-in familiarity.
RayError = RayTpuError


class RayTaskError(RayTpuError):
    """Raised at `get()` when the remote task raised; wraps the remote traceback
    (reference: `exceptions.py RayTaskError`, which dynamically subclasses the
    cause so `except OriginalError` works — we replicate that in as_instanceof_cause)."""

    def __init__(self, function_name: str, traceback_str: str, cause: Optional[BaseException], pid: int = 0):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        self.pid = pid
        super().__init__(
            f"Task {function_name} failed (pid={pid}):\n{traceback_str}"
        )

    def __reduce__(self):
        try:
            import pickle

            pickle.dumps(self.cause)
            cause = self.cause
        except Exception:
            cause = None
        return (RayTaskError, (self.function_name, self.traceback_str, cause, self.pid))

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that is both a RayTaskError and an instance of the
        cause's class, so user `except ValueError:` blocks catch it."""
        if self.cause is None:
            return self
        cause_cls = type(self.cause)
        if issubclass(RayTaskError, cause_cls):
            return self
        try:
            derived = type(
                "RayTaskError(" + cause_cls.__name__ + ")",
                (RayTaskError, cause_cls),
                {},
            )
            instance = derived.__new__(derived)
            RayTaskError.__init__(
                instance, self.function_name, self.traceback_str, self.cause, self.pid
            )
            return instance
        except TypeError:
            return self


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class OutOfMemoryError(WorkerCrashedError):
    """The worker was killed by the memory monitor's OOM policy (reference:
    `ray.exceptions.OutOfMemoryError` raised by the raylet's worker-killing
    path, `src/ray/raylet/worker_killing_policy.h`). Retriable: the task is
    resubmitted while retries remain."""


class RayActorError(RayTpuError):
    """The actor died before or during this method call."""


ActorDiedError = RayActorError


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unreachable (restarting)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get()` timed out."""


class ObjectStoreFullError(RayTpuError):
    """The node's shared-memory store is over its configured capacity."""


class ObjectLostError(RayTpuError):
    """An object's segment is gone and it cannot be reconstructed."""


class OwnerDiedError(ObjectLostError):
    """The process that owned an object (submitted the task / called put)
    died before the result resolved. Ownership semantics (the reference's
    distributed-futures model): the owner holds the object's record of
    truth, so its death makes unresolved results permanently unavailable —
    dependent `get()`s raise this instead of hanging, and lineage
    reconstruction refuses to re-execute a dead owner's tasks."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled before/while running."""


class RuntimeEnvSetupError(RayTpuError):
    """Failed to set up the runtime environment for a task/actor."""


class CrossLanguageError(RayTpuError):
    pass


class PendingCallsLimitExceeded(RayTpuError):
    pass
