"""Serialization of task args/returns and `put` objects.

Mirrors the reference's pickle5 + out-of-band-buffer design
(`python/ray/_private/serialization.py`): values are cloudpickled with
protocol 5 and a buffer callback, so large contiguous payloads (numpy arrays, bytes)
are captured as zero-copy `PickleBuffer`s that the object store places in shared
memory; readers reconstruct arrays directly over the mmap with no copy.

Device tensors are intentionally NOT routed through shared memory: a CUDA tensor
is lowered to a CPU tensor at the boundary, when it actually crosses a process, via
the reducer below, so it arrives on the host (a pickled ``device='cuda:N'`` would
create a CUDA context in the reader, or fail in a process without that device).
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Any, Callable, List

import cloudpickle

from ray_tpu_torch._private import wire
from ray_tpu_torch.exceptions import FrameTooLargeError


@dataclass
class SerializedValue:
    """In-band pickle bytes plus out-of-band buffers."""

    inband: bytes
    buffers: List[memoryview] = field(default_factory=list)
    # ObjectRef ids pickled inside the value. The control plane pins these while
    # the containing object lives, the analogue of the reference's
    # "contained object" tracking in `reference_count.h:59`.
    contained_ids: List[bytes] = field(default_factory=list)

    @property
    def total_size(self) -> int:
        return len(self.inband) + sum(b.nbytes for b in self.buffers)


# Active only inside serialize() (per thread): ObjectRef.__reduce__ reports ids
# here so nested refs are discovered without a second pass over the value.
import threading as _threading

_tls = _threading.local()


def note_contained_ref(id_bytes: bytes) -> None:
    collector = getattr(_tls, "contained_collector", None)
    if collector is not None:
        collector.append(id_bytes)


def _tensor_from_numpy(array, dtype_name, requires_grad):
    """A CPU tensor of ``array``'s bytes (``dtype_name``: the torch dtype to
    view them as, for one numpy lacks), writable and owning its memory."""
    import torch

    t = torch.from_numpy(array if array.flags.writeable else array.copy())
    if dtype_name is not None:
        t = t.view(getattr(torch, dtype_name))
    return t.requires_grad_() if requires_grad else t


# Torch dtypes numpy has no type for, pickled as the same bytes of another.
_NUMPY_VIEW_DTYPES = {"bfloat16": "int16", "float8_e4m3fn": "int8", "float8_e5m2": "int8"}


class _Pickler(cloudpickle.CloudPickler):
    """Cloudpickler that lowers device tensors to CPU tensors and sends a
    plain tensor's data out of band.

    A CUDA tensor's memory must stay on the device that owns it; only the host
    copy crosses process boundaries. Tasks that want device tensors move them
    onto their own device. A plain tensor (``torch.Tensor`` itself, strided)
    pickles as a numpy array of its bytes, whose buffer protocol 5 carries
    out of band into the object store, as a numpy array's does: torch's own
    pickling puts the data in band, so a large tensor would ride the control
    plane's frame (two tensors sharing storage arrive as two copies).
    """

    def reducer_override(self, obj):
        # Checked by module name so the core runtime never imports torch.
        mod = type(obj).__module__ or ""
        if mod.startswith("torch"):
            import torch

            if type(obj) is torch.Tensor and obj.layout == torch.strided:
                t = obj.detach().cpu().contiguous()
                name = str(t.dtype).split(".")[-1]
                view = _NUMPY_VIEW_DTYPES.get(name)
                try:
                    array = (t.view(getattr(torch, view)) if view else t).numpy()
                except TypeError:  # no numpy counterpart (complex32, quantized, ...)
                    return t.__reduce_ex__(5)
                return _tensor_from_numpy, (array, name if view else None, obj.requires_grad)
            if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
                return obj.detach().cpu().__reduce_ex__(5)
        # Delegate to CloudPickler: its reducer_override implements by-value
        # function/class pickling (what ships closures to worker processes).
        return super().reducer_override(obj)


# Exact-type fast path: these can neither carry out-of-band buffers nor
# contain ObjectRefs, so the C pickler alone is equivalent to the full
# cloudpickle pass (bytes/str were always serialized in-band anyway) at a
# fraction of the per-call overhead — the control plane serializes millions
# of tiny task results.
_SIMPLE_TYPES = (type(None), bool, int, float, bytes, str)


def serialize(value: Any) -> SerializedValue:
    if type(value) in _SIMPLE_TYPES:
        return SerializedValue(inband=pickle.dumps(value, protocol=5))
    buffers: List[pickle.PickleBuffer] = []
    import io

    f = io.BytesIO()
    p = _Pickler(f, protocol=5, buffer_callback=buffers.append)
    prev = getattr(_tls, "contained_collector", None)
    _tls.contained_collector = contained = []
    try:
        p.dump(value)
    finally:
        _tls.contained_collector = prev
    views = []
    for b in buffers:
        view = b.raw()
        if not view.contiguous:
            view = memoryview(bytes(view))
        views.append(view)
    return SerializedValue(
        inband=f.getvalue(), buffers=views, contained_ids=list(dict.fromkeys(contained))
    )


def deserialize(inband: bytes, buffers: List[memoryview]) -> Any:
    return pickle.loads(inband, buffers=buffers)


def dumps(obj: Any) -> bytes:
    """Single-blob serialization for control-plane messages (no out-of-band).

    Control-message tuples (a str tag first — the MESSAGE_GRAMMAR shapes)
    take the framed wire codec when the native protocol is enabled
    (_private/wire.py: C extension or its pure-Python twin, knob
    `use_native_protocol`); receivers dispatch on the frame's magic byte, so
    both formats always decode. Everything else — and any message the codec
    declines — pickles: the C pickler is ~5-10x faster than cloudpickle's
    Python-driven dump, so try it first. Two cases must still take the
    cloudpickle path: objects it cannot pickle at all (lambdas, closures —
    PicklingError), and objects it pickles BY REFERENCE into `__main__` (a
    worker's __main__ is not the driver's script, so those would
    unpickle-fail remotely; the byte-scan is cheap and false positives
    merely lose the fast path). A message over ``wire_max_frame_bytes``
    raises FrameTooLargeError here, in the sender: the frame never leaves."""
    data = _dumps(obj)
    check_frame(len(data), "a control-plane message")
    return data


def _dumps(obj: Any) -> bytes:
    if type(obj) is tuple and obj and type(obj[0]) is str and wire.send_enabled():
        data = wire.encode(obj)
        if data is not None:
            return data
    try:
        data = pickle.dumps(obj, protocol=5)
    except Exception:
        return cloudpickle.dumps(obj)
    if b"__main__" in data:
        return cloudpickle.dumps(obj)
    return data


def dumps_to_host(obj: Any) -> bytes:
    """One in-band blob for a file (Tune's journal and spec, a workflow's
    DAG and step outputs): cloudpickle with the reducer above, so a device
    tensor is written as a CPU tensor, and a process without that device can
    load it with ``loads``. No frame limit applies."""
    import io

    f = io.BytesIO()
    _Pickler(f, protocol=5).dump(obj)
    return f.getvalue()


def loads(data: bytes) -> Any:
    if data[:1] == wire.MAGIC:
        return wire.decode(data)
    return pickle.loads(data)


# Room a message's own fields take in its frame beside one inline value.
FRAME_HEADROOM = 64 * 1024


def check_frame(nbytes: int, what: str, headroom: int = 0) -> None:
    """Raise FrameTooLargeError when ``nbytes`` of ``what``, plus ``headroom``
    for the message around it, cannot ride one control-plane frame
    (``wire_max_frame_bytes``)."""
    limit = wire.max_frame_bytes()
    if nbytes + headroom > limit:
        room = f" less {headroom} for the message around it" if headroom else ""
        raise FrameTooLargeError(
            f"{what} takes {nbytes} bytes, over wire_max_frame_bytes={limit}{room}; "
            "pass large data as arrays or tensors (they travel out of band) or "
            "raise the limit (RAY_TPU_TORCH_wire_max_frame_bytes)")


def frames(msg: Any) -> List[bytes]:
    """The frames that carry ``msg``: one, or, for a ("batch", msgs) frame over
    the limit, one per message. A message over the limit inside a batch is
    reported and dropped (its sender has moved on); a lone one raises
    FrameTooLargeError in the caller."""
    try:
        return [dumps(msg)]
    except FrameTooLargeError:
        if not (type(msg) is tuple and len(msg) == 2 and msg[0] == "batch"):
            raise
    out = []
    for m in msg[1]:
        try:
            out.append(dumps(m))
        except FrameTooLargeError as e:
            report_dropped_frame("send", e)
    return out


def report_dropped_frame(where: str, err: Exception) -> None:
    """One line on stderr (a worker's log) for a frame that was not sent or
    not decoded; the connection stays up."""
    import sys

    print(f"ray_tpu_torch: {where}: frame dropped: {type(err).__name__}: {err}",
          file=sys.stderr, flush=True)
