"""Framed wire codec for control-plane messages: the native hot path.

`serialization.dumps` pays the generic C pickler for every control message.
That is the dominant per-message cost on the submit/exec/done hot tags
(MESSAGE_GRAMMAR fixed shapes): a purpose-built codec encodes the same
tuples 3-6x cheaper and decodes without pickle's machinery. This module is
the Python half of that codec:

 - the byte format is implemented twice: in C (`_native/wire_native.c`,
   built on demand like shm_arena) and in pure Python below (`_PyCodec`) —
   the no-toolchain fallback AND the parity-fuzz reference
   (tools/native_parity_fuzz.py round-trips every grammar tag through both);
 - the *hooks* flatten runtime dataclasses (TaskSpec, ObjectMeta,
   ExecRequest, submit-form TaskRecord, ids, FunctionDescriptor) into
   simple field tuples, and pickle anything genuinely arbitrary (leaf tag
   1), so an unencodable value costs an attempt, never correctness;
 - frames are prefixed with MAGIC (0xAE — not a valid first byte of a
   protocol-2+ pickle, which always starts 0x80): `serialization.loads`
   dispatches on it, so receivers accept BOTH formats regardless of the
   sender knob and mixed clusters stay correct.

Knob (Config.use_native_protocol, tri-state like use_native_object_arena):
  None  (auto)  — send wire frames iff the C extension builds/loads;
  True          — send wire frames, C if available else the Python codec
                  (parity testing / forcing the format);
  False         — send pickle only (decode still accepts wire frames).
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Optional

MAGIC = b"\xae"

# Hook tags (u8). 1 is the arbitrary-object escape; the rest are the
# fixed-shape runtime types on the hot tags.
TAG_PICKLE = 1
TAG_META = 2
TAG_SPEC = 3
TAG_EXEC = 4
TAG_RECORD = 5
TAG_OBJECT_ID = 6
TAG_TASK_ID = 7
TAG_ACTOR_ID = 8
TAG_NODE_ID = 9
TAG_WORKER_ID = 10
TAG_PG_ID = 11
TAG_FUNCDESC = 12

_MAX_DEPTH = 100

# Decode-side ceiling on one framed message; resolved from the config knob
# `wire_max_frame_bytes` on first use (refresh() re-resolves). Both codecs
# enforce the SAME limit so reject-parity holds between the twins.
_DEFAULT_MAX_FRAME = 256 * 1024 * 1024
_max_frame_bytes: Optional[int] = None


class WireDecodeError(ValueError):
    """Typed rejection of a malformed/hostile wire frame. Every decode
    failure — truncated frame, oversized length field, unknown type byte,
    hook payload of the wrong shape, even a hook exception — surfaces as
    this type via `decode()`, so readers can distinguish "bad bytes" from
    runtime bugs. Malformed bytes must never crash, hang, or overallocate
    (lengths/counts are validated against the actual remaining input before
    any allocation; see the fuzz harness in devtools/verify/fuzz_wire.py)."""


# Internal alias: raise sites predate the public name.
_WireError = WireDecodeError


def max_frame_bytes() -> int:
    global _max_frame_bytes
    if _max_frame_bytes is None:
        try:
            from ray_tpu_torch._private.config import get_config

            _max_frame_bytes = int(get_config().wire_max_frame_bytes)
        except Exception:  # noqa: BLE001 — config unavailable: safe default
            _max_frame_bytes = _DEFAULT_MAX_FRAME
        _push_native_limits()
    return _max_frame_bytes


def _push_native_limits() -> None:
    """Propagate the frame cap into the loaded C codec (no-op for _PyCodec)."""
    if _codec is not None and _codec_is_native and _max_frame_bytes is not None:
        try:
            _codec.set_limits(_max_frame_bytes)
        except Exception:  # noqa: BLE001 — older .so without set_limits
            pass


# --------------------------------------------------------------------------
# Pure-Python codec: byte-identical to wire_native.c. Used when no toolchain
# can build the extension, to DECODE frames from native peers, and as the
# parity-fuzz reference implementation.
# --------------------------------------------------------------------------
_pack_i64 = struct.Struct("<q").pack
_pack_f64 = struct.Struct("<d").pack
_pack_u32 = struct.Struct("<I").pack
_unpack_i64 = struct.Struct("<q").unpack_from
_unpack_f64 = struct.Struct("<d").unpack_from
_unpack_u32 = struct.Struct("<I").unpack_from

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


class _PyCodec:
    @staticmethod
    def pack(obj: Any) -> bytes:
        out: list = []
        _PyCodec._enc(out, obj, 0)
        return b"".join(out)

    @staticmethod
    def _enc(out: list, o: Any, depth: int) -> None:
        if depth > _MAX_DEPTH:
            raise _WireError("wire: max depth exceeded")
        if o is None:
            out.append(b"N")
            return
        if o is True:
            out.append(b"T")
            return
        if o is False:
            out.append(b"F")
            return
        t = type(o)
        if t is int:
            if _I64_MIN <= o <= _I64_MAX:
                out.append(b"i")
                out.append(_pack_i64(o))
            else:
                _PyCodec._enc_hook(out, o, depth)
            return
        if t is float:
            out.append(b"f")
            out.append(_pack_f64(o))
            return
        if t is bytes:
            out.append(b"b")
            out.append(_pack_u32(len(o)))
            out.append(o)
            return
        if t is str:
            data = o.encode("utf-8")
            out.append(b"s")
            out.append(_pack_u32(len(data)))
            out.append(data)
            return
        if t is tuple:
            out.append(b"t")
            out.append(_pack_u32(len(o)))
            for item in o:
                _PyCodec._enc(out, item, depth + 1)
            return
        if t is list:
            out.append(b"l")
            out.append(_pack_u32(len(o)))
            for item in o:
                _PyCodec._enc(out, item, depth + 1)
            return
        if t is dict:
            out.append(b"d")
            out.append(_pack_u32(len(o)))
            for k, v in o.items():
                _PyCodec._enc(out, k, depth + 1)
                _PyCodec._enc(out, v, depth + 1)
            return
        _PyCodec._enc_hook(out, o, depth)

    @staticmethod
    def _enc_hook(out: list, o: Any, depth: int) -> None:
        pair = _encode_hook(o)
        if pair is None:
            raise _WireError(f"wire: cannot encode {type(o).__name__}")
        tag, payload = pair
        out.append(b"H")
        out.append(bytes((tag,)))
        _PyCodec._enc(out, payload, depth + 1)

    @staticmethod
    def unpack(data, offset: int = 0) -> Any:
        if offset < 0 or offset > len(data):
            raise _WireError("wire: bad offset")
        if len(data) - offset > max_frame_bytes():
            raise _WireError("wire: frame exceeds wire_max_frame_bytes")
        obj, pos = _PyCodec._dec(data, offset, 0)
        if pos != len(data):
            raise _WireError("wire: trailing bytes in frame")
        return obj

    # Length/count fields are attacker-controlled: every one is validated
    # against the ACTUAL remaining bytes of the frame before any allocation
    # (a tuple/list element costs >= 1 byte, a dict pair >= 2), so a 5-byte
    # frame claiming 2^32-1 elements is rejected as truncated instead of
    # presizing a multi-GB container. Byte-identical rules in wire_native.c.
    @staticmethod
    def _dec(data, pos: int, depth: int):
        if depth > _MAX_DEPTH:
            raise _WireError("wire: max depth exceeded")
        end = len(data)
        if pos >= end:
            raise _WireError("wire: truncated frame")
        tag = data[pos:pos + 1]
        pos += 1
        if tag == b"N":
            return None, pos
        if tag == b"T":
            return True, pos
        if tag == b"F":
            return False, pos
        if tag == b"i":
            if end - pos < 8:
                raise _WireError("wire: truncated frame")
            return _unpack_i64(data, pos)[0], pos + 8
        if tag == b"f":
            if end - pos < 8:
                raise _WireError("wire: truncated frame")
            return _unpack_f64(data, pos)[0], pos + 8
        if tag == b"b":
            if end - pos < 4:
                raise _WireError("wire: truncated frame")
            n = _unpack_u32(data, pos)[0]
            pos += 4
            if n > end - pos:
                raise _WireError("wire: truncated frame")
            return bytes(data[pos:pos + n]), pos + n
        if tag == b"s":
            if end - pos < 4:
                raise _WireError("wire: truncated frame")
            n = _unpack_u32(data, pos)[0]
            pos += 4
            if n > end - pos:
                raise _WireError("wire: truncated frame")
            return bytes(data[pos:pos + n]).decode("utf-8"), pos + n
        if tag in (b"t", b"l"):
            if end - pos < 4:
                raise _WireError("wire: truncated frame")
            n = _unpack_u32(data, pos)[0]
            pos += 4
            if n > end - pos:
                raise _WireError("wire: truncated frame")
            items = []
            for _ in range(n):
                item, pos = _PyCodec._dec(data, pos, depth + 1)
                items.append(item)
            return (tuple(items) if tag == b"t" else items), pos
        if tag == b"d":
            if end - pos < 4:
                raise _WireError("wire: truncated frame")
            n = _unpack_u32(data, pos)[0]
            pos += 4
            if n > (end - pos) // 2:
                raise _WireError("wire: truncated frame")
            d = {}
            for _ in range(n):
                k, pos = _PyCodec._dec(data, pos, depth + 1)
                v, pos = _PyCodec._dec(data, pos, depth + 1)
                try:
                    d[k] = v
                except TypeError:
                    # The encoder never emits container keys, so this frame
                    # is forged/corrupt: typed rejection, not a TypeError
                    # leaking out of the decoder (fuzzer-found).
                    raise _WireError("wire: unhashable dict key in frame") from None
            return d, pos
        if tag == b"H":
            if pos >= end:
                raise _WireError("wire: truncated frame")
            htag = data[pos]
            pos += 1
            payload, pos = _PyCodec._dec(data, pos, depth + 1)
            return _decode_hook(htag, payload), pos
        raise _WireError(f"wire: unknown type byte {tag!r}")


# --------------------------------------------------------------------------
# Hooks: dataclass flattening + pickle escape. Lazy-initialized so this
# module can be imported before the runtime modules finish loading.
# --------------------------------------------------------------------------
_hooks_ready = False
_spec_fields: list = []
_meta_fields: list = []
_spec_get = None  # operator.itemgetter over __dict__: C-speed field tuples
_meta_get = None
_id_tags: dict = {}
_tag_ids: dict = {}
_TaskSpec = _ObjectMeta = _ExecRequest = _FunctionDescriptor = None
_fast_task_record = None
_TaskRecord = None


def _init_hooks() -> None:
    global _hooks_ready, _spec_fields, _meta_fields, _id_tags, _tag_ids
    global _TaskSpec, _ObjectMeta, _ExecRequest, _FunctionDescriptor
    global _fast_task_record, _TaskRecord, _spec_get, _meta_get
    if _hooks_ready:
        return
    import dataclasses
    import operator

    from ray_tpu_torch._private import ids as ids_mod
    from ray_tpu_torch._private.object_store import ObjectMeta
    from ray_tpu_torch._private.protocol import FunctionDescriptor, TaskSpec
    from ray_tpu_torch._private.scheduler import TaskRecord, fast_task_record

    from ray_tpu_torch._private.protocol import ExecRequest

    _TaskSpec = TaskSpec
    _ObjectMeta = ObjectMeta
    _FunctionDescriptor = FunctionDescriptor
    _TaskRecord = TaskRecord
    _fast_task_record = fast_task_record
    _ExecRequest = ExecRequest
    _spec_fields = [f.name for f in dataclasses.fields(TaskSpec)]
    _meta_fields = [f.name for f in dataclasses.fields(ObjectMeta)]
    _spec_get = operator.itemgetter(*_spec_fields)
    _meta_get = operator.itemgetter(*_meta_fields)
    _id_tags = {
        ids_mod.ObjectID: TAG_OBJECT_ID,
        ids_mod.TaskID: TAG_TASK_ID,
        ids_mod.ActorID: TAG_ACTOR_ID,
        ids_mod.NodeID: TAG_NODE_ID,
        ids_mod.WorkerID: TAG_WORKER_ID,
        ids_mod.PlacementGroupID: TAG_PG_ID,
    }
    _tag_ids = {tag: cls for cls, tag in _id_tags.items()}
    _hooks_ready = True


def _pickle_leaf(obj: Any) -> bytes:
    """Pickle escape with the same __main__ discipline as
    serialization.dumps: objects pickled BY REFERENCE into __main__ would
    unpickle-fail in a worker (its __main__ is not the driver script)."""
    try:
        data = pickle.dumps(obj, protocol=5)
    except Exception:
        import cloudpickle

        return cloudpickle.dumps(obj)
    if b"__main__" in data:
        import cloudpickle

        return cloudpickle.dumps(obj)
    return data


def _encode_hook(obj: Any) -> Optional[tuple]:
    if not _hooks_ready:
        _init_hooks()
    t = type(obj)
    tag = _id_tags.get(t)
    if tag is not None:
        return (tag, obj._binary)
    if t is _ObjectMeta:
        return (TAG_META, _meta_get(obj.__dict__))
    if t is _TaskSpec:
        return (TAG_SPEC, _spec_get(obj.__dict__))
    if t is _FunctionDescriptor:
        return (TAG_FUNCDESC, (obj.function_id, obj.name))
    if t is _ExecRequest:
        d = obj.__dict__
        return (TAG_EXEC, (
            obj.spec, obj.arg_metas, obj.kwarg_metas, obj.func_blob,
            obj.return_ids,
            d.get("_arg_entries"), d.get("_kwarg_entries"),
            d.get("_saved_arg_entries"), d.get("_saved_kwarg_entries"),
        ))
    if t is _TaskRecord:
        # Submit form only: the wire carries what (re)registration needs;
        # the receiving side rebuilds the rest (dispatch_key recomputes).
        return (TAG_RECORD, (
            obj.spec, obj.arg_entries, obj.kwarg_entries, obj.return_ids,
            obj.func_blob, obj.retries_left,
        ))
    return (TAG_PICKLE, _pickle_leaf(obj))


def _decode_hook(tag: int, payload: Any) -> Any:
    if not _hooks_ready:
        _init_hooks()
    if tag == TAG_PICKLE:
        if type(payload) is not bytes:
            raise _WireError("wire: pickle hook payload must be bytes")
        return pickle.loads(payload)
    cls = _tag_ids.get(tag)
    if cls is not None:
        if type(payload) is not bytes:
            raise _WireError("wire: id hook payload must be bytes")
        return cls._trusted(payload)
    # Dataclass payloads are field tuples: a malformed frame with a short or
    # non-tuple payload must raise HERE, not zip() into a half-built object
    # whose missing attributes explode far from the decode site.
    if tag == TAG_META:
        if type(payload) is not tuple or len(payload) != len(_meta_fields):
            raise _WireError("wire: bad ObjectMeta hook payload")
        meta = _ObjectMeta.__new__(_ObjectMeta)
        meta.__dict__.update(zip(_meta_fields, payload))
        return meta
    if tag == TAG_SPEC:
        if type(payload) is not tuple or len(payload) != len(_spec_fields):
            raise _WireError("wire: bad TaskSpec hook payload")
        spec = _TaskSpec.__new__(_TaskSpec)
        spec.__dict__.update(zip(_spec_fields, payload))
        return spec
    if tag == TAG_FUNCDESC:
        if type(payload) is not tuple or len(payload) != 2:
            raise _WireError("wire: bad FunctionDescriptor hook payload")
        fd = _FunctionDescriptor.__new__(_FunctionDescriptor)
        fd.function_id, fd.name = payload
        return fd
    if tag == TAG_EXEC:
        if type(payload) is not tuple or len(payload) != 9:
            raise _WireError("wire: bad ExecRequest hook payload")
        (spec, arg_metas, kwarg_metas, func_blob, return_ids,
         arg_entries, kwarg_entries, saved_args, saved_kwargs) = payload
        req = _ExecRequest.__new__(_ExecRequest)
        req.spec = spec
        req.arg_metas = arg_metas
        req.kwarg_metas = kwarg_metas
        req.func_blob = func_blob
        req.return_ids = return_ids
        if arg_entries is not None or kwarg_entries is not None:
            req._arg_entries = arg_entries
            req._kwarg_entries = kwarg_entries
        if saved_args is not None or saved_kwargs is not None:
            req._saved_arg_entries = saved_args
            req._saved_kwarg_entries = saved_kwargs
        return req
    if tag == TAG_RECORD:
        if type(payload) is not tuple or len(payload) != 6:
            raise _WireError("wire: bad TaskRecord hook payload")
        spec, arg_entries, kwarg_entries, return_ids, func_blob, retries = payload
        return _fast_task_record(
            spec, arg_entries, kwarg_entries, return_ids, func_blob, retries
        )
    raise _WireError(f"wire: unknown hook tag {tag}")


# --------------------------------------------------------------------------
# Codec resolution + the dumps/loads entry points serialization.py uses.
# --------------------------------------------------------------------------
_codec = None          # module with pack/unpack (C ext or _PyCodec)
_codec_is_native = False
_send_enabled: Optional[bool] = None  # resolved from config on first use


def _load_codec(prefer_native: bool = True):
    """Resolve the codec once per process: the C extension when it builds
    and loads, else the pure-Python implementation."""
    global _codec, _codec_is_native
    if _codec is not None:
        return _codec
    if prefer_native:
        from ray_tpu_torch import _native

        mod = _native.load_wire_module()
        if mod is not None:
            try:
                mod.set_hooks(_encode_hook, _decode_hook)
                _codec = mod
                _codec_is_native = True
                # Resolve the frame cap NOW and push it into the C static:
                # the native decode path never re-reads the config, and a
                # set_config that ran before this lazy load was a no-op push
                # (_codec was still None then).
                max_frame_bytes()
                _push_native_limits()
                return _codec
            except Exception:  # noqa: BLE001 — fall through to Python codec
                pass
    _codec = _PyCodec
    _codec_is_native = False
    return _codec


def native_available() -> bool:
    _load_codec()
    return _codec_is_native


def refresh() -> None:
    """Re-resolve the send knob and frame-size limit from the current config
    (set_config calls this; decode FORMAT acceptance is knob-independent,
    but the max-frame bound follows the config)."""
    global _send_enabled, _max_frame_bytes
    _send_enabled = None
    _max_frame_bytes = None
    if _codec is not None:
        # The C codec caches the limit in a module static: push the new
        # value now (the native decode path never re-reads the config).
        max_frame_bytes()


def send_enabled() -> bool:
    global _send_enabled
    if _send_enabled is None:
        from ray_tpu_torch._private.config import get_config

        knob = get_config().use_native_protocol
        if knob is None:
            _send_enabled = native_available()  # auto: native toolchain only
        elif knob:
            _load_codec()
            _send_enabled = True  # forced: Python codec serves without a toolchain
        else:
            _send_enabled = False
    return _send_enabled


def encode(msg: Any) -> Optional[bytes]:
    """MAGIC-prefixed wire frame, or None when the message doesn't encode
    (caller falls back to pickle — correctness never depends on the codec)."""
    codec = _codec if _codec is not None else _load_codec()
    try:
        return MAGIC + codec.pack(msg)
    except Exception:  # noqa: BLE001 — any failure means "use pickle"
        return None


def decode(data, offset: int = 1) -> Any:
    """Decode a MAGIC-prefixed frame (offset skips the magic byte).

    Every failure mode — truncated/oversized/unknown bytes from the codec,
    a hook blowing up on a malformed payload (bad pickle, wrong field
    tuple) — surfaces as WireDecodeError, so callers get ONE typed signal
    for "these bytes are not a valid frame"."""
    codec = _codec if _codec is not None else _load_codec()
    try:
        return codec.unpack(data, offset)
    except WireDecodeError:
        raise
    except Exception as e:  # noqa: BLE001 — typed-error contract
        raise WireDecodeError(f"wire: frame rejected: {type(e).__name__}: {e}") from e
