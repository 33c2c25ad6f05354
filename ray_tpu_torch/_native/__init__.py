"""Native runtime components (C++): built on demand with g++, bound via
ctypes, with a pure-Python fallback when no toolchain exists. These are host
helpers, not accelerator kernels. The sources live here; the libraries are
built into ``ray_tpu_torch/_build/`` (not committed), each stamped with the
sha256 of its source, so an edited source rebuilds.

Current components:
 - shm_arena: process-shared object-store arena allocator (plasma's
   dlmalloc-over-shm redesigned without a store process; see shm_arena.cpp).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_SRC_DIR), "_build")
_LIB_PATH = os.path.join(BUILD_DIR, "libshm_arena.so")
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

# Stale-binary guard markers: each built .so embeds
# "<marker><sha256-of-its-source>\0" (see the #define stanzas in the C
# sources), so source<->binary drift is detectable by reading the binary —
# no dlopen needed. devtools/verify and tools/check.sh use the same scheme.
ARENA_HASH_MARKER = b"RAY_TPU_TORCH_ARENA_SRC_SHA256="
WIRE_HASH_MARKER = b"RAY_TPU_TORCH_WIRE_SRC_SHA256="


def source_sha256(path: str) -> Optional[str]:
    try:
        with open(path, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()
    except OSError:
        return None


def embedded_source_hash(lib_path: str, marker: bytes) -> Optional[str]:
    """The source hash stamped into a built .so, or None when the binary is
    missing or predates the stamp (treated as stale by callers)."""
    try:
        with open(lib_path, "rb") as fh:
            data = fh.read()
    except OSError:
        return None
    i = data.find(marker)
    if i < 0:
        return None
    i += len(marker)
    end = data.find(b"\x00", i)
    if end < 0:
        return None
    try:
        return data[i:end].decode("ascii")
    except UnicodeDecodeError:
        return None


def _binary_is_current(lib_path: str, marker: bytes, src_path: str) -> bool:
    src = source_sha256(src_path)
    return src is not None and embedded_source_hash(lib_path, marker) == src


def _build() -> bool:
    src = os.path.join(_SRC_DIR, "shm_arena.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # pid-unique tmp + atomic replace: concurrent first-use builds from many
    # worker processes each publish a COMPLETE .so (last writer wins).
    tmp = f"{_LIB_PATH}.tmp.{os.getpid()}"
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        f'-DARENA_SRC_SHA256="{source_sha256(src)}"',
        "-o", tmp, src, "-lpthread",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def load_arena_lib() -> Optional[ctypes.CDLL]:
    """The compiled arena library, building it on first use; None when no
    toolchain is available (callers fall back to per-object file segments)."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _build_lock:
        if _lib is not None:
            return _lib
        # Source hash, not mtime, decides staleness: git checkouts give
        # source and binary arbitrary mtime order, and a committed .so from
        # a drifted source must rebuild regardless of timestamps.
        if not _binary_is_current(
            _LIB_PATH, ARENA_HASH_MARKER, os.path.join(_SRC_DIR, "shm_arena.cpp")
        ):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            # A prebuilt .so from another machine can be unloadable here
            # (e.g. newer-glibc symbols). The source is authoritative:
            # rebuild once for THIS toolchain and retry before giving up.
            if not _build():
                _build_failed = True
                return None
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError:
                _build_failed = True
                return None
        lib.arena_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.arena_create.restype = ctypes.c_int
        lib.arena_attach.argtypes = [ctypes.c_char_p]
        lib.arena_attach.restype = ctypes.c_void_p
        lib.arena_detach.argtypes = [ctypes.c_void_p]
        lib.arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.arena_alloc.restype = ctypes.c_uint64
        lib.arena_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.arena_free.restype = ctypes.c_int
        for name in ("arena_used", "arena_capacity", "arena_high_water", "arena_map_size"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_uint64
        lib.arena_base.argtypes = [ctypes.c_void_p]
        lib.arena_base.restype = ctypes.c_void_p
        _lib = lib
        return _lib


class Arena:
    """Python view of one attached arena mapping."""

    def __init__(self, path: str, create_capacity: Optional[int] = None):
        lib = load_arena_lib()
        if lib is None:
            raise RuntimeError("native arena library unavailable (no g++?)")
        self._lib = lib
        self.path = path
        if create_capacity is not None and not os.path.exists(path):
            rc = lib.arena_create(path.encode(), create_capacity)
            if rc != 0:
                raise OSError(-rc, f"arena_create failed for {path}")
        self._h = lib.arena_attach(path.encode())
        if not self._h:
            raise OSError(f"arena_attach failed for {path}")
        size = lib.arena_map_size(self._h)
        base = lib.arena_base(self._h)
        # ctypes arrays report format "<B", which memoryview ops reject;
        # cast() to plain "B" makes slices read/writable like bytes.
        self._mem = (ctypes.c_ubyte * size).from_address(base)
        self._view = memoryview(self._mem).cast("B")

    def alloc(self, size: int) -> int:
        """Payload offset, or 0 when the arena is full."""
        return self._lib.arena_alloc(self._h, size)

    def free(self, offset: int) -> None:
        self._lib.arena_free(self._h, offset)

    def view(self, offset: int, length: int) -> memoryview:
        """Zero-copy view of [offset, offset+length)."""
        return self._view[offset:offset + length]

    @property
    def used(self) -> int:
        return self._lib.arena_used(self._h)

    @property
    def capacity(self) -> int:
        return self._lib.arena_capacity(self._h)

    def detach(self) -> None:
        if self._h:
            # The ctypes view must die before munmap; drop our references.
            self._view = None
            self._mem = None
            self._lib.arena_detach(self._h)
            self._h = None


def available() -> bool:
    return load_arena_lib() is not None


# --------------------------------------------------------------------------
# wire_native: the control-plane codec (a real CPython extension, not a
# ctypes lib — per-call ctypes marshalling would eat the win on sub-
# microsecond pack/unpack calls). Same on-demand build-and-atomic-replace
# flow as the arena; ray_tpu_torch/_private/wire.py falls back to its pure-Python
# codec when this returns None.
# --------------------------------------------------------------------------
_WIRE_SRC = os.path.join(_SRC_DIR, "wire_native.c")
_WIRE_LIB = os.path.join(BUILD_DIR, "wire_native.so")
_wire_mod = None
_wire_failed = False
_wire_lock = threading.Lock()


def _build_wire() -> bool:
    import sysconfig

    include = sysconfig.get_paths().get("include")
    if not include or not os.path.exists(os.path.join(include, "Python.h")):
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_WIRE_LIB}.tmp.{os.getpid()}"
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-I", include,
        f'-DWIRE_SRC_SHA256="{source_sha256(_WIRE_SRC)}"',
        "-o", tmp, _WIRE_SRC,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        return False
    os.replace(tmp, _WIRE_LIB)
    return True


def load_wire_module():
    """The wire_native extension module, building it on first use; None when
    no toolchain / headers are available (callers use the Python codec)."""
    global _wire_mod, _wire_failed
    if _wire_mod is not None:
        return _wire_mod
    if _wire_failed:
        return None
    with _wire_lock:
        if _wire_mod is not None:
            return _wire_mod
        if not _binary_is_current(_WIRE_LIB, WIRE_HASH_MARKER, _WIRE_SRC):
            if not _build_wire():
                _wire_failed = True
                return None
        def _try_load():
            import importlib.machinery
            import importlib.util

            try:
                loader = importlib.machinery.ExtensionFileLoader(
                    "ray_tpu_torch._native.wire_native", _WIRE_LIB
                )
                spec = importlib.util.spec_from_file_location(
                    "ray_tpu_torch._native.wire_native", _WIRE_LIB, loader=loader
                )
                mod = importlib.util.module_from_spec(spec)
                loader.exec_module(mod)
                return mod
            except (ImportError, OSError):
                return None

        mod = _try_load()
        if mod is None:
            # A prebuilt .so from another machine/interpreter: rebuild once
            # for THIS toolchain (source is authoritative) and retry.
            if not _build_wire():
                _wire_failed = True
                return None
            mod = _try_load()
            if mod is None:
                _wire_failed = True
                return None
        _wire_mod = mod
        return _wire_mod
