"""Structure-aware mutation fuzzer for the wire codecs.

Untrusted network bytes flow through two decoders that must agree: the C
extension (`_native/wire_native.c`) and its pure-Python twin
(`_private/wire._PyCodec`). This harness drives BOTH with mutated frames
and asserts, per case:

  - **typed rejection**: a malformed frame raises ValueError (the
    WireDecodeError family) — never struct.error, RecursionError,
    MemoryError, a segfault, or a silent half-decoded object;
  - **reject-parity**: the twins agree on accept-vs-reject, and on the
    decoded value when both accept (a frame one side accepts and the other
    rejects is a protocol fork between mixed-toolchain nodes);
  - **bounded work**: each decode completes within a wall-clock budget
    (hang/overallocation guard — the length-validation rules bound any
    allocation by the actual frame size).

Structure-aware: seeds are valid frames built from MESSAGE_GRAMMAR-shaped
messages; a pre-pass records the offset of every type byte and length field
in each seed, so mutations can surgically corrupt a length to 0xFFFFFFFF,
swap a type byte, truncate at a structural boundary, splice frames, or
build nesting bombs — the mutations that find decoder bugs, not just
checksum noise.

Seeded and replayable: the RNG seed prints with every failure, the failing
input is persisted to `<corpus>/crashers/<sha1>.bin` (named in the raised
error), and every file already in `<corpus>/seeds/`, `<corpus>/interesting/`
and `<corpus>/crashers/` is replayed FIRST on each run — fuzzer-found cases
become permanent regressions. Newly-seen rejection signatures are persisted
to `<corpus>/interesting/` (bounded), growing the corpus across runs. The
default corpus is the checked-in `tools/fuzz_corpus/`, which is only read:
a run on it persists into the port's own `OWN_CORPUS` and replays both.

This module intentionally imports the runtime codec (it is dynamic
verification, unlike the static passes). During fuzzing the codec HOOKS are
swapped for inert ones — decoding a mutated `H` frame must not feed
attacker-shaped bytes to pickle.loads or build half-valid dataclasses; the
real-hook hardening is covered by typed checks in wire._decode_hook and
tests/test_wire_fuzz.py.

Usage::

    python -m ray_tpu_torch.devtools.verify --fuzz 12000 [--fuzz-seed N]
"""

from __future__ import annotations

import hashlib
import os
import struct
import time
from random import Random
from typing import List, Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
# The checked-in corpus beside the package (tools/fuzz_corpus/, grown by the
# JAX package's fuzzer over the same wire format): every run on the default
# corpus replays it, and none writes there.
DEFAULT_CORPUS = os.path.join(_REPO_ROOT, "tools", "fuzz_corpus")
# The port's own corpus: what a run on the default corpus persists (crashers,
# new interesting finds) lands here, and is replayed beside the shared one.
OWN_CORPUS = os.path.join(_HERE, "fuzz_corpus")


def _corpus_dirs(corpus_dir: str) -> List[str]:
    """The directories a run on `corpus_dir` replays; the last is the one it
    writes: the port's own for the shared default, else `corpus_dir`."""
    if os.path.realpath(corpus_dir) == os.path.realpath(DEFAULT_CORPUS):
        return [DEFAULT_CORPUS, OWN_CORPUS]
    return [corpus_dir]

_TYPE_BYTES = b"NTFifbsltdH"
_LEN_TYPES = b"bsltd"
_TIME_BUDGET_S = 1.0
# Global bound on <corpus>/interesting/ (existing files count toward it, so
# the corpus cannot grow without bound across runs). Must stay ABOVE the
# checked-in corpus size or growth is permanently disabled: ~330 shipped.
_MAX_INTERESTING = 512


class FuzzFailure(AssertionError):
    """A codec crash/hang/parity divergence, with the persisted input."""


# --------------------------------------------------------------------------
# Seed frames: grammar-shaped messages over simple values only (the hook
# escape is fuzzed at the byte level, not through live runtime dataclasses).
# --------------------------------------------------------------------------
def _simple_value(rng: Random, depth: int = 0):
    kinds = ["none", "bool", "int", "float", "bytes", "str"]
    if depth < 3:
        kinds += ["tuple", "list", "dict"]
    k = rng.choice(kinds)
    if k == "none":
        return None
    if k == "bool":
        return rng.random() < 0.5
    if k == "int":
        return rng.choice([0, 1, -1, 255, -256, 2**31, -(2**31), 2**63 - 1, -(2**63)])
    if k == "float":
        return rng.choice([0.0, -0.0, 1.5, -2.75, 1e300, -1e-300])
    if k == "bytes":
        return bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 48)))
    if k == "str":
        return "".join(rng.choice("abcé中 xyz_0") for _ in range(rng.randint(0, 24)))
    if k == "tuple":
        return tuple(_simple_value(rng, depth + 1) for _ in range(rng.randint(0, 4)))
    if k == "list":
        return [_simple_value(rng, depth + 1) for _ in range(rng.randint(0, 4))]
    return {
        rng.choice(["k", "kk", 7, b"b", True, None]): _simple_value(rng, depth + 1)
        for _ in range(rng.randint(0, 4))
    }


def make_seed_messages(rng: Random, grammar: Optional[dict] = None) -> List[tuple]:
    """Arity-correct simple-value messages for every grammar tag, plus a few
    deliberately gnarly shapes."""
    if grammar is None:
        from ray_tpu_torch._private.protocol import MESSAGE_GRAMMAR as grammar
    out: List[tuple] = []
    for tag in sorted(grammar):
        lo, hi = grammar[tag]["arity"]
        n = rng.randint(lo, hi)
        out.append((tag,) + tuple(_simple_value(rng) for _ in range(n - 1)))
    out.append(("batch", [("cmd", "kv", _simple_value(rng)) for _ in range(4)]))
    out.append(("done", b"\x00" * 24, True, [], {"exec_start": 1.5}))
    out.append(("transfer_chunk", 2**40, 0, 65536))
    out.append(("cmd", "x" * 200, {"deep": [[["n"] * 8] * 4] * 2}))
    return out


# --------------------------------------------------------------------------
# Structural map of an encoded frame: (offset, type_byte) for every node,
# (offset,) for every u32 length field — recorded by a non-building parser
# so mutations hit real structure instead of random bytes.
# --------------------------------------------------------------------------
def frame_map(data: bytes) -> Tuple[List[int], List[int]]:
    type_offsets: List[int] = []
    len_offsets: List[int] = []

    def walk(pos: int, depth: int) -> int:
        if depth > 120 or pos >= len(data):
            raise ValueError("unmappable")
        t = data[pos:pos + 1]
        type_offsets.append(pos)
        pos += 1
        if t in (b"N", b"T", b"F"):
            return pos
        if t in (b"i", b"f"):
            return pos + 8
        if t in (b"b", b"s"):
            len_offsets.append(pos)
            (n,) = struct.unpack_from("<I", data, pos)
            return pos + 4 + n
        if t in (b"t", b"l"):
            len_offsets.append(pos)
            (n,) = struct.unpack_from("<I", data, pos)
            pos += 4
            for _ in range(n):
                pos = walk(pos, depth + 1)
            return pos
        if t == b"d":
            len_offsets.append(pos)
            (n,) = struct.unpack_from("<I", data, pos)
            pos += 4
            for _ in range(2 * n):
                pos = walk(pos, depth + 1)
            return pos
        if t == b"H":
            return walk(pos + 1, depth + 1)
        raise ValueError("unmappable")

    walk(0, 0)
    return type_offsets, len_offsets


# --------------------------------------------------------------------------
# Mutations
# --------------------------------------------------------------------------
def mutate(rng: Random, seed: bytes) -> bytes:
    try:
        type_offs, len_offs = frame_map(seed)
    except (ValueError, struct.error):
        type_offs, len_offs = [0], []
    buf = bytearray(seed)
    for _ in range(rng.randint(1, 3)):
        op = rng.randrange(8)
        if op == 0 and buf:  # truncate (structural boundary or anywhere)
            cut = rng.choice(type_offs) if rng.random() < 0.5 and type_offs \
                else rng.randrange(len(buf))
            del buf[cut:]
        elif op == 1 and buf:  # byte flips
            for _ in range(rng.randint(1, 4)):
                i = rng.randrange(len(buf))
                buf[i] ^= 1 << rng.randrange(8)
        elif op == 2 and len_offs:  # length-field corruption
            off = rng.choice(len_offs)
            if off + 4 <= len(buf):
                (n,) = struct.unpack_from("<I", bytes(buf), off)
                evil = rng.choice([0xFFFFFFFF, 0x7FFFFFFF, n + 1,
                                   max(0, n - 1), n * 1000 + 7, 0])
                struct.pack_into("<I", buf, off, evil & 0xFFFFFFFF)
        elif op == 3 and type_offs:  # type-byte swap
            off = rng.choice(type_offs)
            if off < len(buf):
                buf[off] = rng.choice(_TYPE_BYTES + b"\x00\xffZq")
        elif op == 4:  # nesting bomb
            depth = rng.choice([8, 64, 99, 100, 101, 150, 600])
            head = rng.choice([b"t", b"l"])
            buf = bytearray((head + struct.pack("<I", 1)) * depth + b"N")
        elif op == 5:  # hook frame
            buf = bytearray(b"H" + bytes([rng.randrange(256)]))
            buf += rng.choice([b"N", b"i" + b"\x01" * 8,
                               b"b" + struct.pack("<I", 4) + b"abcd",
                               b"t" + struct.pack("<I", 2) + b"NT"])
        elif op == 6 and buf:  # splice/duplicate a chunk
            i = rng.randrange(len(buf))
            j = rng.randrange(i, min(len(buf), i + 32) + 1)
            buf[i:i] = buf[i:j]
        else:  # append garbage
            buf += bytes(rng.getrandbits(8) for _ in range(rng.randint(1, 8)))
    return bytes(buf)


# --------------------------------------------------------------------------
# Oracle
# --------------------------------------------------------------------------
def _norm(x):
    """Comparable normal form (repr handles nan, preserves dict order)."""
    return repr(x)


def _run_one(codec, data: bytes):
    """(outcome, detail): outcome 'ok'|'reject'; raises FuzzFailure on an
    untyped exception or a blown time budget."""
    t0 = time.monotonic()
    try:
        val = codec.unpack(data)
        outcome = ("ok", _norm(val))
    except ValueError as e:
        outcome = ("reject", f"{type(e).__name__}: {str(e)[:80]}")
    except Exception as e:  # noqa: BLE001 — the whole point of the harness
        raise FuzzFailure(
            f"untyped decode exception {type(e).__name__}: {e!r}"
        ) from e
    dt = time.monotonic() - t0
    if dt > _TIME_BUDGET_S:
        raise FuzzFailure(f"decode took {dt:.2f}s (budget {_TIME_BUDGET_S}s)")
    return outcome


class _InertHooks:
    """Hook pair for fuzzing: structural, deterministic, never unpickles."""

    @staticmethod
    def encode(obj):
        return None  # decline everything: seeds are simple values

    @staticmethod
    def decode(tag, payload):
        return ("__hook__", tag, payload)


class FuzzStats:
    def __init__(self) -> None:
        self.cases = 0        # total inputs checked (replay + seeds + mutations)
        self.replayed = 0     # corpus-replay inputs
        self.mutated = 0      # fresh mutation cases (the `rounds` budget)
        self.accepted = 0
        self.rejected = 0
        self.signatures: set = set()
        self.new_interesting = 0


def _persist(corpus_dir: str, sub: str, data: bytes, note: str = "") -> str:
    d = os.path.join(_corpus_dirs(corpus_dir)[-1], sub)
    os.makedirs(d, exist_ok=True)
    name = hashlib.sha1(data).hexdigest()[:16]
    path = os.path.join(d, f"{name}.bin")
    if not os.path.exists(path):
        with open(path, "wb") as fh:
            fh.write(data)
        if note:
            with open(os.path.join(d, f"{name}.txt"), "w", encoding="utf-8") as fh:
                fh.write(note + "\n")
    return path


def _corpus_files(corpus_dir: str) -> List[str]:
    out: List[str] = []
    for root in _corpus_dirs(corpus_dir):
        for sub in ("seeds", "interesting", "crashers"):
            d = os.path.join(root, sub)
            if os.path.isdir(d):
                out.extend(
                    os.path.join(d, f) for f in sorted(os.listdir(d))
                    if f.endswith(".bin")
                )
    return out


def run_fuzz(rounds: int = 12000, seed: int = 20260804,
             corpus_dir: str = DEFAULT_CORPUS, persist: bool = True,
             quiet: bool = False, native_module=None) -> FuzzStats:
    """Fuzz both codecs with `rounds` cases each (corpus replay first).
    Raises FuzzFailure (crasher persisted + named) on any violation.
    `native_module` substitutes the C codec (the sanitizer stage passes an
    ASan/UBSan-built extension); default is the production build."""
    from ray_tpu_torch import _native
    from ray_tpu_torch._private import wire

    native = native_module if native_module is not None \
        else _native.load_wire_module()
    codecs = [("py", wire._PyCodec)]
    if native is not None:
        codecs.append(("c", native))
    elif not quiet:
        print("fuzz: C extension unavailable — fuzzing the Python codec only")

    # Swap in inert hooks (restored on exit) so mutated H frames stay safe.
    saved_py = (wire._encode_hook, wire._decode_hook)
    wire._encode_hook = _InertHooks.encode
    wire._decode_hook = _InertHooks.decode
    if native is not None:
        native.set_hooks(_InertHooks.encode, _InertHooks.decode)
    stats = FuzzStats()
    rng = Random(seed)
    try:
        def check(data: bytes, origin: str) -> None:
            stats.cases += 1
            outcomes = {}
            for cname, codec in codecs:
                try:
                    outcomes[cname] = _run_one(codec, data)
                except FuzzFailure as e:
                    path = _persist(corpus_dir, "crashers", data,
                                    f"{origin}: [{cname}] {e}") if persist else "<unpersisted>"
                    raise FuzzFailure(
                        f"[{cname}] {e} (origin {origin}, seed {seed}, "
                        f"input persisted at {path})"
                    ) from e
            # Parity is on accept-vs-reject and on accepted VALUES; reject
            # message text may legitimately differ between the twins.
            if len(outcomes) == 2 and (
                outcomes["py"][0] != outcomes["c"][0]
                or (outcomes["py"][0] == "ok" and outcomes["py"] != outcomes["c"])
            ):
                path = _persist(corpus_dir, "crashers", data,
                                f"{origin}: parity {outcomes}") if persist else "<unpersisted>"
                raise FuzzFailure(
                    f"reject-parity divergence py={outcomes['py']} "
                    f"c={outcomes['c']} (origin {origin}, seed {seed}, "
                    f"input persisted at {path})"
                )
            first = next(iter(outcomes.values()))
            if first[0] == "ok":
                stats.accepted += 1
            else:
                stats.rejected += 1
                sig = first[1]
                if sig not in stats.signatures:
                    stats.signatures.add(sig)
                    if persist and origin.startswith("mut") and \
                            interesting_on_disk + stats.new_interesting < _MAX_INTERESTING:
                        # A new rejection signature = new decoder path hit:
                        # keep the input so future runs replay it. The cap
                        # is GLOBAL (existing files count), so the corpus
                        # cannot grow without bound across runs.
                        if _persist(corpus_dir, "interesting", data, sig):
                            stats.new_interesting += 1

        interesting_on_disk = sum(
            1 for path in _corpus_files(corpus_dir)
            if os.path.basename(os.path.dirname(path)) == "interesting"
        )

        # 1) corpus replay (seeds, prior interesting finds, prior crashers).
        for path in _corpus_files(corpus_dir):
            with open(path, "rb") as fh:
                check(fh.read(), f"corpus:{os.path.basename(path)}")
        stats.replayed = stats.cases

        # 2) seeded structure-aware mutation rounds. `rounds` budgets the
        # MUTATION cases alone — replay does not eat into it, so a growing
        # corpus can never silently erode fresh coverage.
        seeds = [wire._PyCodec.pack(m) for m in make_seed_messages(rng)]
        # Valid frames must round-trip both codecs before we mutate them.
        for i, s in enumerate(seeds):
            check(s, f"seed#{i}")
        while stats.mutated < rounds:
            check(mutate(rng, rng.choice(seeds)), f"mut#{stats.mutated}")
            stats.mutated += 1
    finally:
        wire._encode_hook, wire._decode_hook = saved_py
        if native is not None:
            native.set_hooks(*saved_py)
    if not quiet:
        per_codec = len(codecs)
        print(
            f"wire fuzz OK: {stats.cases} cases x {per_codec} codec(s) "
            f"({stats.replayed} corpus-replay + {stats.mutated} mutations), "
            f"{stats.accepted} accepted / {stats.rejected} rejected, "
            f"{len(stats.signatures)} distinct reject signatures "
            f"({stats.new_interesting} new persisted), seed {seed}"
        )
    return stats


def write_seed_corpus(corpus_dir: str = DEFAULT_CORPUS, seed: int = 1) -> int:
    """Materialize the canonical seed frames under <corpus>/seeds/ (checked
    in once; replayed at the start of every run)."""
    from ray_tpu_torch._private import wire

    rng = Random(seed)
    n = 0
    for msg in make_seed_messages(rng):
        _persist(corpus_dir, "seeds", wire._PyCodec.pack(msg))
        n += 1
    return n
