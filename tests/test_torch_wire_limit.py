"""The port's control-plane frame limit (``wire_max_frame_bytes``): a message
whose frame would exceed it fails that one call, in its sender, with
``FrameTooLargeError``; a frame that does not decode is dropped by its reader,
which goes on reading. The JAX package keeps its own behaviour (a reader that
meets such a frame dies); ROADMAP.md Queue 3 records the divergence.

The runtime case runs in a subprocess with its own time limit, so a
regression (a reader thread that dies and hangs the runtime) fails the test
instead of hanging the suite.
"""

import json
import multiprocessing
import os
import subprocess
import sys
import threading

import pytest

from ray_tpu_torch._private import serialization, wire
from ray_tpu_torch._private.batching import BatchedSender
from ray_tpu_torch.exceptions import FrameTooLargeError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 1 << 20  # 1 MiB

RUNTIME_CASE = r"""
import glob, json, os, sys
import numpy as np
import ray_tpu_torch as rt
from ray_tpu_torch.exceptions import FrameTooLargeError

out = {}
rt.init(num_cpus=2)
session_dir = rt._private.worker.global_worker.session_dir

@rt.remote
def count(x):
    return len(x)

@rt.remote
def big_list():
    return list(range(10 ** 6))

@rt.remote
class Holder:
    def big(self):
        return list(range(10 ** 6))
    def ping(self):
        return "pong"

def raised(fn):
    try:
        fn()
    except FrameTooLargeError as e:
        return type(e).__name__
    except Exception as e:
        return "other: " + repr(e)[:300]
    return None

out["small_before"] = rt.get(count.remote([1, 2, 3]), timeout=60)
out["arg"] = raised(lambda: count.remote(list(range(10 ** 6))))
out["args_together"] = raised(lambda: count.remote(*[list(range(10 ** 5))] * 3))
out["put"] = raised(lambda: rt.put(list(range(10 ** 6))))
out["return"] = raised(lambda: rt.get(big_list.remote(), timeout=60))
holder = Holder.remote()
out["actor_return"] = raised(lambda: rt.get(holder.big.remote(), timeout=60))
out["actor_after"] = rt.get(holder.ping.remote(), timeout=60)
# Large data still travels: an array's bytes go out of band.
out["array"] = rt.get(count.remote(np.zeros(10 ** 6)), timeout=60)
out["small_after"] = rt.get(count.remote([1]), timeout=60)
rt.shutdown()
out["session_dir_left"] = os.path.exists(session_dir)
print("RESULT " + json.dumps(out), flush=True)
"""


def test_oversized_frames_fail_one_call_not_the_runtime():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["RAY_TPU_TORCH_wire_max_frame_bytes"] = str(LIMIT)
    proc = subprocess.run([sys.executable, "-c", RUNTIME_CASE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = json.loads(lines[-1][len("RESULT "):])
    name = FrameTooLargeError.__name__
    # A return value fails in the task; the caller's get raises the task
    # error, which is also a FrameTooLargeError (as_instanceof_cause).
    task = f"RayTaskError({name})"
    assert out == {"small_before": 3, "arg": name, "args_together": name, "put": name,
                   "return": task, "actor_return": task, "actor_after": "pong",
                   "array": 10 ** 6, "small_after": 1, "session_dir_left": False}


@pytest.fixture
def small_limit(monkeypatch):
    """A 4 KiB frame limit in this process."""
    monkeypatch.setattr(wire, "max_frame_bytes", lambda: 4096)


def test_dumps_raises_over_the_limit_and_frames_splits_a_batch(small_limit):
    msg = ("cmd", "x" * 1500)
    assert serialization.loads(serialization.dumps(msg)) == msg
    with pytest.raises(FrameTooLargeError, match="wire_max_frame_bytes=4096"):
        serialization.dumps(("cmd", "x" * 5000))
    # A batch over the limit goes one message per frame; one message in it
    # over the limit on its own is dropped, the rest still go.
    frames = serialization.frames(("batch", [msg, ("cmd", "y" * 5000), msg, msg]))
    assert [serialization.loads(f) for f in frames] == [msg, msg, msg]
    with pytest.raises(FrameTooLargeError):
        serialization.frames(("cmd", "x" * 5000))


def test_batched_sender_never_sends_a_frame_over_the_limit(small_limit):
    sent = []
    sender = BatchedSender(sent.append, start_timer=False)
    sender.enabled, sender.max_msgs, sender.max_bytes = True, 100, 1 << 30
    msg = ("cmd", "x" * 1500)
    for _ in range(3):
        sender.buffer(msg)
    sender.buffer(("cmd", "y" * 5000))  # dropped at the flush, reported
    sender.flush()
    assert [serialization.loads(f) for f in sent] == [msg] * 3
    with pytest.raises(FrameTooLargeError):
        sender.send(("cmd", "z" * 5000))
    assert len(sent) == 3 and all(len(f) <= 4096 for f in sent)


BAD_FRAME = wire.MAGIC + b"\xff\x00\x01"  # an unknown type byte


def test_bad_frame_does_not_decode():
    with pytest.raises(wire.WireDecodeError):
        serialization.loads(BAD_FRAME)


def test_worker_reader_drops_an_undecodable_frame_and_goes_on():
    from ray_tpu_torch._private.worker_main import WorkerConnection

    ours, theirs = multiprocessing.Pipe()
    wc = WorkerConnection(ours)
    seen = []
    wc.misc_handler = seen.append
    reader = threading.Thread(target=wc.reader_loop, daemon=True)
    reader.start()
    theirs.send_bytes(BAD_FRAME)
    theirs.send_bytes(serialization.dumps(("note", 1)))
    theirs.send_bytes(serialization.dumps(("shutdown",)))
    reader.join(timeout=30)
    assert not reader.is_alive() and seen == [("note", 1)]
    ours.close()
    theirs.close()


def test_scheduler_drops_an_undecodable_frame(capsys):
    from ray_tpu_torch._private import scheduler

    assert scheduler._decode(BAD_FRAME, "scheduler <- worker") is None
    assert scheduler._decode(serialization.dumps(("done", 1)), "x") == ("done", 1)
    assert "scheduler <- worker: frame dropped: WireDecodeError" in capsys.readouterr().err
