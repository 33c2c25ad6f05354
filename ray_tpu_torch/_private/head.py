"""Head server process: GCS + scheduler as a standalone daemon.

The analogue of the reference's `gcs_server` binary + head raylet
(`src/ray/gcs/gcs_server/gcs_server_main.cc`,
`python/ray/_private/services.py:1273`): drivers connect with
`ray_tpu_torch.init(address="HOST:PORT")`, node daemons join over the same port
(`node_daemon.py`), and the head machine itself is registered as the head node
so local tasks run in-process-spawned workers (unix-socket fast path).

Run as:  python -m ray_tpu_torch._private.head [--port P] [--host H] [--num-cpus N] ...
Prints one line on stdout when ready:
  RAY_TPU_TORCH_HEAD_READY {"address": ..., "session_dir": ..., "authkey_hex": ...}
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import threading
import time


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=0, help="TCP port (0 = ephemeral)")
    parser.add_argument("--host", default="127.0.0.1", help="advertise host")
    parser.add_argument(
        "--bind-host",
        default=None,
        help="interface to bind (defaults to the advertise host; use 0.0.0.0 for multi-homed heads)",
    )
    parser.add_argument("--num-cpus", type=float, default=None)
    parser.add_argument("--num-gpus", type=float, default=None)
    parser.add_argument("--resources", default="{}", help="extra JSON resource map")
    parser.add_argument("--system-config", default="{}", help="JSON Config overrides")
    parser.add_argument(
        "--persist",
        default=None,
        help="GCS persistence file: restore on boot, checkpoint periodically "
        "(KV + function table survive head restarts; reference: redis-backed "
        "GCS fault tolerance)",
    )
    parser.add_argument("--persist-interval", type=float, default=5.0)
    parser.add_argument(
        "--dashboard-port",
        type=int,
        default=None,
        help="start the REST dashboard on this port (0 = ephemeral)",
    )
    ns = parser.parse_args()

    from ray_tpu_torch._private.accelerators.gpu import (
        detect_num_gpus,
        node_topology_labels,
        visible_gpu_ids,
    )
    from ray_tpu_torch._private.config import Config, set_config
    from ray_tpu_torch._private.gcs import GCS
    from ray_tpu_torch._private.scheduler import Scheduler

    cfg = Config().apply_overrides(json.loads(ns.system_config) or None)
    set_config(cfg)

    num_cpus = ns.num_cpus if ns.num_cpus is not None else float(max(os.cpu_count() or 1, 4))
    num_gpus = ns.num_gpus if ns.num_gpus is not None else float(detect_num_gpus())
    resources = {"CPU": float(num_cpus), "memory": float(cfg.object_store_memory)}
    if num_gpus:
        resources["GPU"] = float(num_gpus)
    resources.update(json.loads(ns.resources))

    session_dir = os.path.join(
        "/dev/shm", f"ray_tpu_torch_head_{os.getpid()}_{int(time.time() * 1000)}"
    )
    os.makedirs(os.path.join(session_dir, "shm"), exist_ok=True)

    gcs = GCS()
    if ns.persist and gcs.load_from(ns.persist):
        # Every process of the previous incarnation is gone: its metrics/span
        # snapshots would sit frozen in every future /metrics exposition.
        for prefix in (b"metrics::", b"spans::"):
            for key in gcs.kv_keys(prefix):
                gcs.kv_del(key)
        # Jobs that were in flight when the previous head died have no live
        # supervisor anymore: fail them (the reference marks in-flight jobs
        # failed on GCS recovery).
        for key in gcs.kv_keys(b"job::"):
            if key.endswith(b"::status") and gcs.kv_get(key) in (b"RUNNING", b"PENDING"):
                gcs.kv_put(key, b"FAILED")
                # Leave a queryable record of WHY (reference: GcsJobManager
                # marks running jobs dead with a death cause on recovery).
                from ray_tpu_torch.job_submission.client import _message_key

                job_id = key[len(b"job::"): -len(b"::status")].decode()
                gcs.kv_put(
                    _message_key(job_id),
                    b"job was in flight when the head restarted; "
                    b"state recovered from the GCS journal",
                )
    scheduler = Scheduler(
        gcs, cfg, session_dir, tcp_port=ns.port, advertise_host=ns.host, bind_host=ns.bind_host
    )
    scheduler.start()
    labels = {"head": "1", **node_topology_labels(num_gpus)}
    # The node's device ids, as init() gives the in-process head's: what an
    # actor holding `GPU` finds in its CUDA_VISIBLE_DEVICES.
    scheduler.call("add_node", (resources, labels, visible_gpu_ids(int(num_gpus or 0)))).result()

    # Restart persisted detached actors (reference: GcsActorManager restoring
    # detached actors from Redis on GCS recovery). Creation replays, so the
    # actor comes back with fresh state under its registered name. Job
    # supervisors are NOT restored: their jobs were failed above (no one
    # would re-invoke run()), so restoring would leak an idle actor.
    from ray_tpu_torch._private import serialization as _ser

    for key, blob in list(gcs.detached_actors.items()):
        try:
            name = _ser.loads(blob).get("name") or ""
            if name.startswith("JOB_SUPERVISOR::"):
                gcs.detached_actors.pop(key, None)
                continue
            scheduler.call("restore_detached_actor", blob).result()
        except Exception:
            pass  # unrestorable record (e.g. stale format): skip, keep serving

    stop = threading.Event()

    if ns.persist:
        def _persist_loop():
            while not stop.wait(ns.persist_interval):
                try:
                    gcs.save_to(ns.persist)
                except Exception:
                    pass  # transient (incl. concurrent-mutation races); retry next tick

        threading.Thread(target=_persist_loop, daemon=True, name="gcs-persist").start()

    dashboard_port = None
    if ns.dashboard_port is not None:
        # The dashboard needs a driver context for state queries: the head
        # process self-connects as a client driver.
        import ray_tpu_torch

        os.environ["RAY_TPU_TORCH_AUTHKEY_HEX"] = scheduler.authkey.hex()
        ray_tpu_torch.init(address=f"{scheduler.tcp_address[0]}:{scheduler.tcp_address[1]}")
        from ray_tpu_torch.dashboard import start_dashboard

        dashboard_port = start_dashboard(ns.host, ns.dashboard_port).port

    def _signal(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGTERM, _signal)
    signal.signal(signal.SIGINT, _signal)

    ready = {
        "address": f"{scheduler.tcp_address[0]}:{scheduler.tcp_address[1]}",
        "session_dir": session_dir,
        "authkey_hex": scheduler.authkey.hex(),
    }
    if dashboard_port is not None:
        ready["dashboard_port"] = dashboard_port
    print("RAY_TPU_TORCH_HEAD_READY " + json.dumps(ready), flush=True)

    stop.wait()
    if ns.persist:
        try:
            gcs.save_to(ns.persist)
        except OSError:
            pass
    scheduler.stop()  # also removes the spill dir
    shutil.rmtree(session_dir, ignore_errors=True)
    sys.exit(0)


if __name__ == "__main__":
    main()
