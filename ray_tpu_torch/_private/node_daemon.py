"""Per-node daemon: the raylet analogue for daemon-managed nodes.

The reference runs a C++ `raylet` per node (`src/ray/raylet/
main.cc:78`) that leases workers to the cluster scheduler and hosts the local
plasma store. This daemon keeps that seam with a much smaller surface:

 - registers its node (resources, labels, shm dir) with the head over TCP;
 - spawns worker processes on ("spawn_worker", ...) commands — workers dial the
   head directly, the daemon only manages their OS processes;
 - reports worker exits so the head can retry tasks / restart actors;
 - serves ("read_object", token, path) segment reads so objects sealed on this
   node can be pulled by readers elsewhere (the data-plane seam of the
   reference's `object_manager.cc` push/pull).

Run as: python -m ray_tpu_torch._private.node_daemon --address HOST:PORT --shm-dir D \
            --resources '{"CPU": 4}' [--labels '{...}'] [--log-dir D]
Auth rides RAY_TPU_TORCH_AUTHKEY_HEX, like workers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict

from ray_tpu_torch._private import failpoints, serialization, session_monitor


class NodeDaemon:
    def __init__(self, head_host: str, head_port: int, shm_dir: str,
                 resources: Dict[str, float], labels: Dict[str, str], log_dir: str):
        self.head_host = head_host
        self.head_port = head_port
        self.shm_dir = shm_dir
        self.resources = resources
        self.labels = labels
        self.log_dir = log_dir
        self.procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.conn = None
        self.node_id_hex = ""
        self._data_listener = None
        self._data_address = None
        # Worker exits whose report failed (head down mid-reconnect): resent
        # after rejoin so the head never believes a dead worker alive.
        self._unreported_exits: list = []

    def _local_host(self) -> str:
        """The address peers can reach this daemon at: the interface used to
        talk to the head."""
        import socket

        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect((self.head_host, self.head_port or 1))
            return s.getsockname()[0]
        except OSError:
            return "127.0.0.1"
        finally:
            s.close()

    def _start_data_server(self):
        """Peer-direct data plane: a PushManager (object_transfer.py) serving
        chunked transfer_begin/transfer_chunk streams straight to readers on
        other nodes, so object pulls skip the head relay (reference: the
        push side of `object_manager.cc`). Framed-pickle protocol with the
        cluster authkey, like every other connection. WITHOUT an authkey the
        server does not start (an open listener would be an arbitrary-read
        endpoint); pulls then ride the authenticated relay. A disabled
        enable_peer_transfer likewise advertises no address."""
        from ray_tpu_torch._private.config import get_config
        from ray_tpu_torch._private.object_transfer import PushManager

        if not get_config().enable_peer_transfer:
            return None
        self._push_manager = PushManager(self.shm_dir)
        addr = self._push_manager.start_listener(self._local_host())
        self._data_listener = self._push_manager
        return addr

    def connect(self):
        from multiprocessing.connection import Client

        authkey = bytes.fromhex(os.environ.get("RAY_TPU_TORCH_AUTHKEY_HEX", ""))
        # Reconnects reuse the live data server (its address is stable; a
        # second listener per rejoin would leak sockets + threads).
        if self._data_listener is not None:
            data_address = self._data_address
        else:
            data_address = self._start_data_server()
        self._data_address = data_address
        self.conn = Client((self.head_host, self.head_port), authkey=authkey)
        from ray_tpu_torch._private.object_transfer import set_nodelay

        set_nodelay(self.conn)
        self.conn.send_bytes(
            serialization.dumps(
                (
                    "daemon",
                    {
                        "resources": self.resources,
                        "labels": self.labels,
                        "shm_dir": self.shm_dir,
                        "data_address": data_address,
                        # The head prunes this process's metrics::/spans:: KV
                        # snapshots (and its stored series) when the node dies.
                        "pid": os.getpid(),
                    },
                )
            )
        )
        reply = serialization.loads(self.conn.recv_bytes())
        if reply[0] != "ok":
            raise RuntimeError(f"head rejected daemon registration: {reply!r}")
        self.node_id_hex = reply[1]
        # Monitor settings pushed by the head (its config governs — this
        # process never saw the driver's _system_config).
        monitor = reply[2] if len(reply) > 2 else {}
        self.memory_usage_threshold = float(
            monitor.get("memory_usage_threshold", 0.95)
        )
        self.memory_monitor_refresh_ms = int(
            monitor.get("memory_monitor_refresh_ms", 500)
        )
        self.health_check_period_ms = int(
            monitor.get("health_check_period_ms", 1000)
        )

    def _send(self, msg) -> bool:
        with self._lock:
            try:
                self.conn.send_bytes(serialization.dumps(msg))
                return True
            except (OSError, ValueError, BrokenPipeError):
                return False

    # ------------------------------------------------------------------ commands
    def _spawn_worker(self, info: dict):
        worker_id_hex = info["worker_id_hex"]
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        os.makedirs(self.log_dir, exist_ok=True)
        out = open(os.path.join(self.log_dir, f"worker-{worker_id_hex[:8]}.log"), "wb")
        cmd = [
            sys.executable, "-m", "ray_tpu_torch._private.worker_entry",
            "--address", f"tcp://{self.head_host}:{self.head_port}",
            "--args", info["args_blob"],
        ]
        if info.get("container_env"):
            from ray_tpu_torch._private.runtime_env import wrap_worker_command

            cmd = wrap_worker_command(
                info["container_env"], cmd, env, [self.shm_dir, repo_root]
            )
        try:
            popen = subprocess.Popen(
                cmd,
                env=env,
                stdout=out,
                stderr=subprocess.STDOUT,
                cwd=repo_root,
            )
        except OSError as e:
            self._send(("spawn_failed", worker_id_hex, repr(e)))
            return
        finally:
            out.close()
        with self._lock:
            self.procs[worker_id_hex] = popen

    def _delete_object(self, path: str, arena_offset):
        if arena_offset is not None:
            from ray_tpu_torch._private.object_store import get_node_arena

            arena = get_node_arena(os.path.dirname(path))
            if arena is not None:
                arena.free(arena_offset)
            return
        try:
            os.unlink(path)
        except OSError:
            pass

    def _kill_worker(self, worker_id_hex: str):
        with self._lock:
            popen = self.procs.pop(worker_id_hex, None)
        if popen is not None:
            try:
                popen.kill()
            except ProcessLookupError:
                pass

    def _dump_worker_oob(self, token: int, worker_id_hex: str):
        """Out-of-band stack capture for a worker that did not answer an
        in-band dump_stacks: SIGUSR1 triggers the worker's registered
        faulthandler dump (async-signal-safe C — works even with the GIL
        wedged), then the dump file tails back as stacks_data. Off-thread:
        the settle wait must not block spawn/kill commands."""
        from ray_tpu_torch._private import introspection

        with self._lock:
            popen = self.procs.get(worker_id_hex)
        path = introspection.stack_file_path(self.shm_dir, worker_id_hex)

        def _dump():
            if popen is None:
                payload = {
                    "transport": "unavailable",
                    "error": "worker process is not managed by this daemon "
                             "(already reaped?)",
                }
            else:
                payload = introspection.oob_dump_worker(popen.pid, path)
            payload["worker_id"] = worker_id_hex
            self._send(("stacks_data", token, payload))

        threading.Thread(target=_dump, daemon=True, name="oob-dump").start()

    def _read_object(self, token: int, path: str, offset=None, length=None):
        # Off-thread: a large segment read must not block spawn/kill commands.
        # Arena objects read [offset, offset+length) of the arena file.
        from ray_tpu_torch._private.object_store import read_segment

        def _read():
            try:
                self._send(("object_data", token, True, read_segment(path, offset, length)))
            except OSError as e:
                self._send(("object_data", token, False, repr(e)))

        threading.Thread(target=_read, daemon=True, name="read-object").start()

    # ------------------------------------------------------------------ loops
    def _reaper_loop(self):
        """Report dead worker processes to the head (the raylet's worker-death
        notification path), and this host's memory pressure (the memory
        monitor's per-node sampling — the kill DECISION runs in the head's
        scheduler, which knows tasks and retry budgets)."""
        last_mem = 0.0
        last_beat = 0.0
        while not self._stop.is_set():
            # Liveness heartbeat at the head-configured cadence (its config
            # governs; pushed at registration). Stops beating only when this
            # PROCESS stops — a SIGSTOP/hang stops the beats while the socket
            # stays open, which is exactly what the head's detector catches.
            hb_period = getattr(self, "health_check_period_ms", 1000)
            now_hb = time.time()
            if hb_period > 0 and now_hb - last_beat >= hb_period / 1000.0:
                last_beat = now_hb
                if not (failpoints.ENABLED
                        and failpoints.fire("daemon.heartbeat")):
                    self._send(("heartbeat",))
            dead = []
            # Tick fast enough that sub-second heartbeat periods are honored
            # (a fixed 0.2s floor would make grace settings near 2x period
            # false-kill a healthy daemon); reap cadence floor stays 0.2s.
            tick = (
                max(0.02, min(0.2, hb_period / 2000.0)) if hb_period > 0 else 0.2
            )
            with self._lock:
                for wid, popen in list(self.procs.items()):
                    if popen.poll() is not None:
                        dead.append(wid)
                        del self.procs[wid]
            for wid in dead:
                if not self._send(("worker_exit", wid)):
                    # Head unreachable (reconnect in flight): buffer — a
                    # silently dropped exit would leave the rejoined head
                    # waiting on a corpse.
                    with self._lock:
                        self._unreported_exits.append(wid)
            refresh_ms = getattr(self, "memory_monitor_refresh_ms", 500)
            now = time.time()
            if refresh_ms > 0 and now - last_mem >= max(refresh_ms, 100) / 1000.0:
                last_mem = now
                from ray_tpu_torch._private.memory_monitor import get_memory_snapshot

                snap = get_memory_snapshot()
                if snap.used_fraction >= getattr(
                    self, "memory_usage_threshold", 0.95
                ):
                    self._send(
                        ("memory_pressure", snap.used_bytes, snap.total_bytes)
                    )
            time.sleep(tick)

    def _dispatch(self, msg) -> bool:
        """Handle one head->daemon message; False means shutdown."""
        kind = msg[0]
        if session_monitor.ENABLED:
            session_monitor.check_tag("daemon.dispatch", kind)
        if kind == "batch":
            # Coalesced control frame (head-side micro-batching, e.g. a
            # delete burst): process every contained message.
            for m in msg[1]:
                if not self._dispatch(m):
                    return False
            return True
        if kind == "spawn_worker":
            self._spawn_worker(msg[1])
        elif kind == "kill_worker":
            self._kill_worker(msg[1])
        elif kind == "dump_stacks":
            from ray_tpu_torch._private import introspection

            self._send(
                (
                    "stacks_data",
                    msg[1],
                    introspection.thread_stacks(
                        extra={"role": "daemon", "node_id": self.node_id_hex}
                    ),
                )
            )
        elif kind == "dump_worker_oob":
            self._dump_worker_oob(msg[1], msg[2])
        elif kind == "profile_start":
            from ray_tpu_torch._private import profiler

            profiler.start(msg[1])
        elif kind == "profile_stop":
            from ray_tpu_torch._private import profiler

            self._send(("profile_data", msg[1], profiler.stop()))
        elif kind == "read_object":
            self._read_object(msg[1], msg[2], *msg[3:])
        elif kind == "delete_object":
            self._delete_object(msg[1], msg[2] if len(msg) > 2 else None)
        elif kind == "shutdown":
            return False
        return True

    def serve(self):
        reaper = threading.Thread(target=self._reaper_loop, daemon=True, name="reaper")
        reaper.start()
        try:
            while True:
                try:
                    msg = serialization.loads(self.conn.recv_bytes())
                except (EOFError, OSError):
                    # Head connection lost. A restarted head (--persist FT)
                    # binds the same address: REJOIN instead of tearing the
                    # node down, so head death stops costing every node its
                    # daemon (reference: raylets reconnect to a restarted
                    # GCS, `gcs_server.cc:59`). Workers of the old epoch die
                    # on their own EOF; the reaper keeps reporting them
                    # against the NEW registration, which ignores unknown
                    # ids.
                    if not self._reconnect():
                        break
                    continue
                if not self._dispatch(msg):
                    break
        finally:
            self._stop.set()
            with self._lock:
                procs = list(self.procs.values())
                self.procs.clear()
            for popen in procs:
                try:
                    popen.kill()
                except ProcessLookupError:
                    pass

    def _reconnect(self) -> bool:
        """Try to rejoin a (re)started head at the same address for up to
        RAY_TPU_TORCH_DAEMON_RECONNECT_S seconds (0 disables — the pre-FT
        tear-down behavior). Returns True once re-registered."""
        grace = float(os.environ.get("RAY_TPU_TORCH_DAEMON_RECONNECT_S", "60"))
        if grace <= 0:
            return False
        try:
            self.conn.close()
        except Exception:
            pass
        # Unified retry policy: backoff 0.2s -> 2s with deterministic jitter
        # under the grace deadline (was a fixed 1s loop). Seeded from the
        # node id so a chaos run's rejoin cadence replays.
        from ray_tpu_torch._private.retry import RetryPolicy, attempts

        policy = RetryPolicy(
            max_attempts=1_000_000, base_delay_s=0.2, max_delay_s=2.0,
            deadline_s=grace,
        )
        seed = int(self.node_id_hex[:8] or "0", 16)
        for _ in attempts(policy, seed=seed):
            if self._stop.is_set():
                return False
            try:
                self.connect()
                with self._lock:
                    backlog, self._unreported_exits = self._unreported_exits, []
                for wid in backlog:
                    self._send(("worker_exit", wid))
                print(
                    f"RAY_TPU_TORCH_NODE_REJOINED {self.node_id_hex}", flush=True
                )
                return True
            except Exception:
                # A half-open attempt (e.g. head up but registration
                # rejected) must not leak its socket per retry.
                try:
                    if self.conn is not None:
                        self.conn.close()
                except Exception:
                    pass
        return False


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--address", required=True, help="head TCP address HOST:PORT")
    parser.add_argument("--shm-dir", required=True)
    parser.add_argument("--resources", default="{}", help="JSON resource map")
    parser.add_argument("--labels", default="{}", help="JSON label map")
    parser.add_argument("--log-dir", default="")
    ns = parser.parse_args()

    host, _, port = ns.address.rpartition(":")
    labels = json.loads(ns.labels)  # no GPU topology labels yet (ROADMAP.md Queue 1 item 8)
    daemon = NodeDaemon(
        head_host=host,
        head_port=int(port),
        shm_dir=ns.shm_dir,
        resources=json.loads(ns.resources),
        labels=labels,
        log_dir=ns.log_dir or os.path.join(ns.shm_dir, "..", "logs"),
    )
    os.makedirs(ns.shm_dir, exist_ok=True)
    daemon.connect()
    print(f"RAY_TPU_TORCH_NODE_READY {daemon.node_id_hex}", flush=True)
    daemon.serve()


if __name__ == "__main__":
    main()
