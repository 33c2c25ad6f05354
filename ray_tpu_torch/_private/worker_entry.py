"""Worker process entrypoint (the analogue of the reference's
`python/ray/_private/workers/default_worker.py`): started by the scheduler (or a
node daemon), connects back to the control plane — over the session unix socket
locally, or tcp://HOST:PORT from daemon-managed nodes — then runs the task loop.
Using an explicit entrypoint instead of `multiprocessing` spawn avoids
re-executing the user's __main__ module in every worker."""

from __future__ import annotations

import argparse
import base64
import os
import pickle


def dial(address: str, authkey: bytes):
    """Connect to the control plane; address is a unix socket path or tcp://H:P."""
    from multiprocessing.connection import Client

    if address.startswith("tcp://"):
        host, _, port = address[len("tcp://"):].rpartition(":")
        conn = Client((host, int(port)), authkey=authkey)
        from ray_tpu_torch._private.object_transfer import set_nodelay

        set_nodelay(conn)
        return conn
    return Client(address, family="AF_UNIX", authkey=authkey)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--address", required=True, help="unix socket path or tcp://HOST:PORT")
    parser.add_argument("--args", required=True, help="base64(pickle(WorkerArgs))")
    ns = parser.parse_args()

    args = pickle.loads(base64.b64decode(ns.args))

    from ray_tpu_torch._private import serialization

    authkey = bytes.fromhex(os.environ.get("RAY_TPU_TORCH_AUTHKEY_HEX", ""))
    conn = dial(ns.address, authkey)
    conn.send_bytes(serialization.dumps(("worker", args.worker_id_hex)))

    from ray_tpu_torch._private.worker_main import worker_loop

    worker_loop(conn, args)


if __name__ == "__main__":
    main()
