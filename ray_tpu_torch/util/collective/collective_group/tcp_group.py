"""TCP collective group: host-data collectives over sockets, the port's
analogue of the reference's pygloo-backed `GlooGroup`
(`python/ray/util/collective/collective_group/gloo_collective_group.py`).

Topology, two planes:
 - CONTROL (star): rank 0 runs a coordinator server; every rank keeps one
   persistent connection to it. Small collectives (barrier, broadcast,
   rendezvous metadata, sub-threshold allreduce) and p2p mailboxes ride it —
   one round trip, lowest latency.
 - BULK (ring): ranks additionally form a neighbor ring (rank r -> r+1) and
   large allreduces run the classic chunked ring algorithm (reduce-scatter
   then allgather, gloo's `allreduce_ring_chunked`): per step each rank
   streams 1/N of the buffer to its neighbor while receiving another 1/N,
   so per-link traffic is 2(N-1)/N x B regardless of N — bus bandwidth stays
   flat-to-rising with message size instead of collapsing through rank 0.

Rendezvous mirrors the reference's named-actor `NCCLUniqueIDStore`
(`nccl_collective_group.py:28-60`) but uses the GCS KV (SURVEY.md §5: "rendezvous
via the GCS KV instead of a named actor").
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.util.collective.collective_group.base_group import BaseGroup
from ray_tpu_torch.util.collective.rendezvous import clear, publish, wait_for
from ray_tpu_torch.util.collective.types import ReduceOp

_LEN = struct.Struct("!Q")


def _send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=5)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("collective peer closed connection")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n))


def _reduce(arrays: List[np.ndarray], op: ReduceOp) -> np.ndarray:
    stack = np.stack(arrays)
    if op == ReduceOp.SUM:
        return stack.sum(axis=0)
    if op == ReduceOp.PRODUCT:
        return stack.prod(axis=0)
    if op == ReduceOp.MIN:
        return stack.min(axis=0)
    if op == ReduceOp.MAX:
        return stack.max(axis=0)
    if op == ReduceOp.MEAN:
        return stack.mean(axis=0)
    raise ValueError(f"unsupported reduce op {op}")


class _Coordinator:
    """Rank-0 server: collects per-sequence contributions and answers."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.server.bind(("127.0.0.1", 0))
        self.server.listen(world_size + 1)
        self.port = self.server.getsockname()[1]
        self._conns: Dict[int, socket.socket] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # seq -> {rank: payload}
        self._contribs: Dict[Tuple[str, int], Dict[int, Any]] = {}
        # p2p mailbox keyed (src, dst, seq): per-pair FIFO, no cross-sender
        # overwrites.
        self._mail: Dict[Tuple[int, int, int], Any] = {}
        self._stopped = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while not self._stopped:
            try:
                conn, _ = self.server.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            hello = _recv_msg(conn)
            rank = hello["rank"]
            with self._cv:
                self._conns[rank] = conn
                self._cv.notify_all()
            while True:
                msg = _recv_msg(conn)
                self._handle(rank, conn, msg)
        except (ConnectionError, EOFError, OSError):
            pass

    def _handle(self, rank: int, conn: socket.socket, msg: Dict[str, Any]):
        kind = msg["kind"]
        if kind in ("allreduce", "reduce", "broadcast", "allgather", "reducescatter", "barrier"):
            key = (kind, msg["seq"])
            # Stamp arrival so _complete can hand every rank its offset from
            # the gang's last arriver (straggler attribution upstream).
            msg["_arrived"] = time.perf_counter()
            with self._cv:
                self._contribs.setdefault(key, {})[rank] = msg
                if len(self._contribs[key]) == self.world_size:
                    self._complete(key)
        elif kind == "send":
            with self._cv:
                self._mail[(rank, msg["dst"], msg["seq"])] = msg["data"]
                self._cv.notify_all()
        elif kind == "recv":
            key = (msg["src"], rank, msg["seq"])
            with self._cv:
                while key not in self._mail and not self._stopped:
                    self._cv.wait(timeout=1.0)
                data = self._mail.pop(key, None)
            _send_msg(conn, {"data": data})

    def _complete(self, key: Tuple[str, int]):
        """Called with lock held once all contributions for `key` arrived."""
        kind, _seq = key
        contribs = self._contribs.pop(key)
        op = contribs[0].get("op", ReduceOp.SUM)
        if kind == "barrier":
            replies = {r: None for r in contribs}
        elif kind == "allreduce":
            out = _reduce([contribs[r]["data"] for r in sorted(contribs)], op)
            replies = {r: out for r in contribs}
        elif kind == "reduce":
            root = contribs[0]["root"]
            out = _reduce([contribs[r]["data"] for r in sorted(contribs)], op)
            replies = {r: (out if r == root else None) for r in contribs}
        elif kind == "broadcast":
            root = contribs[0]["root"]
            out = contribs[root]["data"]
            replies = {r: out for r in contribs}
        elif kind == "allgather":
            gathered = [contribs[r]["data"] for r in sorted(contribs)]
            replies = {r: gathered for r in contribs}
        elif kind == "reducescatter":
            out = _reduce([contribs[r]["data"] for r in sorted(contribs)], op)
            shards = np.array_split(out, self.world_size, axis=0)
            replies = {r: shards[r] for r in contribs}
        else:
            replies = {r: None for r in contribs}
        # Arrival offsets: seconds each rank beat the last arriver to this
        # rendezvous. The straggler's offset is ~0; fast ranks accumulate the
        # time they spent waiting on it. Piggybacked on the reply — no extra
        # round trip, no extra message.
        last = max(contribs[r].get("_arrived", 0.0) for r in contribs)
        for r, reply in replies.items():
            off = last - contribs[r].get("_arrived", last)
            try:
                _send_msg(self._conns[r], {"data": reply, "off": off})
            except (KeyError, OSError):
                pass

    def stop(self):
        self._stopped = True
        try:
            self.server.close()
        except OSError:
            pass


# Below this, the one-round-trip star is faster than ring setup/steps.
_RING_THRESHOLD_BYTES = 64 * 1024
# Per-transfer slice of each ring step (bounds peak buffering; large enough
# that syscall overhead amortizes).
_RING_PIECE_BYTES = 4 * 1024 * 1024


def _combine(acc: np.ndarray, other: np.ndarray, op: ReduceOp) -> None:
    if op in (ReduceOp.SUM, ReduceOp.MEAN):
        acc += other
    elif op == ReduceOp.PRODUCT:
        acc *= other
    elif op == ReduceOp.MIN:
        np.minimum(acc, other, out=acc)
    elif op == ReduceOp.MAX:
        np.maximum(acc, other, out=acc)
    else:
        raise ValueError(f"unsupported reduce op {op}")


class TCPGroup(BaseGroup):
    def __init__(self, world_size: int, rank: int, group_name: str, kv):
        super().__init__(world_size, rank, group_name)
        self._kv = kv
        self._seq = 0
        self._coord: Optional[_Coordinator] = None
        key = f"collective/{group_name}/coordinator".encode()
        if rank == 0:
            self._coord = _Coordinator(world_size)
            publish(kv, key, f"127.0.0.1:{self._coord.port}".encode())
            addr = ("127.0.0.1", self._coord.port)
        else:
            host, port = wait_for(kv, key).decode().split(":")
            addr = (host, int(port))
        self._sock = socket.create_connection(addr, timeout=60)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _send_msg(self._sock, {"rank": rank})
        self._sock_lock = threading.Lock()
        # Per-peer FIFO sequence counters for p2p.
        self._send_seqs: Dict[int, int] = {}
        self._recv_seqs: Dict[int, int] = {}
        # Bulk ring links (lazy: built on the first large allreduce).
        self._ring_next: Optional[socket.socket] = None
        self._ring_prev: Optional[socket.socket] = None
        self._ring_lock = threading.Lock()
        self._ring_uds_path: Optional[str] = None

    def _round_trip(self, msg: Dict[str, Any]) -> Any:
        with self._sock_lock:
            _send_msg(self._sock, msg)
            reply = _recv_msg(self._sock)
        off = reply.get("off")
        if off is not None and off > 0.0:
            from ray_tpu_torch.util.collective import collective as _collective

            _collective._note_arrival_offset(off)
        return reply["data"]

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # ----------------------------------------------------------------- ring
    @staticmethod
    def _host_id() -> str:
        """Identity shared by processes on one host (boot id + hostname):
        same-host neighbors upgrade their ring link from TCP loopback to a
        Unix-domain socket (~40% more loopback throughput — no TCP stack)."""
        try:
            with open("/proc/sys/kernel/random/boot_id") as fh:
                boot = fh.read().strip()
        except OSError:
            boot = "noboot"
        return f"{boot}/{socket.gethostname()}"

    def _ensure_ring(self):
        """Build the neighbor ring: every rank listens (TCP + a same-host UDS
        endpoint), publishes its addresses, connects to rank+1 over UDS when
        co-hosted else TCP, and accepts from rank-1."""
        if self._ring_next is not None or self.world_size == 1:
            return
        with self._ring_lock:
            if self._ring_next is not None:
                return
            import os
            import tempfile

            server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            server.bind(("127.0.0.1", 0))
            server.listen(2)
            uds_path = os.path.join(
                tempfile.gettempdir(),
                f"rtring_{os.getpid()}_{self.group_name[:24]}_{self.rank}.sock",
            )
            try:
                os.unlink(uds_path)
            except OSError:
                pass
            uds_server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            uds_server.bind(uds_path)
            uds_server.listen(2)
            self._ring_uds_path = uds_path
            host_id = self._host_id()
            key = f"collective/{self.group_name}/ring/{self.rank}".encode()
            record = f"{host_id}|127.0.0.1:{server.getsockname()[1]}|{uds_path}"
            publish(self._kv, key, record.encode())
            nxt = (self.rank + 1) % self.world_size
            nkey = f"collective/{self.group_name}/ring/{nxt}".encode()
            n_host_id, n_tcp, n_uds = wait_for(self._kv, nkey).decode().split("|")
            # Connect-to-next and accept-from-prev in parallel (both block).
            # The prev neighbor picks TCP or UDS; accept on both, first wins.
            out: Dict[str, Any] = {}
            accept_done = threading.Event()

            def _accept(srv, is_tcp):
                try:
                    conn, _ = srv.accept()
                except OSError:
                    return
                if accept_done.is_set():
                    conn.close()
                    return
                if is_tcp:
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # Publish the connection BEFORE signalling: the waiter checks
                # out["prev"] as soon as the event fires.
                out["prev"] = conn
                accept_done.set()

            threads = [
                threading.Thread(target=_accept, args=(server, True), daemon=True),
                threading.Thread(target=_accept, args=(uds_server, False), daemon=True),
            ]
            for t in threads:
                t.start()
            nxt_sock = None
            if n_host_id == host_id:
                # Same host id is necessary but not sufficient for UDS (two
                # containers can share boot_id+hostname without sharing /tmp):
                # try briefly, then fall back to the published TCP address.
                uds = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                deadline = time.time() + 10
                while nxt_sock is None and time.time() < deadline:
                    try:
                        uds.connect(n_uds)
                        nxt_sock = uds
                    except OSError:
                        time.sleep(0.05)
                if nxt_sock is None:
                    uds.close()
            if nxt_sock is None:
                thost, tport = n_tcp.split(":")
                nxt_sock = socket.create_connection((thost, int(tport)), timeout=60)
                nxt_sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if accept_done.wait(timeout=60):
                # Wake whichever listener is still blocked in accept()
                # (closing a listening socket does NOT unblock accept on
                # Linux): a throwaway self-connection makes the loser see
                # accept_done and exit instead of leaking a blocked thread +
                # pinned socket per ring build. Only after success — before
                # accept_done is set a waker would be mistaken for the real
                # neighbor.
                for fam, addr in (
                    (socket.AF_INET, server.getsockname()),
                    (socket.AF_UNIX, uds_path),
                ):
                    try:
                        w = socket.socket(fam, socket.SOCK_STREAM)
                        w.settimeout(1)
                        w.connect(addr)
                        w.close()
                    except OSError:
                        pass
                for t in threads:
                    t.join(timeout=5)
            server.close()
            uds_server.close()
            if "prev" not in out:
                raise ConnectionError("ring neighbor never connected")
            self._ring_prev = out["prev"]
            self._ring_next = nxt_sock
            # Deep buffers let a whole ring piece queue per syscall instead of
            # draining through the ~208KB default in many scheduler wakeups —
            # that context-switch churn is the cost that matters when many
            # ranks share few cores.
            for s in (self._ring_prev, self._ring_next):
                for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
                    try:
                        s.setsockopt(socket.SOL_SOCKET, opt, _RING_PIECE_BYTES)
                    except OSError:
                        pass

    def _ring_exchange(self, send_view: memoryview, recv_buf: memoryview):
        """One ring step: stream send_view to next while filling recv_buf from
        prev, in bounded pieces so neither side waits for the whole chunk."""
        send_err: List[BaseException] = []

        def _sender():
            try:
                for off in range(0, len(send_view), _RING_PIECE_BYTES):
                    self._ring_next.sendall(send_view[off:off + _RING_PIECE_BYTES])
            except BaseException as e:  # noqa: BLE001
                send_err.append(e)

        t = threading.Thread(target=_sender, daemon=True)
        t.start()
        got = 0
        while got < len(recv_buf):
            n = self._ring_prev.recv_into(recv_buf[got:], len(recv_buf) - got)
            if n == 0:
                raise ConnectionError("ring peer closed connection")
            got += n
        t.join()
        if send_err:
            raise send_err[0]

    def _ring_allreduce(self, arr: np.ndarray, op: ReduceOp) -> np.ndarray:
        """Chunked ring allreduce: N-1 reduce-scatter steps then N-1 allgather
        steps; each step moves 1/N of the buffer per link."""
        self._ensure_ring()
        n, r = self.world_size, self.rank
        flat = np.ascontiguousarray(arr).reshape(-1).copy()
        # Chunk boundaries (last chunks may be smaller).
        counts = [len(flat) // n + (1 if i < len(flat) % n else 0) for i in range(n)]
        offsets = [0]
        for c in counts[:-1]:
            offsets.append(offsets[-1] + c)

        def chunk(i):
            i %= n
            return flat[offsets[i]:offsets[i] + counts[i]]

        scratch = np.empty(max(counts), dtype=flat.dtype)
        # Phase 1: reduce-scatter. After step s, chunk (r-s-1) holds the
        # running combination of s+2 ranks' contributions.
        for s in range(n - 1):
            send_c = chunk(r - s)
            recv_c = chunk(r - s - 1)
            recv_view = scratch[:len(recv_c)]
            self._ring_exchange(memoryview(send_c).cast("B"), memoryview(recv_view).cast("B"))
            _combine(recv_c, recv_view, op)
        # Phase 2: allgather the fully reduced chunks around the ring.
        for s in range(n - 1):
            send_c = chunk(r + 1 - s)
            recv_c = chunk(r - s)
            self._ring_exchange(memoryview(send_c).cast("B"), memoryview(recv_c).cast("B"))
        if op == ReduceOp.MEAN:
            flat /= n
        return flat.reshape(arr.shape)

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        arr = np.asarray(tensor)
        if (
            self.world_size > 1
            and arr.nbytes >= _RING_THRESHOLD_BYTES
            and op in (ReduceOp.SUM, ReduceOp.MEAN, ReduceOp.PRODUCT, ReduceOp.MIN, ReduceOp.MAX)
        ):
            return self._ring_allreduce(arr, op)
        return self._round_trip(
            {"kind": "allreduce", "seq": self._next_seq(), "data": arr, "op": op}
        )

    def barrier(self):
        self._round_trip({"kind": "barrier", "seq": self._next_seq()})

    def reduce(self, tensor, root_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        arr = np.asarray(tensor)
        return self._round_trip(
            {"kind": "reduce", "seq": self._next_seq(), "data": arr, "op": op, "root": root_rank}
        )

    def broadcast(self, tensor, root_rank: int = 0):
        arr = np.asarray(tensor) if tensor is not None else None
        return self._round_trip(
            {"kind": "broadcast", "seq": self._next_seq(), "data": arr, "root": root_rank}
        )

    def allgather(self, tensor):
        arr = np.asarray(tensor)
        return self._round_trip(
            {"kind": "allgather", "seq": self._next_seq(), "data": arr}
        )

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        arr = np.asarray(tensor)
        return self._round_trip(
            {"kind": "reducescatter", "seq": self._next_seq(), "data": arr, "op": op}
        )

    def send(self, tensor, dst_rank: int):
        arr = np.asarray(tensor)
        seq = self._send_seqs.get(dst_rank, 0)
        self._send_seqs[dst_rank] = seq + 1
        with self._sock_lock:
            _send_msg(
                self._sock,
                {"kind": "send", "seq": seq, "dst": dst_rank, "data": arr},
            )

    def recv(self, shape, dtype, src_rank: int):
        seq = self._recv_seqs.get(src_rank, 0)
        self._recv_seqs[src_rank] = seq + 1
        return self._round_trip({"kind": "recv", "seq": seq, "src": src_rank})

    def destroy(self):
        for s in (self._sock, self._ring_next, self._ring_prev):
            try:
                if s is not None:
                    s.close()
            except OSError:
                pass
        if self._ring_uds_path is not None:
            import os

            try:
                os.unlink(self._ring_uds_path)
            except OSError:
                pass
        try:
            clear(self._kv, f"collective/{self.group_name}/ring/{self.rank}".encode())
        except Exception:
            pass
        if self._coord is not None:
            self._coord.stop()
            clear(self._kv, f"collective/{self.group_name}/coordinator".encode())
