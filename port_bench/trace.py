"""Reading a ``torch.profiler`` trace of a rank's traced window.

``collect`` keeps, of the profiler's raw events, what the per-layer readers
and the breakdown need, as plain lists that travel in a report: each device
activity (kernel, copy or set) with its name, start and length, the ranges
that ``record_function`` opened on the host (the benchmark's own around its
calls into the port), and, where the host's ops were traced, the device's
idle time by the host op that was running. Times are microseconds from the
traced window's start. The raw events are read through ``kineto_results``, which skips the profiler's
own tree building.

The groups are ``chip_smoke.py``'s (``profile_steps``): the port's attention
kernels by name, cuBLAS products by "gemm", "nvjet", "cutlass" or "xmma" in
the name, NCCL by "nccl", and everything else.
"""

from __future__ import annotations

import bisect

WINDOW = "port_bench.traced_window"
# The port's CUDA kernels (ray_tpu_torch/ops/csrc/flash_attention.cu), as
# substrings of the profiler's kernel names.
ATTENTION_KERNELS = ("fwd_kernel", "flash_fwd_wgmma", "flash_bwd_wgmma", "flash_bwd_dq_convert",
                     "bwd_dkdv", "bwd_dq")
GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma")
COPY_PREFIXES = ("Memcpy", "Memset")


def group(name):
    """attention, gemm, nccl, copy or other."""
    if name.startswith(COPY_PREFIXES):
        return "copy"
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if any(k in name for k in ATTENTION_KERNELS):
        return "attention"
    if any(k in low for k in GEMM_MARKS):
        return "gemm"
    return "other"


def union(spans):
    """Merged (start, end) spans, sorted."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def length(spans):
    return sum(b - a for a, b in spans)


def overlap(ua, ub):
    """The length in which two unions (from ``union``) both run."""
    total, j = 0.0, 0
    for a, b in ua:
        while j < len(ub) and ub[j][1] <= a:
            j += 1
        k = j
        while k < len(ub) and ub[k][0] < b:
            total += max(0.0, min(b, ub[k][1]) - max(a, ub[k][0]))
            k += 1
    return total


def _raw(prof):
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    for e in res.events():
        dev = e.device_type()
        yield (e.name(), dev == DeviceType.CUDA, e.start_ns() / 1e3, e.duration_ns() / 1e3,
               e.start_thread_id(), bool(e.is_user_annotation()))


def collect(prof, steps, window_us=None):
    """The traced window of one rank, from a finished profiler. The window is
    the ``record_function(WINDOW)`` range the steps ran in; a trace of the
    device alone has none, and its window (``window_us``, timed by CUDA
    events) holds every device activity the trace saw."""
    device, host, ranges = [], [], []
    window = None
    for name, on_device, start, dur, tid, annotation in _raw(prof):
        if on_device:
            # A record_function range shows on the device's timeline too.
            if not annotation and not name.startswith("port_bench."):
                device.append((name, start, start + dur))
        elif name == WINDOW and annotation:
            window = (start, start + dur)
        elif annotation:
            ranges.append((name, start, start + dur, tid))
        else:
            host.append((start, start + dur, name))
    if window is None:
        if window_us is None or not device:
            raise RuntimeError(f"the trace holds no {WINDOW} range and no device activity")
        window = (min(a for _, a, _ in device), max(b for _, _, b in device))
    t0, t1 = window
    names, index = [], {}

    def idx(name):
        if name not in index:
            index[name] = len(names)
            names.append(name)
        return index[name]

    inside = [(n, max(a, t0), min(b, t1)) for n, a, b in device if b > t0 and a < t1]
    busy = union([(a, b) for _, a, b in inside])
    gaps, edge = [], t0
    for a, b in busy + [[t1, t1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    host.sort()
    starts = [h[0] for h in host]
    idle = {}
    for a, b in gaps if host else []:
        what = _host_op_at(host, starts, (a + b) / 2)
        idle[what] = idle.get(what, 0.0) + (b - a)
    return {
        "steps": steps, "window_us": window_us if window_us is not None else t1 - t0,
        "busy_us": length(busy), "names": names,
        "device": [(idx(n), a - t0, b - t0) for n, a, b in inside],
        "ranges": [(idx(n), a - t0, b - t0, tid) for n, a, b, tid in ranges if b > t0 and a < t1],
        "idle_us_by_host_op": sorted(idle.items(), key=lambda kv: -kv[1]),
    }


def _host_op_at(host, starts, t, look_back=4096):
    """The innermost host op (the latest to start) running at ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - look_back), -1):
        a, b, name = host[j]
        if b >= t:
            return name
    return "(no host op)"


class Trace:
    """One rank's collected trace, with the sums the readers take."""

    def __init__(self, data):
        self.data = data
        self.steps = data["steps"]
        self.names = data["names"]
        self.device = [(self.names[i], a, b) for i, a, b in data["device"]]

    @property
    def window_s(self):
        return self.data["window_us"] / 1e6

    @property
    def busy_s(self):
        return self.data["busy_us"] / 1e6

    def spans(self, pick):
        """(start, end) of the device activities whose name ``pick`` accepts."""
        return [(a, b) for n, a, b in self.device if pick(n)]

    def ms_per_step(self, pick):
        return sum(b - a for a, b in self.spans(pick)) / 1e3 / self.steps

    def count(self, pick):
        return len(self.spans(pick))

    def by_name_s(self):
        out = {}
        for n, a, b in self.device:
            out[n] = out.get(n, 0.0) + (b - a) / 1e6
        return out


def traces(ranks):
    """The ``Trace`` of each rank whose traced window holds device activity
    (none on the CPU)."""
    return [Trace(r["trace"]) for r in ranks if r.get("trace") and r["trace"]["busy_us"] > 0]


def mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None
