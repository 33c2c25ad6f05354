"""The device time of a host-traced window, split by the program's regions.

The port opens a ``torch.profiler.record_function`` range around each part
of its train step (``ray_tpu_torch.util.tracing.region``: ``gpt.qkv``,
``moe.dispatch``, ``train.optimizer``, ...) while a profiler that traces the
host runs. ``collect`` gives every device activity (kernel, copy or set) of
the window a region and a phase, from the host op that launched it (the
profiler links the two by correlation id):

- forward: the op ran inside a program range, in no autograd node;
- recompute: the op ran inside a program range, inside an autograd node (a
  checkpoint recomputing its forward while the backward runs);
- backward: the op ran inside an autograd node whose forward op (the same
  sequence number on the node's forward thread) ran inside a program range;
- unattributed: none of these, with no region.

The innermost range wins where ranges nest. The sums, device ms a step by
(region, phase, ``trace.group``), partition the device time of the window's
activities exactly, as ``trace.collect`` clips them to the window.

``collect`` reads the profiler's raw events into tuples (``events``) and
hands them to ``split``, a pure function the tests drive with made-up
tuples. A program that opens no range gives ``None``, and so does a window
with no device activity.

The readers of ``metrics/`` that use ``ms`` read ``trace["regions"]`` (the
rows) of a rank's payload, and ``moe_dropped_pct`` reads its
``window["moe_routes"]`` (the port's ``models.moe.route_counts()``).
``loop.py`` writes neither yet, and ``BENCHMARK.json`` lists none of those
metrics: wiring them takes the lines that PERF.md's open questions give, in
``loop.run_window``.
"""

from __future__ import annotations

import bisect

from port_bench.trace import WINDOW, group, mean

# The benchmark's own ranges, around its calls into the port.
OWN_PREFIX = "port_bench."
NODE_PREFIX = "autograd::engine::evaluate_function:"
BACKWARD_SCOPE = 1  # at::RecordScope::BACKWARD_FUNCTION

# Kinds of event tuple.
DEVICE, RANGE, OP, NODE = "device", "range", "op", "node"


def events(prof):
    """The raw events of a finished profiler as tuples ``(kind, name, start,
    end, tid, corr, linked, seq, fwd_tid)``, times in whole nanoseconds on
    the trace's clock (Unix time, which a float's microseconds would round):

    - ``device``: a kernel, copy or set; ``linked`` is the correlation id of
      the host op that launched it;
    - ``range``: a ``record_function`` range on the host;
    - ``node``: an autograd node running in the backward, with the sequence
      number and forward thread of the op that made it;
    - ``op``: any other host op, with its correlation id and its sequence
      number (-1 for an op that records no autograd node).

    CUDA API calls (``cudaLaunchKernel``, ...), which link to the
    op that made them, and the ranges' copies on the device's timeline are
    left out."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        name, annotation = e.name(), bool(e.is_user_annotation())
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if annotation:
                continue
            kind = DEVICE
        elif annotation:
            kind = RANGE
        elif e.linked_correlation_id() or name.startswith("cu"):
            continue  # a CUDA API call
        elif e.scope() == BACKWARD_SCOPE or name.startswith(NODE_PREFIX):
            kind = NODE
        else:
            kind = OP
        yield (kind, name, start, end, e.start_thread_id(), e.correlation_id(),
               e.linked_correlation_id(), e.sequence_nr(), e.fwd_thread_id())


class _Nest:
    """Properly nested intervals of one thread (a range or op stack), with
    the innermost one that holds a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.outer, stack = [], []
        for i, (a, b, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < a:
                stack.pop()
            self.outer.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t):
        """The payload of the innermost interval holding ``t``, or None."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.spans[j][1] < t:
            j = self.outer[j]
        return None if j < 0 else self.spans[j][2]


def _by_thread(spans):
    out = {}
    for tid, a, b, payload in spans:
        out.setdefault(tid, []).append((a, b, payload))
    return {tid: _Nest(s) for tid, s in out.items()}


def _innermost(nests, tid, t):
    nest = nests.get(tid)
    return None if nest is None else nest.at(t)


def split(evts, steps):
    """Device ms a step by (region, phase, group) of the ``WINDOW`` range's
    device activities: a list of ``[region, phase, group, ms]`` rows, region
    None where the phase is ``unattributed``. None when the window holds no
    program range or no device activity."""
    evts = list(evts)
    window = next(((a, b) for k, n, a, b, *_ in evts if k == RANGE and n == WINDOW), None)
    if window is None:
        return None
    t0, t1 = window
    ranges = [(tid, a, b, n) for k, n, a, b, tid, *_ in evts
              if k == RANGE and not n.startswith(OWN_PREFIX)]
    device = [(n, max(a, t0), min(b, t1), linked) for k, n, a, b, _, _, linked, _, _ in evts
              if k == DEVICE and b > t0 and a < t1]
    if not ranges or not device:
        return None
    in_range = _by_thread(ranges)
    in_node = _by_thread([(tid, a, b, (seq, fwd)) for k, _, a, b, tid, _, _, seq, fwd in evts
                          if k == NODE])
    ops = {corr: (tid, a) for k, _, a, _, tid, corr, *_ in evts if k in (OP, NODE)}
    # Ops that make no node record the sequence number the next node will
    # take: the node's own op is the last of its number to start.
    forward_op = {}
    for k, _, a, _, tid, _, _, seq, _ in evts:
        if k == OP and seq >= 0 and a >= forward_op.get((tid, seq), a):
            forward_op[(tid, seq)] = a

    def place(linked):
        """(region, phase) of a device activity from its launching op."""
        if linked not in ops:
            return None, "unattributed"
        tid, t = ops[linked]
        region = _innermost(in_range, tid, t)
        node = _innermost(in_node, tid, t)
        if region is not None:
            return region, "forward" if node is None else "recompute"
        if node is not None:
            seq, fwd = node
            if (fwd, seq) in forward_op:
                region = _innermost(in_range, fwd, forward_op[(fwd, seq)])
                if region is not None:
                    return region, "backward"
        return None, "unattributed"

    sums, placed = {}, {}
    for name, a, b, linked in device:
        if linked not in placed:
            placed[linked] = place(linked)
        key = (*placed[linked], group(name))
        sums[key] = sums.get(key, 0.0) + (b - a)
    return [[r, p, g, ns / 1e6 / steps]
            for (r, p, g), ns in sorted(sums.items(), key=lambda kv: str(kv[0]))]


def collect(prof, steps):
    """``split`` of a finished profiler's events."""
    return split(events(prof), steps)


def ms(run, pick):
    """Device ms a step of the rows ``pick(region, phase, group)`` accepts,
    mean over the ranks whose trace holds regions; None where none does."""
    out = []
    for r in run.ranks:
        rows = (r.get("trace") or {}).get("regions")
        if rows:
            out.append(sum(v for reg, phase, grp, v in rows if pick(reg, phase, grp)))
    return mean(out)

