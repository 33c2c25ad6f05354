"""Collectives: device ms a step in which an NCCL kernel runs and no other
kernel does, mean over ranks (``tools/port_multichip.py``'s overlap
arithmetic, ``span_overlap_ms``)."""

from port_bench.trace import group, length, mean, overlap, traces, union


def read(run):
    out = []
    for t in traces(run.ranks):
        nccl = union(t.spans(lambda n: group(n) == "nccl"))
        if not nccl:
            continue
        compute = union(t.spans(lambda n: group(n) not in ("nccl", "copy")))
        out.append((length(nccl) - overlap(nccl, compute)) / 1e3 / t.steps)
    return mean(out)
