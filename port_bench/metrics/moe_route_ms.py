"""Models: device ms a step in every kernel, copy and set of the MoE's
routing (``moe.route``: the router, the aux loss, the route counter),
``moe.dispatch`` and ``moe.combine``, forward, recompute and backward, from
the host-traced window, mean over ranks; None without a MoE."""

from port_bench.regions import ms

REGIONS = ("moe.route", "moe.dispatch", "moe.combine")


def read(run):
    if not any(row[0] in REGIONS for r in run.ranks
               for row in (r.get("trace") or {}).get("regions") or []):
        return None
    return ms(run, lambda region, phase, group: region in REGIONS)
