"""Models: tokens the MoE layers dropped over capacity over the tokens they
routed, in %, summed over the traced steps' forwards and over ranks: the
port's ``route_counts``, reset right before the steps that trace the device
alone and read after their sync (on the CPU, over the host-traced steps), so
the timed window runs no counter; a checkpoint's recompute is not counted
again. None without a MoE or without the count."""


def read(run):
    counts = [(r.get("trace") or {}).get("moe_routes") for r in run.ranks]
    if None in counts:
        return None
    routed = sum(c["routed"] for c in counts)
    return 100 * sum(c["dropped"] for c in counts) / routed if routed else None
