"""Models: tokens the MoE layers dropped over capacity over the tokens they
routed, in %, summed over the measured window's forwards (the port's
``route_counts``; a checkpoint's recompute not counted again) and over
ranks; None without a MoE or without the counter."""


def read(run):
    counts = [r["window"].get("moe_routes") for r in run.ranks]
    if None in counts:
        return None
    routed = sum(c["routed"] for c in counts)
    return 100 * sum(c["dropped"] for c in counts) / routed if routed else None
