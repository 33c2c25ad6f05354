"""The comparison that decides ``correct``.

The program's first ``checked_steps`` steps on the window's own path are
held against the reference (``reference/<reference>.py``, float32) on the
same weights and batches, by three numbers:

- ``loss_gap``: the largest gap, in nats, between the program's and the
  reference's loss at any of the steps;
- ``grad_gap``: over the units (the architecture's ``units``), the largest
  gap between the norms of the program's and the reference's first gradient
  as the optimizer takes it (after clipping), over the larger of the
  reference's norm of that unit and of the median unit;
- ``update_gap``: the same of the parameters' change over the steps, leaving
  out each unit whose reference gradient is under ``ROUND_OFF`` of the
  median unit's: such a unit (the key's bias, under the softmax) has a
  gradient of rounding alone, which Adam turns into a step of the same size
  in either direction;
- ``grad_gap_median``, ``update_gap_median``: the median unit's gap of
  each, steady where one small unit's gap swings (a MoE router's gradient
  changes with every token whose expert the rounding changes).

A cell compares the numbers its ``limits/<cell>.json`` names.

On a mesh each rank's readings are compared, and the worst counts. Two
exact checks of the window join them: every reported loss is finite, and on
a card each attention kernel launched as many times a step as the
architecture's ``attention_calls`` count (``archs.attention_launches``).
"""

from __future__ import annotations

import math
import statistics

ROUND_OFF = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "update_gap", "grad_gap_median", "update_gap_median")


def _finite(x):
    return x if math.isfinite(x) else math.inf


def relative_gaps(program, reference):
    """Each unit's gap between the program's and the reference's norm, over
    the larger of the reference's norm of the unit and of the median unit:
    of the first gradient (every unit) and of the change (the units whose
    reference gradient is not rounding alone)."""
    g_ref, d_ref = reference["grad_units"], reference["delta_units"]
    g_med = statistics.median(g_ref.values())
    kept = [u for u in g_ref if g_ref[u] >= ROUND_OFF * g_med]
    d_med = statistics.median(d_ref[u] for u in kept)

    def rel(prog, ref, units, floor):
        return {u: _finite(abs(prog[u] - ref[u]) / max(ref[u], floor)) for u in units}

    return (rel(program["grad_units"], g_ref, list(g_ref), g_med),
            rel(program["delta_units"], d_ref, kept, d_med), sorted(set(g_ref) - set(kept)))


def gaps(program, reference):
    """The numbers, and the unit that sets each worst gap."""
    loss_gap = max(_finite(abs(a - b)) for a, b in zip(program["losses"], reference["losses"]))
    grad, update, left_out = relative_gaps(program, reference)
    grad_unit, update_unit = max(grad, key=grad.get), max(update, key=update.get)
    return {"loss_gap": loss_gap, "grad_gap": grad[grad_unit], "update_gap": update[update_unit],
            "grad_gap_median": statistics.median(grad.values()),
            "update_gap_median": statistics.median(update.values()),
            "grad_unit": grad_unit, "update_unit": update_unit, "left_out": left_out}


def worst_over_ranks(ranks, reference):
    out = None
    for r in ranks:
        g = gaps(r["program"], reference)
        if out is None:
            out = g
            continue
        for k in NUMBERS:
            if g[k] > out[k]:
                out[k] = g[k]
                unit = k.replace("gap", "unit")
                if unit in g:
                    out[unit] = g[unit]
    return out


def decide(ranks, limits, launches_per_step, on_card):
    """(correct, checks, details): each number the cell's limits name,
    beside its limit, then the exact checks. Without limits nothing is
    correct."""
    g = worst_over_ranks(ranks, ranks[0]["reference"])
    checks = {k: {"value": g[k], "limit": v} for k, v in (limits or {}).items() if k in NUMBERS}
    losses = [x for r in ranks for x in r["window"]["losses"] + r["program"]["losses"]]
    checks["nonfinite_losses"] = {"value": sum(not math.isfinite(x) for x in losses), "limit": 0}
    if on_card:
        off = 0
        for r in ranks:
            steps = r["window"]["steps"]
            for count in r["window"]["launches"].values():
                off = max(off, abs(count - launches_per_step * steps))
        checks["launches_off"] = {"value": off, "limit": 0}
    correct = bool(limits) and all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks, g
