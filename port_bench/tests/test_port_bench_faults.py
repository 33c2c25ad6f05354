"""A whole run on the CPU at the nano size, through ``TorchTrainer`` as on
the card but without the look for one, with the timed path broken
underneath: ``correct`` comes out false for each fault the cell can have.
The sound program comes out correct where its nano readings lie under the
cell's limits on every seed tried (the MoE cell, the data-parallel one):
the dense cell's nano update gap, over units of a few hundred elements,
reads above the full size's limit on most seeds."""

import pytest

from conftest import nano
from port_bench import control
from port_bench.run import run_cell

SEED = 2**31 + 4242


def cases():
    out = []
    for cell in ("gpt2_small.pretrain", "gpt2_small_moe8.pretrain", "gpt2_small.pretrain_dp4"):
        c = nano(cell)
        out += [(cell, f) for f in control.cell_faults(c)]
    return out


@pytest.mark.parametrize("cell,fault", cases())
def test_a_planted_fault_is_not_correct(cell, fault):
    line = run_cell(nano(cell), SEED, 1.0, False, device="cpu", fault=fault)
    assert line["correct"] is False
    failing = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert failing, line["checks"]


@pytest.mark.parametrize("cell", ["gpt2_small_moe8.pretrain", "gpt2_small.pretrain_dp4"])
def test_the_sound_program_is_correct(cell):
    line = run_cell(nano(cell), SEED, 1.0, True, device="cpu")
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert {"worker_start_s", "first_step_s", "report_ms"} <= set(line["metrics"])
    # A CPU run reads no device: no device metric, no breakdown of device ops.
    assert not {"step_mfu", "gemm_ms", "device_idle"} & set(line["metrics"])
    assert list(line)[-1] == "checks"
