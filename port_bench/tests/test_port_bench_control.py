"""The check's control at the nano size on the CPU: the reference in the
precision below the configuration's (fp8 products) comes out not correct
under the cell's limits, on every seed."""

import pytest

from conftest import nano
from port_bench import control


@pytest.mark.parametrize("cell", ["gpt2_small.pretrain", "gpt2_small_moe8.pretrain"])
def test_the_control_is_not_correct(cell):
    c = nano(cell)
    seeds = [2**31 + 101 * i for i in range(3)]
    lines = control.readings(c, control.plan(c, seeds, 3, 0), "cpu")
    ctl = [x for x in lines if x["kind"] == "control"]
    assert len(ctl) == 3
    for x in ctl:
        assert any(x[k] > limit for k, limit in c["limits"].items()), (x["seed"], c["limits"])
