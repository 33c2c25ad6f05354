"""A short run of each one-GPU cell on the card, through the command the
check runs. Skips without a GPU; on the chip: ``python -m pytest
port_bench/tests -q -m card``."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell", ["gpt2_small.pretrain", "gpt2_small_moe8.pretrain"])
def test_a_short_run_on_the_card_is_correct(card, cell):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 77), "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
