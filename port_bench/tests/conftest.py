"""Fixtures of the benchmark's own tests: a cell cut to a size the CPU runs
in seconds, and ``card``, which skips a test that needs an NVIDIA GPU."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

NANO_MODEL = dict(n_layer=2, n_head=2, n_embd=64, vocab_size=256, n_positions=64,
                  token_ids_below=250)
NANO_TRAFFIC = dict(rows_per_gpu=2, seq=32, trace_steps=4, host_trace_steps=2, report_every=2)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (runs on the chip only)")


# The data-parallel cell, whose files the harness holds while
# BENCHMARK.json leaves it out (its four-GPU runs spread too widely to bound).
DATA_PARALLEL = ("gpt2_small.pretrain_dp4", "gpt2_small", "pretrain_b16_dp4", 4)


def cell(name):
    """``cells.resolve(name)``, or the data-parallel cell assembled from its
    files, with the dense cell's per-layer metrics."""
    from port_bench import cells

    if name != DATA_PARALLEL[0]:
        return cells.resolve(name)
    c = cells.assemble(cells.benchmark(), *DATA_PARALLEL)
    c["per_layer"] = cells.resolve("gpt2_small.pretrain")["per_layer"]
    return c


def nano(name, workers=None):
    """Cell ``name`` (see ``cell``) cut to the nano size: every width and
    count small, one or two workers, its limits kept."""
    cell_ = cell(name)
    cell_["model"].update(NANO_MODEL)
    if cell_["model"].get("n_inner"):
        cell_["model"]["n_inner"] = 256
    cell_["traffic"].update(NANO_TRAFFIC)
    if cell_["traffic"].get("workers", 1) > 1:
        cell_["traffic"].update(workers=workers or 2, mesh={"data": workers or 2})
    return cell_


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the chip")
