"""Every cell of BENCHMARK.json resolves to its files by name."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves_to_its_files(cell):
    from port_bench import cells

    c = cells.resolve(cell)
    assert c["model"]["name"] == c["config"]
    assert c["traffic"]["workers"] == c["chips"]
    assert c["limits"] is not None and set(c["limits"]) >= {"loss_gap", "update_gap"}
    assert set(c["limits"]) & {"grad_gap", "grad_gap_median"}
    for m in c["per_layer"]:
        assert callable(cells.reader(m["name"]))
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}


def test_the_data_parallel_cell_assembles_from_its_files():
    from conftest import cell

    c = cell("gpt2_small.pretrain_dp4")
    assert c["chips"] == 4 and c["traffic"]["mesh"] == {"data": 4}
    assert set(c["limits"]) == {"loss_gap", "grad_gap", "update_gap"}


def test_unknown_cell_fails():
    from port_bench import cells

    with pytest.raises(KeyError):
        cells.resolve("no_such_model.pretrain")


def test_benchmark_json_keeps_to_its_shapes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            model = json.load(f)
        assert model["reduced"] == c["reduced"] and model["source"] == c["source"]
        for k in c["reduced"]:
            assert k in model and not k.endswith(("_dim", "_rank"))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    assert all(os.path.isdir(os.path.join(ROOT, p)) for p in b["paths"])
