"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix. The configuration is the
file that its entry in ``configs`` names; the traffic is
``port_bench/traffic/<traffic>.json`` (which names its generator module in
``port_bench/traffic/``); each per-layer metric that lists the cell (or
lists none) is read by ``port_bench/metrics/<metric>.py``; the limits of the
check are ``port_bench/limits/<cell>.json``. Adding a cell, a mix or a
metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(os.path.join(root, "BENCHMARK.json"))


def _for_cell(metrics, name):
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


def resolve(name, root=ROOT):
    """Everything a run of cell ``name`` needs, as plain data. Raises
    KeyError for a cell ``BENCHMARK.json`` does not hold, and OSError for a
    file that is missing."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    return assemble(bench, name, w["config"], w["traffic"], w["chips"], root)


def assemble(bench, name, config, traffic, chips, root=ROOT):
    """A cell from a configuration's name, a traffic mix's and its chips:
    ``resolve``'s work, and a way to run a cell whose files are here before
    ``BENCHMARK.json`` holds it."""
    configs = {c["name"]: c for c in bench["configs"]}
    mix = _json(os.path.join(HERE, "traffic", traffic + ".json"))
    if mix.get("workers", 1) != chips:
        raise ValueError(f"{name}: traffic {traffic} runs {mix.get('workers', 1)} workers on "
                         f"{chips} chips")
    per_layer = _for_cell(bench["per_layer"], name)
    for m in per_layer:
        reader_path(m["name"])  # raises if the reader is missing
    limits_file = os.path.join(HERE, "limits", name + ".json")
    return {
        "name": name, "chips": chips, "config": config,
        "model": _json(os.path.join(root, configs[config]["file"])), "traffic": mix,
        "end_to_end": _for_cell(bench["end_to_end"], name), "per_layer": per_layer,
        "limits": _json(limits_file) if os.path.exists(limits_file) else None,
        "run_seconds": bench["run_seconds"],
    }


def reader_path(metric):
    path = os.path.join(HERE, "metrics", metric + ".py")
    if not os.path.exists(path):
        raise OSError(f"no reader for per-layer metric {metric!r}: {path}")
    return path


def reader(metric):
    """The ``read(run)`` function of ``port_bench/metrics/<metric>.py``."""
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}",
                                                  reader_path(metric))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
