"""What the benchmark loads: never JAX or the JAX package, and the reference
nothing of the program. Top-level names are compared whole: ``ray_tpu_torch``
is not ``ray_tpu``."""

import ast
import glob
import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "ray_tpu"}


def loaded(modules):
    code = ("import json, sys; sys.path.insert(0, %r)\n" % ROOT
            + "".join(f"import {m}\n" for m in modules)
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    from port_bench import cells

    mods = ["port_bench.run", "port_bench.loop", "port_bench.control", "port_bench.check",
            "port_bench.trace", "port_bench.faults", "port_bench.reference.gpt2",
            "port_bench.traffic.zipf_lm", "ray_tpu_torch", "ray_tpu_torch.train.torch",
            "ray_tpu_torch.models"]
    top = loaded(mods)
    assert not top & FORBIDDEN
    assert "ray_tpu_torch" in top
    for path in glob.glob(os.path.join(cells.HERE, "metrics", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert node.module.split(".")[0] not in FORBIDDEN, path


def test_the_reference_loads_nothing_of_the_program():
    top = loaded(["port_bench.reference.gpt2"])
    assert not top & (FORBIDDEN | {"ray_tpu_torch"})
    tree = ast.parse(open(os.path.join(ROOT, "port_bench", "reference", "gpt2.py")).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & (FORBIDDEN | {"ray_tpu_torch", "port_bench"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import types

    from port_bench.loop import forbidden_modules

    for name in ("ray_tpu_torch.models", "ray_tpux", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ray_tpu.core", types.ModuleType("ray_tpu.core"))
    assert forbidden_modules() == ["ray_tpu"]
