"""A configuration of another architecture is new files alone: a copy of
the harness takes a test-only two-layer Llama (the port's ``LlamaConfig.
nano``) through an architecture module, a plain float32 reference, a
configuration file and a limits file written into the copy, and every file
the copy already had stays byte for byte the repository's. The fixture never
enters ``BENCHMARK.json``."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

ARCH = '''"""Test-only: the port's nano Llama."""

import torch

from port_bench.weights import leaves

HALF_BATCH = ("ray_tpu_torch.models.llama", "loss_fn")


def port_config(model):
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.nano(vocab_size=model["vocab_size"], max_seq_len=model["max_seq_len"],
                            dtype=torch.float32, param_dtype=torch.float32)


def init_params(model, seed, device, dtype=torch.float32):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    d, L, V, F = model["d_model"], model["n_layer"], model["vocab_size"], model["d_ff"]
    nh, nkv = model["n_head"], model["n_kv_head"]
    hd = d // nh

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(0.02)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    return {"embed": normal(V, d),
            "blocks": {"attn_norm": ones(L, d), "wq": normal(L, d, nh, hd),
                       "wk": normal(L, d, nkv, hd), "wv": normal(L, d, nkv, hd),
                       "wo": normal(L, nh, hd, d), "mlp_norm": ones(L, d),
                       "w_gate": normal(L, d, F), "w_up": normal(L, d, F),
                       "w_down": normal(L, F, d)},
            "final_norm": ones(d), "lm_head": normal(V, d)}


def units(tree):
    return dict(leaves(tree))


def forward_flops_per_token(model, seq):
    d, L, V, F = model["d_model"], model["n_layer"], model["vocab_size"], model["d_ff"]
    kv = model["n_kv_head"] * d // model["n_head"]
    return L * (2 * (2 * d * d + 2 * d * kv + 3 * d * F) + 2 * d * (seq + 1)) + 2 * d * V


def attention_calls(model, traffic):
    nh = model["n_head"]
    hd = model["d_model"] // nh
    return [(traffic["rows_per_gpu"] * nh, traffic["seq"], hd, hd, model["n_layer"])]
'''

REFERENCE = '''"""Test-only plain float32 reference of the nano Llama: RMS norms, rotary
q and k, grouped-query causal attention, SwiGLU, an untied head, and AdamW
with global-norm clipping and decay on every leaf."""

import math

import torch
import torch.nn.functional as F

from port_bench.reference.gpt2 import matmul_for


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    S, half = x.shape[-2], x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32) / half)
    angles = torch.arange(S, dtype=torch.float32)[:, None] * freqs
    cos, sin, x1, x2 = angles.cos(), angles.sin(), x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def loss(p, tokens, m, mm):
    b, eps = p["blocks"], m["norm_eps"]
    x = p["embed"][tokens[:, :-1].long()]
    B, S, d = x.shape
    nh, nkv = m["n_head"], m["n_kv_head"]
    hd = d // nh

    def heads(h, w, n):
        return mm(h, w.reshape(d, n * hd)).view(B, S, n, hd).transpose(1, 2)

    for i in range(m["n_layer"]):
        h = _rms(x, b["attn_norm"][i], eps)
        q = _rope(heads(h, b["wq"][i], nh), m["rope_theta"])
        k = _rope(heads(h, b["wk"][i], nkv), m["rope_theta"]).repeat_interleave(nh // nkv, 1)
        v = heads(h, b["wv"][i], nkv).repeat_interleave(nh // nkv, 1)
        s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
        o = mm(s.softmax(-1), v).transpose(1, 2).reshape(B, S, d)
        x = x + mm(o, b["wo"][i].reshape(d, d))
        h = _rms(x, b["mlp_norm"][i], eps)
        x = x + mm(F.silu(mm(h, b["w_gate"][i])) * mm(h, b["w_up"][i]), b["w_down"][i])
    logits = mm(_rms(x, p["final_norm"], eps), p["lm_head"].t())
    return F.cross_entropy(logits.flatten(0, 1), tokens[:, 1:].long().flatten())


def _flat(tree):
    return [t for v in tree.values() for t in (_flat(v) if isinstance(v, dict) else [v])]


def _like(tree, flat):
    it = iter(flat)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it) for k, v in t.items()}

    return build(tree)


def train(params, batches, model, opt, precision="f32", on_step=None):
    mm, flat = matmul_for(precision), _flat(params)
    mu, nu, losses = [torch.zeros_like(p) for p in flat], [torch.zeros_like(p) for p in flat], []
    for n, tokens in enumerate(batches, 1):
        leaves = [p.detach().requires_grad_(True) for p in flat]
        value = loss(_like(params, leaves), tokens, model, mm)
        grads = torch.autograd.grad(value, leaves)
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if norm >= opt["grad_clip"]:
            grads = [g / norm * opt["grad_clip"] for g in grads]
        with torch.no_grad():
            for p, g, m1, m2 in zip(flat, grads, mu, nu):
                m1.mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                m2.mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                u = (m1 / (1 - opt["b1"] ** n)) / (torch.sqrt(m2 / (1 - opt["b2"] ** n))
                                                   + opt["eps"])
                p.sub_(opt["learning_rate"] * (u + opt["weight_decay"] * p))
        losses.append(value.item())
        if on_step is not None:
            on_step(n - 1, _like(params, list(grads)))
    return losses
'''

CONFIG = {
    "name": "llama_nano", "model_type": "llama", "reference": "llama_nano",
    "source": "the port's LlamaConfig.nano (test fixture)",
    "n_layer": 2, "n_head": 4, "n_kv_head": 2, "d_model": 64, "d_ff": 128, "vocab_size": 256,
    "max_seq_len": 128, "rope_theta": 10000.0, "norm_eps": 1e-05, "token_ids_below": 250,
    "reduced": [],
    "assumed": {"learning_rate": 0.0003, "weight_decay": 0.1, "b1": 0.9, "b2": 0.95,
                "eps": 1e-08, "grad_clip": 1.0},
}
# Float32 on both sides: the gaps are rounding, ~1e-6.
LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-3, "update_gap": 1e-3}

DRIVE = '''
import json, sys
sys.path[:0] = [{copy!r}, {root!r}]
import port_bench, torch
assert port_bench.__file__.startswith({copy!r}), port_bench.__file__
from port_bench import archs, cells, check, faults, flops
from port_bench.loop import Worker, reference_readings

bench = cells.benchmark({root!r})
bench["configs"].append({{"name": "llama_nano", "file": "port_bench/configs/llama_nano.json"}})
cell = cells.assemble(bench, "llama_nano.pretrain", "llama_nano", "pretrain_b32", 1, {copy!r})
cell["traffic"].update(rows_per_gpu=2, seq=32)
seed, cpu = 2**31 + 23, torch.device("cpu")
ref = reference_readings(cell, seed, cpu)
window = {{"losses": [], "steps": 0, "launches": {{}}}}
launches = archs.attention_launches(cell["model"], cell["traffic"])
out = {{"launches": launches, "flops": flops.train_flops_per_token(cell["model"], 32),
        "least_ms": flops.attention_step_ms(cell["model"], cell["traffic"])}}
for fault in (None, "half_batch"):
    undo = faults.plant(fault, cell["model"]) if fault else None
    try:
        w = Worker(cell, seed, cpu)
        w.build()
        program = w.checked_steps()
    finally:
        if undo:
            undo()
    correct, checks, _ = check.decide([{{"program": program, "reference": ref, "window": window}}],
                                      cell["limits"], launches, False)
    out[str(fault)] = {{"correct": correct, "checks": checks, "port": type(w.cfg).__name__}}
print(json.dumps(out))
'''


def _files(top):
    out = {}
    for here, dirs, names in os.walk(top):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", ".cache")]
        for n in names:
            path = os.path.join(here, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, top)] = f.read()
    return out


def test_a_second_architecture_is_new_files_alone(tmp_path):
    repo = os.path.join(ROOT, "port_bench")
    copy = tmp_path / "port_bench"
    shutil.copytree(repo, copy, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    new = {"archs/llama.py": ARCH, "reference/llama_nano.py": REFERENCE,
           "configs/llama_nano.json": json.dumps(CONFIG, indent=1),
           "limits/llama_nano.pretrain.json": json.dumps(LIMITS)}
    for rel, text in new.items():
        assert not (copy / rel).exists()
        (copy / rel).write_text(text)
    code = DRIVE.format(copy=str(tmp_path), root=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["launches"] == 2 and out["flops"] > 0
    assert 0 < out["least_ms"]["fwd"] < out["least_ms"]["bwd"]
    sound, half = out["None"], out["half_batch"]
    assert sound["port"] == "LlamaConfig"
    assert sound["correct"] is True, sound["checks"]
    assert half["correct"] is False, half["checks"]
    had, has = _files(repo), _files(copy)
    assert set(has) - set(had) == set(new)
    assert all(has[rel] == data for rel, data in had.items())
