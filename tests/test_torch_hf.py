"""The port's HF GPT-2 import (ray_tpu_torch.models.hf) against the JAX
package's on the CPU: a random ``transformers.GPT2LMHeadModel`` built
locally (no download) converts to the same params as JAX's ``load_hf_gpt2``,
exactly, and the port's forward on them matches HF's logits within 1e-4. The
import itself needs no ``transformers``: it reads ``config`` and
``state_dict()``, or a plain state dict and its config.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models.hf import load_hf_gpt2 as j_load
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.convert import params_to_numpy
from ray_tpu_torch.models.hf import config_from_hf, load_hf_gpt2

transformers = pytest.importorskip("transformers")

HF_VOCAB = 130


@pytest.fixture(scope="module")
def hf_model():
    torch.manual_seed(0)
    model = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=HF_VOCAB, n_positions=64, n_embd=32, n_layer=2, n_head=2))
    return model.eval()


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_params_equal_jax_import(hf_model):
    cfg, params = load_hf_gpt2(hf_model, device="cpu", dtype=torch.float32)
    jcfg, jparams = j_load(hf_model)
    assert cfg.vocab_size == jcfg.vocab_size == 256  # 130 padded to a multiple of 128
    assert (cfg.n_layer, cfg.n_head, cfg.d_model, cfg.ff_dim, cfg.max_seq_len) == (
        jcfg.n_layer, jcfg.n_head, jcfg.d_model, jcfg.ff_dim, jcfg.max_seq_len)
    ours, ref = _flatten(params_to_numpy(params)), _flatten(jparams)
    assert ours.keys() == ref.keys()
    for name in ref:
        assert ours[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)
    assert not ours["wte"][HF_VOCAB:].any()  # padded rows are zero


def test_logits_match_hf(hf_model):
    cfg, params = load_hf_gpt2(hf_model, device="cpu", dtype=torch.float32, attention="xla")
    x = np.random.default_rng(0).integers(0, HF_VOCAB, (2, 16)).astype(np.int64)
    with torch.no_grad():
        ref = hf_model(torch.from_numpy(x)).logits.numpy()
        ours = tgpt.forward(params, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(ours[:, :, :HF_VOCAB], ref, atol=1e-4)
    # The kernels' path (their plain versions on the CPU) gives the same.
    cfg_flash, _ = load_hf_gpt2(hf_model, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        flash = tgpt.forward(params, torch.from_numpy(x), cfg_flash).numpy()
    np.testing.assert_allclose(flash[:, :, :HF_VOCAB], ref, atol=1e-4)


def test_plain_state_dict_and_dict_config(hf_model):
    # What a caller without transformers has: tensors by name and the config's fields.
    sd = {k: v.clone() for k, v in hf_model.state_dict().items()}
    conf = hf_model.config.to_dict()
    cfg, params = load_hf_gpt2(sd, hf_config=conf, device="cpu")
    ref_cfg, ref = load_hf_gpt2(hf_model, device="cpu")
    assert cfg == ref_cfg
    a, b = _flatten(params_to_numpy(params)), _flatten(params_to_numpy(ref))
    for name in b:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    with pytest.raises(ValueError, match="hf_config"):
        load_hf_gpt2(sd, device="cpu")
    with pytest.raises(TypeError, match="checkpoint name"):
        load_hf_gpt2("gpt2", device="cpu")


@pytest.mark.parametrize("field,value,match", [
    ("activation_function", "gelu", "tanh-gelu only"),
    ("activation_function", "relu", "tanh-gelu only"),
    ("layer_norm_epsilon", 1e-6, "layer_norm_epsilon"),
])
def test_config_raises_on_what_the_forward_lacks(hf_model, field, value, match):
    conf = {**hf_model.config.to_dict(), field: value}
    with pytest.raises(ValueError, match=match):
        config_from_hf(conf)


def test_import_needs_no_transformers(hf_model, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)  # import transformers -> ImportError
    cfg, params = load_hf_gpt2(hf_model, device="cpu")
    assert cfg.vocab_size == 256 and params["blocks"]["qkv_w"].shape == (2, 32, 3, 2, 16)


def test_jax_tree_leaf_count_matches(hf_model):
    _, params = load_hf_gpt2(hf_model, device="cpu")
    assert len(_flatten(params_to_numpy(params))) == len(jax.tree.leaves(j_load(hf_model)[1]))
