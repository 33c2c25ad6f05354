"""HuggingFace GPT-2 import: the counterpart of ``ray_tpu/models/hf.py``.

Converts a GPT-2 checkpoint to ``models/gpt.py``'s stacked-layer tree without
importing ``transformers``: it reads ``model.config`` and
``model.state_dict()``, or a plain state dict and its config (an object or a
dict with GPT2Config's attribute names).

- HF's Conv1D stores weights (in, out): already the einsum orientation.
- ``c_attn`` packs q|k|v along its output dim: (d, 3d) -> (d, 3, nh, hd).
- Per-layer tensors stack on a leading ``(L, ...)`` dim.
- The vocab pads up to a multiple of 128 with zero rows; their logits sit at
  0, so slice ``[..., :hf_vocab]`` for HF's logits.
"""

from __future__ import annotations

import types
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.models.training import tree_map


def _pad_vocab(n: int, multiple: int = 128) -> int:
    return (n + multiple - 1) // multiple * multiple


def config_from_hf(hf_config, **overrides) -> GPTConfig:
    """The GPTConfig of a GPT2Config (vocab padded to a multiple of 128).

    Raises on HF options the forward does not implement (activations other
    than tanh-GELU, a layer-norm eps other than 1e-5) rather than diverge."""
    if isinstance(hf_config, Mapping):
        hf_config = types.SimpleNamespace(**hf_config)
    act = getattr(hf_config, "activation_function", "gelu_new")
    # gpt.py computes the tanh approximation; HF "gelu" is the exact erf form.
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(f"unsupported activation_function {act!r} (tanh-gelu only)")
    eps = float(getattr(hf_config, "layer_norm_epsilon", 1e-5))
    if abs(eps - 1e-5) > 1e-9:
        raise ValueError(f"layer_norm_epsilon {eps} != 1e-5 (models/gpt.py hardcodes 1e-5)")
    kw = dict(
        vocab_size=_pad_vocab(hf_config.vocab_size),
        n_layer=hf_config.n_layer,
        n_head=hf_config.n_head,
        d_model=hf_config.n_embd,
        d_ff=getattr(hf_config, "n_inner", None) or 0,  # 0 -> 4 * d_model
        max_seq_len=hf_config.n_positions,
    )
    kw.update(overrides)
    return GPTConfig(**kw)


def load_hf_gpt2(model, hf_config=None, device=None,
                 **config_overrides) -> Tuple[GPTConfig, Dict[str, Any]]:
    """Convert a GPT-2 to ``(GPTConfig, params)``, the params tensors on
    ``device`` (``None``: the GPU; raises when there is none).

    ``model`` is an object with ``config`` and ``state_dict()`` (a
    ``GPT2LMHeadModel``), or a state dict of tensors, with its config as
    ``hf_config``.
    Loading a checkpoint by name needs ``transformers``, which the port does
    not import: load the model first and pass it."""
    if isinstance(model, str):
        raise TypeError("load_hf_gpt2 takes a model or a state dict, not a checkpoint name")
    if isinstance(model, Mapping):
        if hf_config is None:
            raise ValueError("a state dict needs its config: pass hf_config=")
        sd: Mapping[str, Any] = model
    else:
        sd, hf_config = model.state_dict(), model.config
    config = config_from_hf(hf_config, **config_overrides)
    params = params_from_numpy(_convert(sd, config), device)
    return config, tree_map(lambda t: t.to(config.param_dtype), params)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _convert(sd: Mapping[str, Any], config: GPTConfig) -> Dict[str, Any]:
    """The f32 numpy param tree of a GPT-2 state dict."""
    L, d = config.n_layer, config.d_model
    nh, hd = config.n_head, config.head_dim
    pd = np.float32
    emb = _numpy(sd["transformer.wte.weight"])
    wte = np.zeros((config.vocab_size, d), pd)
    wte[: emb.shape[0]] = emb

    def stack(fmt, reshape: Optional[tuple] = None):
        arrs = [_numpy(sd[fmt.format(i)]) for i in range(L)]
        out = np.stack([a.reshape(reshape) if reshape else a for a in arrs])
        return np.ascontiguousarray(out, pd)

    blocks = {
        "ln1_scale": stack("transformer.h.{}.ln_1.weight"),
        "ln1_bias": stack("transformer.h.{}.ln_1.bias"),
        "qkv_w": stack("transformer.h.{}.attn.c_attn.weight", (d, 3, nh, hd)),
        "qkv_b": stack("transformer.h.{}.attn.c_attn.bias", (3, nh, hd)),
        "out_w": stack("transformer.h.{}.attn.c_proj.weight", (nh, hd, d)),
        "out_b": stack("transformer.h.{}.attn.c_proj.bias"),
        "ln2_scale": stack("transformer.h.{}.ln_2.weight"),
        "ln2_bias": stack("transformer.h.{}.ln_2.bias"),
        "fc_w": stack("transformer.h.{}.mlp.c_fc.weight"),
        "fc_b": stack("transformer.h.{}.mlp.c_fc.bias"),
        "proj_w": stack("transformer.h.{}.mlp.c_proj.weight"),
        "proj_b": stack("transformer.h.{}.mlp.c_proj.bias"),
    }
    return {
        "wte": wte,
        "wpe": np.ascontiguousarray(_numpy(sd["transformer.wpe.weight"]), pd),
        "blocks": blocks,
        "lnf_scale": np.ascontiguousarray(_numpy(sd["transformer.ln_f.weight"]), pd),
        "lnf_bias": np.ascontiguousarray(_numpy(sd["transformer.ln_f.bias"]), pd),
    }
