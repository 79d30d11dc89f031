"""HuggingFace <-> ray_tpu_torch weight conversion for the Llama model
family (twin of ray_tpu/models/convert.py).

`load_hf_llama()` maps a `transformers` LlamaForCausalLM (object, state
dict, or local checkpoint path) onto the layer-stacked parameter tree of
`ray_tpu_torch.models.transformer`: the leaf names, `[L, ...]` stacking and
`[in, out]` weight layout of `init_params` and `bridge.py`.

Conventions line up exactly: HF Llama uses half-split ("rotate_half") RoPE
with inv_freq = theta^(-2i/d), the same scheme as `ops/layers.apply_rotary`,
so projections map with plain transposes, no head permutation. HF linear
weights are stored [out, in] and applied as x @ W.T; ours are stored
[in, out] and applied as x @ W, hence every projection transposes.

The conversion stays in torch: each layer's matrix is transposed and
copied into its slot of the stacked leaf on the params' device, cast once
to cfg.dtype, so a bf16 checkpoint converts exactly and the peak is the
output tree plus one layer's matrix. (The reference widens every tensor to
float32 numpy first, because numpy has no bfloat16.) For the same reason
`state_dict_from_params` returns tensors in the params' dtype where the
reference returns float32 arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ray_tpu_torch.models.transformer import ModelConfig
from ray_tpu_torch.ops.kernels._util import require_cuda

# our layer leaf -> (its HF name under model.layers.{i}., whether the HF
# tensor is the transpose of ours)
_LAYER_NAMES = {
    "attn_norm": ("input_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
}


def config_from_hf(hf_config: Any,
                   dtype: torch.dtype = torch.bfloat16) -> ModelConfig:
    """ModelConfig from a transformers LlamaConfig(-compatible) object. As
    the reference: `rope_scaling` and `head_dim` are not read, and remat
    and loss_chunk keep their defaults."""
    return ModelConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        norm_eps=float(hf_config.rms_norm_eps),
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
        dtype=dtype,
    )


def _copy(t: torch.Tensor, transpose: bool, dtype: torch.dtype,
          dev: torch.device) -> torch.Tensor:
    """A contiguous copy of its own, transposed if asked, in `dtype` on
    `dev` (never a view of `t`: the port's training writes its params in
    place)."""
    t = t.detach()
    return (t.t() if transpose else t).to(
        device=dev, dtype=dtype, memory_format=torch.contiguous_format,
        copy=True)


def params_from_hf_state_dict(state: Dict[str, Any], cfg: ModelConfig,
                              device="cuda") -> Dict[str, Any]:
    """Map an HF LlamaForCausalLM state dict to the parameter tree on
    `device`.

    Accepts either `model.`-prefixed keys (full LlamaForCausalLM) or bare
    ones (LlamaModel). Layer leaves are stacked on a leading L axis to
    match `init_params`, one layer at a time.
    """
    dev = require_cuda(device)
    pre = "model." if any(k.startswith("model.") for k in state) else ""

    def stacked(name: str, transpose: bool) -> torch.Tensor:
        first = state[f"{pre}layers.0.{name}"]
        shape = first.shape[::-1] if transpose else first.shape
        out = torch.empty((cfg.n_layers, *shape), dtype=cfg.dtype,
                          device=dev)
        for i in range(cfg.n_layers):
            m = state[f"{pre}layers.{i}.{name}"].detach()
            out[i].copy_(m.t() if transpose else m)
        return out

    params: Dict[str, Any] = {
        "embed": _copy(state[pre + "embed_tokens.weight"], False, cfg.dtype,
                       dev),
        "final_norm": _copy(state[pre + "norm.weight"], False, cfg.dtype,
                            dev),
        "layers": {ours: stacked(theirs, transpose)
                   for ours, (theirs, transpose) in _LAYER_NAMES.items()},
    }
    if not cfg.tie_embeddings:
        head = state.get("lm_head.weight")
        if head is None:
            raise ValueError(
                "state dict has no lm_head.weight but cfg.tie_embeddings is "
                "False — pass a full LlamaForCausalLM state dict, or set "
                "tie_embeddings=True if the checkpoint ties the output head "
                "to the embeddings")
        params["lm_head"] = _copy(head, True, cfg.dtype, dev)
    return params


def load_hf_llama(model_or_path: Any, dtype: torch.dtype = torch.bfloat16,
                  device="cuda") -> Tuple[Dict[str, Any], ModelConfig]:
    """(params, cfg) from an HF model object or local checkpoint path (the
    path needs `transformers`, imported only then)."""
    dev = require_cuda(device)
    if isinstance(model_or_path, str):
        from transformers import AutoModelForCausalLM

        model = AutoModelForCausalLM.from_pretrained(model_or_path)
    else:
        model = model_or_path
    cfg = config_from_hf(model.config, dtype=dtype)
    params = params_from_hf_state_dict(model.state_dict(), cfg, dev)
    return params, cfg


def state_dict_from_params(params: Dict[str, Any], cfg: ModelConfig
                           ) -> Dict[str, torch.Tensor]:
    """Inverse mapping, for exporting trained weights back to HF tooling:
    contiguous tensors of their own (the port's training updates its params
    in place), in the params' dtype and on their device."""
    def own(t: torch.Tensor, transpose: bool) -> torch.Tensor:
        return _copy(t, transpose, t.dtype, t.device)

    out: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": own(params["embed"], False),
        "model.norm.weight": own(params["final_norm"], False),
    }
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = own(params["lm_head"], True)
    for ours, (theirs, transpose) in _LAYER_NAMES.items():
        for i in range(cfg.n_layers):
            out[f"model.layers.{i}.{theirs}"] = own(
                params["layers"][ours][i], transpose)
    return out
