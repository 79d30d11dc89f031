"""Flagship model config and parameters (twin of ray_tpu/models/transformer.py),
serving part: the config and its presets, the scaled-normal init, and the
read-side helpers the serving forward passes use (`_deq`, `_embed_lookup`,
`lm_head_weights`).

Parameters are a plain dict with the JAX package's leaf names, the same
layer-stacked `[L, ...]` shapes and `[in, out]` weight layout, so one tree
moves between the two packages through `ray_tpu_torch.bridge`. w8a16 leaves
are `{"int8", "scale"}` dicts; `_deq` and the int8 branch of `_embed_lookup`
dequantize them with the hand-written dequant kernel.

Training (`forward`, `loss_fn`, remat) is a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ray_tpu_torch.ops.kernels._util import require_cuda
from ray_tpu_torch.ops.kernels.quant import dequantize_int8


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32768
    d_model: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    d_ff: int = 8192
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # The fields below select training-side behaviour in the JAX package;
    # they are kept so configs compare field for field.
    remat: str = "full"
    loss_chunk: int = 0
    use_ring_attention: bool = False
    seq_parallel: str = ""
    tie_embeddings: bool = False
    scan_unroll: int = 1
    fused_proj: bool = False
    n_experts: int = 0
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    fused_ffn: bool = False
    fused_attn: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    # ---- presets ----
    @staticmethod
    def tiny() -> "ModelConfig":
        return ModelConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                           n_kv_heads=2, d_ff=256, max_seq_len=256,
                           dtype=torch.float32, remat="none")

    @staticmethod
    def b1() -> "ModelConfig":
        """~1.2B params."""
        return ModelConfig(vocab_size=32768, d_model=2048, n_layers=16,
                           n_heads=16, n_kv_heads=8, d_ff=8192)

    @staticmethod
    def tiny_moe() -> "ModelConfig":
        return ModelConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                           n_kv_heads=2, d_ff=256, max_seq_len=256,
                           dtype=torch.float32, remat="none", n_experts=4)

    @staticmethod
    def llama3_8b() -> "ModelConfig":
        """Llama-3-8B shapes (vocab rounded to a 128-multiple)."""
        return ModelConfig(vocab_size=128256, d_model=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, d_ff=14336,
                           max_seq_len=8192)


# ---------------------------------------------------------------- params


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Scaled-normal init from a `torch.Generator` seeded with `seed` on
    `device`, weights stored in cfg.dtype. The scheme is the JAX package's;
    the numbers differ (different generators), so parity tests load the
    JAX parameters through the bridge instead."""
    dev = require_cuda(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers

    def normal(shape, std, per_layer=False):
        # float32 draw scaled then cast, as the reference; stacked leaves are
        # drawn one layer at a time so the float32 transient stays small
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for part in (out if per_layer else (out,)):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev,
                                   dtype=torch.float32) * std)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    layers: Dict[str, Any] = {
        "attn_norm": ones((L, d)),
        "wq": normal((L, d, nq * hd), d ** -0.5, True),
        "wk": normal((L, d, nkv * hd), d ** -0.5, True),
        "wv": normal((L, d, nkv * hd), d ** -0.5, True),
        "wo": normal((L, nq * hd, d), (nq * hd) ** -0.5, True),
        "mlp_norm": ones((L, d)),
    }
    if cfg.n_experts > 0:
        E = cfg.n_experts
        layers.update({
            "router": normal((L, d, E), 0.02, True),
            "w_gate": normal((L, E, d, cfg.d_ff), d ** -0.5, True),
            "w_up": normal((L, E, d, cfg.d_ff), d ** -0.5, True),
            "w_down": normal((L, E, cfg.d_ff, d), cfg.d_ff ** -0.5, True),
        })
    else:
        layers.update({
            "w_gate": normal((L, d, cfg.d_ff), d ** -0.5, True),
            "w_up": normal((L, d, cfg.d_ff), d ** -0.5, True),
            "w_down": normal((L, cfg.d_ff, d), cfg.d_ff ** -0.5, True),
        })
    params: Dict[str, Any] = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "final_norm": ones((d,)),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), 0.02)
    return params


def tree_leaves(tree: Any):
    """Tensors of a nested-dict parameter tree, in key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    else:
        yield tree


def count_params(params: Any) -> int:
    return sum(t.numel() for t in tree_leaves(params))


# ---------------------------------------------------------------- read side


def _deq(leaf: Any, dtype: torch.dtype) -> Any:
    """Pass tensors through; dequantize `{"int8", "scale"}` leaves produced
    by `models.serving.quantize_model_params` with the dequant kernel."""
    if isinstance(leaf, dict) and "int8" in leaf:
        return dequantize_int8(leaf["int8"], leaf["scale"], dtype)
    return leaf


def _deq_tree(p: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    return {k: _deq(v, dtype) for k, v in p.items()}


def _layer_slice(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer `i` of the stacked `[L, ...]` leaves (views, no copies)."""
    return {k: ({"int8": v["int8"][i], "scale": v["scale"][i]}
                if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def _embed_lookup(emb: Any, tokens: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Token-embedding gather; for int8-quantized tables the gather happens
    in int8 and only the gathered rows are dequantized."""
    if isinstance(emb, dict) and "int8" in emb:
        return dequantize_int8(emb["int8"][tokens], emb["scale"][tokens],
                               dtype)
    return emb[tokens].to(dtype)


def lm_head_weights(params: Dict[str, Any], cfg: ModelConfig) -> torch.Tensor:
    """[d_model, vocab] output-projection weights in activation dtype."""
    head = (_deq(params["embed"], cfg.dtype).T if cfg.tie_embeddings
            else _deq(params["lm_head"], cfg.dtype))
    return head.to(cfg.dtype)
