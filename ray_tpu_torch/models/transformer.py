"""Flagship model (twin of ray_tpu/models/transformer.py): the config and
its presets, the scaled-normal init, the read-side helpers the serving
passes use (`_deq`, `_embed_lookup`, `lm_head_weights`), and the training
forward and loss (`forward_features_with_aux`, `forward`, `loss_fn`).

Parameters are a plain dict with the JAX package's leaf names, the same
layer-stacked `[L, ...]` shapes and `[in, out]` weight layout, so one tree
moves between the two packages through `ray_tpu_torch.bridge`. w8a16 leaves
are `{"int8", "scale"}` dicts; `_deq` and the int8 branch of `_embed_lookup`
dequantize them with the hand-written dequant kernel.

The reference's `lax.scan` over layers is a Python loop over
`torch.unbind` views of the stacked leaves: autograd then stacks each
leaf's per-layer gradients once, in one `[L, ...]` tensor. With
`fused_ffn` (and `fused_attn`) each layer is the pair of autograd.Functions
in `ops/kernels/fused_ffn.py` and `fused_attn.py`, whose backwards run the
flash and K3 kernels. With `n_experts > 0` the FFN is the top-2 MoE of
`ops/moe.py` and `loss_fn` adds `moe_aux_weight` times the layers' summed
load-balancing loss. Every remat mode is ported: `full` is
`torch.utils.checkpoint`, and the selective `dots` family keeps the values
the reference's policy keeps, named through `ops/remat.py`
(`maybe_remat`). Sequence parallelism raises until its port lands
(ROADMAP.md queue A item 7).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint

from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.kernels._util import require_cuda, tree_leaves
from ray_tpu_torch.ops.kernels.fused_attn import attn_block
from ray_tpu_torch.ops.kernels.fused_ffn import ffn_block
from ray_tpu_torch.ops.kernels.quant import dequantize_int8
from ray_tpu_torch.ops.layers import (apply_rotary, rms_norm,
                                      rotary_embedding, swiglu)
from ray_tpu_torch.ops.moe import moe_ffn
from ray_tpu_torch.ops.remat import (checkpoint_name, named_matmul,
                                     selective_checkpoint)


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
    # Training-side behaviour, as in the JAX package: remat, the chunked
    # loss, MoE, the fused blocks. Sequence parallelism raises until its
    # port lands; the rest are kept so configs compare field for field.
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
    JAX parameters through the bridge instead. On the "meta" device (the
    counterpart of `jax.eval_shape`) every leaf is an empty meta tensor of
    its shape and dtype, and nothing is drawn."""
    dev = require_cuda(device)
    gen = None
    if dev.type != "meta":  # a meta generator does not exist
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers

    def normal(shape, std, per_layer=False):
        # float32 draw scaled then cast, as the reference; stacked leaves are
        # drawn one layer at a time so the float32 transient stays small
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        if gen is None:
            return out
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


# ---------------------------------------------------------------- forward


def _unstack(layers: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-layer dicts of `torch.unbind` views of the stacked leaves."""
    cols = {}
    for k, v in layers.items():
        if isinstance(v, dict):
            cols[k] = [{"int8": a, "scale": s} for a, s in
                       zip(torch.unbind(v["int8"]), torch.unbind(v["scale"]))]
        else:
            cols[k] = torch.unbind(v)
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _unported(cfg: ModelConfig) -> None:
    if cfg.seq_parallel or cfg.use_ring_attention:
        raise NotImplementedError(
            "sequence parallelism is not ported yet (ROADMAP.md, queue A "
            "item 7)")


def _attn_half(cfg: ModelConfig, x, p, cos, sin):
    """Attention sub-block: x + Wo(attn(rotary(qkv(rmsnorm(x)))))."""
    p = _deq_tree(p, cfg.dtype)
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    nq_d, nkv_d = cfg.n_heads * hd, cfg.n_kv_heads * hd
    if cfg.fused_proj:
        qkv = named_matmul(h, torch.cat([p["wq"], p["wk"], p["wv"]], dim=1),
                           "qkv")
        q, k, v = (checkpoint_name(t, n) for t, n in (
            (qkv[..., :nq_d], "qkv_q"), (qkv[..., nq_d:nq_d + nkv_d], "qkv_k"),
            (qkv[..., nq_d + nkv_d:], "qkv_v")))
    else:
        q, k, v = (named_matmul(h, p[w], n) for w, n in (
            ("wq", "qkv_q"), ("wk", "qkv_k"), ("wv", "qkv_v")))
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [b, heads, s, hd]
    attn = attention(q, k, v, causal=True)
    attn = checkpoint_name(
        attn.transpose(1, 2).reshape(b, s, cfg.n_heads * hd), "attn_out")
    return x + named_matmul(attn, p["wo"], "attn_proj").to(x.dtype)


def _layer(cfg: ModelConfig, x, layer_params, cos, sin):
    """One transformer block; returns (x, moe_aux), moe_aux 0 for a dense
    FFN."""
    x = _attn_half(cfg, x, layer_params, cos, sin)
    p = _deq_tree(layer_params, cfg.dtype)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if cfg.n_experts > 0:
        out, aux = moe_ffn(h, p["router"], p["w_gate"], p["w_up"],
                           p["w_down"], cfg.capacity_factor)
        return x + out.to(x.dtype), aux
    if cfg.fused_proj:
        gu = named_matmul(h, torch.cat([p["w_gate"], p["w_up"]], dim=1),
                          "ffn_gate_up")
        gate = checkpoint_name(gu[..., :cfg.d_ff], "ffn_gate")
        up = checkpoint_name(gu[..., cfg.d_ff:], "ffn_up")
    else:
        gate = named_matmul(h, p["w_gate"], "ffn_gate")
        up = named_matmul(h, p["w_up"], "ffn_up")
    x = x + named_matmul(swiglu(gate, up), p["w_down"], "ffn_down").to(
        x.dtype)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# The values each selective mode may keep, by their names (`ops/remat.py`):
# `dots` (the reference's dots_with_no_batch_dims_saveable) every product
# without batch dimensions, which are the named projections and the MoE
# router and dispatch products (the per-expert products and the attention
# einsums have batch dimensions, the combine product is unnamed: it only
# feeds the residual add); `dots_sans_qkv` the reference's four names;
# `dots_plus_attn` both policies' union with "attn_out".
_DOTS = frozenset({"qkv", "qkv_q", "qkv_k", "qkv_v", "attn_proj",
                   "ffn_gate_up", "ffn_gate", "ffn_up", "ffn_down",
                   "moe_router", "moe_dispatch"})
_SAVEABLE = {
    "dots": _DOTS,
    "dots_sans_qkv": frozenset({"attn_proj", "ffn_gate", "ffn_up",
                                "ffn_down"}),
    "dots_plus_attn": _DOTS | {"attn_out"},
}
# JAX keeps a saveable value only where the region's backward reads it
# (jax.ad_checkpoint.print_saved_residuals on the reference's layer); the
# port's policy saves the same set. A whole layer's backward reads every
# named value but ffn_down (it only feeds the residual add); the attention
# half's (the fused_ffn layer) reads q, k, v and attn_out, not attn_proj.
# (Under dots_sans_qkv JAX keeps silu(gate) where the port keeps ffn_up,
# a value of the same shape.)
_READ_BY_BACKWARD = {
    "layer": (_DOTS | {"attn_out"}) - {"ffn_down"},
    "attn": frozenset({"qkv", "qkv_q", "qkv_k", "qkv_v", "attn_out"}),
}


def maybe_remat(layer_fn, cfg: ModelConfig, region: str = "layer"):
    """Wrap a layer body per cfg.remat: "none" keeps every activation,
    "full" recomputes the body in the backward (torch.utils.checkpoint);
    "dots", "dots_sans_qkv" and "dots_plus_attn" keep the named values
    `_SAVEABLE[cfg.remat]` that the backward of `region` ("layer" or the
    attention half, "attn") reads, and recompute the rest. The flash
    forward is rerun by every recomputing mode, dots_plus_attn included:
    its backward reads the logsumexp, which no policy names."""
    if cfg.remat == "full":
        return functools.partial(torch.utils.checkpoint.checkpoint, layer_fn,
                                 use_reentrant=False)
    if cfg.remat in _SAVEABLE:
        return selective_checkpoint(
            layer_fn, _SAVEABLE[cfg.remat] & _READ_BY_BACKWARD[region])
    if cfg.remat != "none":
        raise ValueError(f"unknown remat mode {cfg.remat!r}")
    return layer_fn


def forward_features_with_aux(params: Dict[str, Any], tokens: torch.Tensor,
                              cfg: ModelConfig,
                              positions: Optional[torch.Tensor] = None):
    """tokens [b, s] -> (features [b, s, d] after final norm, moe_aux
    scalar)."""
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed_lookup(params["embed"], tokens, cfg.dtype)  # [b, s, d]
    cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[None], sin[None]  # add batch dim
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.fused_attn and not cfg.fused_ffn:
        raise ValueError("fused_attn requires fused_ffn")
    if cfg.fused_ffn and (cfg.n_experts > 0 or cfg.seq_parallel
                          or cfg.use_ring_attention):
        raise ValueError("fused_ffn supports the dense, non-sp path only")
    _unported(cfg)
    layers = _unstack(params["layers"])
    if cfg.fused_ffn:
        if cfg.fused_attn:
            def attn_fn(x, lp, cos, sin):
                return attn_block(x, lp["attn_norm"], lp["wq"], lp["wk"],
                                  lp["wv"], lp["wo"], cos, sin, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.norm_eps)
        else:
            attn_fn = maybe_remat(functools.partial(_attn_half, cfg), cfg,
                                  "attn")
        for lp in layers:
            x = attn_fn(x, lp, cos, sin)
            x = ffn_block(x, lp["mlp_norm"], lp["w_gate"], lp["w_up"],
                          lp["w_down"], cfg.norm_eps)
    else:
        layer_fn = maybe_remat(functools.partial(_layer, cfg), cfg)
        for lp in layers:
            x, layer_aux = layer_fn(x, lp, cos, sin)
            aux = aux + layer_aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def forward_with_aux(params: Dict[str, Any], tokens: torch.Tensor,
                     cfg: ModelConfig,
                     positions: Optional[torch.Tensor] = None):
    """tokens [b, s] -> (logits [b, s, vocab] float32, moe_aux scalar)."""
    x, aux = forward_features_with_aux(params, tokens, cfg, positions)
    return (x @ lm_head_weights(params, cfg)).float(), aux


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    return forward_with_aux(params, tokens, cfg, positions)[0]


def split_batch(batch: Dict[str, torch.Tensor]):
    """Normalize a batch to (inputs, targets, mask): accepts pre-shifted
    {"inputs", "targets"} or {"tokens": [b, s+1]}, optional "loss_mask"."""
    if "inputs" in batch:
        return batch["inputs"], batch["targets"], batch.get("loss_mask")
    tokens = batch["tokens"]
    mask = batch.get("loss_mask")
    return tokens[:, :-1], tokens[:, 1:], (None if mask is None
                                           else mask[:, 1:])


def token_nll(logits: torch.Tensor, targets: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL over [..., s, vocab] logits / [..., s] targets,
    masked if a [..., s] mask is given."""
    logz = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, targets[..., None].long())[..., 0]
    nll = logz - target_logit
    if mask is not None:
        maskf = mask.float()
        return (nll * maskf).sum() / maskf.sum().clamp_min(1.0)
    return nll.mean()


def chunked_token_nll(x: torch.Tensor, head: torch.Tensor,
                      targets: torch.Tensor, mask: Optional[torch.Tensor],
                      chunk: int) -> torch.Tensor:
    """Mean NLL without materializing the full [b, s, vocab] float32
    logits: each `chunk` of the sequence runs its LM-head product and
    softmax under a checkpoint, so the backward recomputes one
    [b, chunk, vocab] tile at a time."""
    b, s, _ = x.shape
    if s % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence {s}")
    maskf = (mask.float() if mask is not None
             else torch.ones(targets.shape, dtype=torch.float32,
                             device=x.device))

    def chunk_nll(x_c, t_c, m_c):
        logits = (x_c @ head).float()
        logz = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, t_c[..., None].long())[..., 0]
        return ((logz - tgt) * m_c).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        sl = slice(i, i + chunk)
        total = total + torch.utils.checkpoint.checkpoint(
            chunk_nll, x[:, sl], targets[:, sl], maskf[:, sl],
            use_reentrant=False)
    return total / maskf.sum().clamp_min(1.0)


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: ModelConfig):
    """Next-token cross entropy -> (loss, {"loss", "ntokens", "moe_aux"}).

    batch: {"tokens": [b, s+1]} (shifted here) or pre-shifted
    {"inputs": [b, s], "targets": [b, s]}; optional {"loss_mask": [b, s]}.
    """
    inputs, targets, mask = split_batch(batch)
    if cfg.loss_chunk:
        if targets.shape[-1] % cfg.loss_chunk != 0:
            raise ValueError(
                f"loss_chunk={cfg.loss_chunk} must divide the target length "
                f"{targets.shape[-1]} (note {{'tokens'}} batches lose one "
                f"position to the shift)")
        x, moe_aux = forward_features_with_aux(params, inputs, cfg)
        loss = chunked_token_nll(x, lm_head_weights(params, cfg), targets,
                                 mask, cfg.loss_chunk)
    else:
        logits, moe_aux = forward_with_aux(params, inputs, cfg)
        loss = token_nll(logits, targets, mask)
    if cfg.n_experts > 0:
        loss = loss + cfg.moe_aux_weight * moe_aux
    return loss, {"loss": loss, "ntokens": targets.numel(),
                  "moe_aux": moe_aux}
