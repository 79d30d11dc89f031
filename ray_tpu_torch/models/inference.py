"""Inference: KV-cache prefill/decode and a generate loop (twin of
ray_tpu/models/inference.py).

Prefill builds the stacked per-layer KV cache `[L, b, kvh, max_len, hd]` in
one pass; decode steps are single-token forward passes attending over the
cache, masked by position. The layer scan of the reference is a Python loop
over the stacked leaves; every cast sits where the reference has it
(float32 attention logits times the scale, a -1e30 fill, a float32 softmax
whose probabilities are cast to the query dtype before the PV product).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch.models.transformer import (ModelConfig, _deq_tree,
                                              _embed_lookup, _layer_slice,
                                              lm_head_weights)
from ray_tpu_torch.ops.layers import (apply_rotary, rms_norm,
                                      rotary_embedding, swiglu)
from ray_tpu_torch.ops.moe import moe_ffn

_NEG = -1e30


def _project_qkv(cfg: ModelConfig, p, x, cos, sin):
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    return q, k, v


def _mlp(cfg: ModelConfig, p, h):
    if cfg.n_experts > 0:
        out, _ = moe_ffn(h, p["router"], p["w_gate"], p["w_up"], p["w_down"],
                         cfg.capacity_factor)
        return out
    return swiglu(h @ p["w_gate"], h @ p["w_up"]) @ p["w_down"]


def _gqa_decode_attention(q, k_cache, v_cache, k_cur, v_cur, mask):
    """Single-token grouped-query attention over a cache window plus the
    current token's (not-yet-written) K/V row.

    q [b,h,1,hd]; k_cache/v_cache [b,kvh,Lw,hd] (a prefix window of the slot
    cache); k_cur/v_cur [b,kvh,hd]; mask [b,Lw] with True = attend (STRICT:
    the current position is not in the cache — it contributes through the
    separate k_cur/v_cur term, whose logit is concatenated last). Queries are
    grouped [b,kvh,rep,hd] against the shared K/V heads; no repeated K/V.
    """
    b, h, _, hd = q.shape
    kvh = k_cache.shape[1]
    qg = q[:, :, 0].reshape(b, kvh, h // kvh, hd)
    scale = hd ** -0.5
    lg = torch.einsum("bgrd,bgld->bgrl", qg, k_cache).float() * scale
    lg = torch.where(mask[:, None, None, :], lg, _NEG)
    self_lg = torch.einsum("bgrd,bgd->bgr", qg, k_cur).float() * scale
    lg = torch.cat([lg, self_lg[..., None]], dim=-1)
    probs = torch.softmax(lg, dim=-1).to(q.dtype)
    win = k_cache.shape[2]
    attn = (torch.einsum("bgrl,bgld->bgrd", probs[..., :win], v_cache)
            + probs[..., win:] * v_cur[:, :, None])
    return attn.reshape(b, h, hd)


def _masked_attention(q, k, v, mask):
    """q [b,h,sq,hd] over cached k/v [b,kvh,L,hd] with bool mask [sq,L]
    (or one mask per batch row, [b,sq,L])."""
    n_rep = q.shape[1] // k.shape[1]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=1)
        v = v.repeat_interleave(n_rep, dim=1)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    logits = torch.where(mask.unsqueeze(-3), logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def prefill(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, logits_index: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt; returns (logits [b, vocab] float32, cache).

    Logits come from the last position, or from `logits_index` [b] when the
    prompt is right-padded (the causal mask keeps positions < index exact).
    cache = {"k": [L,b,kvh,max_len,hd], "v": ..., "length": int32 scalar}.
    Attention reads only the s written cache rows: the reference's masked
    rows past s carry probability exactly 0.
    """
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    dev = tokens.device
    hd = cfg.head_dim
    cos, sin = rotary_embedding(torch.arange(s, device=dev), hd,
                                cfg.rope_theta)
    cos, sin = cos[None], sin[None]
    x = _embed_lookup(params["embed"], tokens, cfg.dtype)
    causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    shape = (cfg.n_layers, b, cfg.n_kv_heads, max_len, hd)
    k_all = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    v_all = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    for i in range(cfg.n_layers):
        lp = _deq_tree(_layer_slice(params["layers"], i), cfg.dtype)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, lp, h, cos, sin)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        k_all[i, :, :, :s] = k
        v_all[i, :, :, :s] = v
        attn = _masked_attention(q, k_all[i, :, :, :s], v_all[i, :, :, :s],
                                 causal)
        attn = attn.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
        x = x + (attn @ lp["wo"]).to(x.dtype)
        h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(cfg, lp, h2).to(x.dtype)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = lm_head_weights(params, cfg)
    if logits_index is None:
        sel = x[:, -1]
    else:
        sel = x[torch.arange(b, device=dev), logits_index.long()]
    logits = (sel @ head).float()
    cache = {"k": k_all, "v": v_all,
             "length": torch.full((), s, dtype=torch.int32, device=dev)}
    return logits, cache


def decode_step(params: Dict, cache: Dict, token: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One token for each batch row; returns (logits [b, vocab], cache).

    The cache's K/V tensors are updated IN PLACE (the reference returns new
    ones); the returned dict holds the same tensors and length + 1. The write
    position is clamped to max_len - 1, as the reference's
    dynamic_update_slice clamps it."""
    b = token.shape[0]
    hd = cfg.head_dim
    pos = cache["length"]
    k_all, v_all = cache["k"], cache["v"]
    max_len = k_all.shape[-2]
    dev = token.device
    cos, sin = rotary_embedding(pos[None], hd, cfg.rope_theta)
    cos, sin = cos[None], sin[None]
    x = _embed_lookup(params["embed"], token[:, None], cfg.dtype)  # [b,1,d]
    mask = (torch.arange(max_len, device=dev) <= pos)[None, :]  # [1, max_len]
    row = pos.clamp(max=max_len - 1).reshape(1).long()
    for i in range(cfg.n_layers):
        lp = _deq_tree(_layer_slice(params["layers"], i), cfg.dtype)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, lp, h, cos, sin)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        k_all[i].index_copy_(2, row, k.to(cfg.dtype))
        v_all[i].index_copy_(2, row, v.to(cfg.dtype))
        attn = _masked_attention(q, k_all[i], v_all[i], mask)
        attn = attn.transpose(1, 2).reshape(b, 1, cfg.n_heads * hd)
        x = x + (attn @ lp["wo"]).to(x.dtype)
        h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(cfg, lp, h2).to(x.dtype)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ lm_head_weights(params, cfg)).float()
    return logits, {"k": k_all, "v": v_all, "length": pos + 1}


def generate(params: Dict, prompt: torch.Tensor, cfg: ModelConfig, *,
             max_new_tokens: int = 32, max_len: int = 512,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Autoregressive generation; returns [b, prompt_len + max_new_tokens].

    temperature 0 = greedy; otherwise categorical sampling drawn from
    `generator` (a `torch.Generator` on the prompt's device)."""

    def sample(logits):
        if temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    logits, cache = prefill(params, prompt, cfg, max_len)
    out = []
    token = sample(logits)
    for n in range(max_new_tokens):
        out.append(token)
        if n + 1 < max_new_tokens:  # the last sample needs no decode step
            logits, cache = decode_step(params, cache, token, cfg)
            token = sample(logits)
    if not out:
        return prompt.clone()
    return torch.cat([prompt, torch.stack(out, dim=1).to(prompt.dtype)],
                     dim=1)
