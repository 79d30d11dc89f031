"""Continuous-batching LLM engine: slot-based KV cache, join/leave per step
(twin of ray_tpu/models/serving.py), and `LLMDeployment`, the engine behind
a Serve deployment.

Requests occupy fixed cache *slots*, so the decode step runs over static
shapes: sequences join (a batched prefill writes their KV rows into free
slots) and retire (EOS/length) between steps.

Engine = step functions over tensors + a host-side slot manager:

  * `decode_step_fused` updates the K/V caches and the lengths IN PLACE (the
    port's counterpart of the reference's buffer donation) and samples
    greedily on the device, so only a [slots] int32 token vector ever
    crosses to the host. The caches are only read inside the layer loop:
    attention covers the cache window plus the current token's own K/V under
    a STRICT `< lengths` mask, and the per-layer rows are written after the
    loop, as in the reference;
  * attention reads a power-of-2 *bucket* of the cache instead of all
    max_len rows, picked from a host-side shadow of each slot's position;
  * `step()` runs one step of *lookahead*: it dispatches step N+1 before
    syncing step N's tokens, whose copy to pinned host memory was queued
    right behind step N, so host bookkeeping overlaps device compute;
  * admission is batched: all same-bucket waiting requests prefill in ONE
    `prefill_slots` call and `_write_slots` scatters their prefix KV into
    the slot cache in place. The token vector is never written in place:
    the in-flight step's pending host copy still reads the previous one.

Device work is dispatched and waited on OUTSIDE the bookkeeping lock
(`_step_lock` serializes steppers; `_lock` only guards host-side state).
Host data reaches the device through pinned memory and asynchronous copies,
so dispatch never waits for the device.

Serve wires it through `LLMDeployment` (each serve replica hosts an engine;
the replica lifecycle hooks `__serve_start__`/`__serve_stop__` start and
stop a background driver thread, so the engine steps itself and callers
just wait on their request).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.inference import (_gqa_decode_attention,
                                            _masked_attention, _mlp,
                                            _project_qkv, prefill)
from ray_tpu_torch.models.transformer import (ModelConfig, _deq_tree,
                                              _embed_lookup, _layer_slice,
                                              lm_head_weights)
from ray_tpu_torch.ops.kernels._util import require_cuda
from ray_tpu_torch.ops.kernels.quant import quantize_int8
from ray_tpu_torch.ops.layers import rms_norm, rotary_embedding

logger = logging.getLogger(__name__)

_QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# attention never reads fewer cache rows than this — keeps the number of
# bucket variants small (64, 128, 256, ... max_len)
_ATTN_BUCKET_MIN = 64


def quantize_model_params(params: Dict, cfg: ModelConfig) -> Dict:
    """w8a16 load-time quantization: every projection matrix, the embedding
    table and the LM head become `{"int8", "scale"}` leaves with per-row
    absmax scales (the quant kernel, on the stacked leaves viewed 2-D as
    [L*in, out]). Norm vectors stay in the model dtype. The forward passes
    dequantize on read, one layer at a time."""

    def q(w):
        values, scales = quantize_int8(w)
        return {"int8": values, "scale": scales}

    out = dict(params)
    out["layers"] = {
        k: (q(v) if k in _QUANT_LEAVES else v)
        for k, v in params["layers"].items()
    }
    out["embed"] = q(params["embed"])
    if "lm_head" in params:
        out["lm_head"] = q(params["lm_head"])
    return out


def _pinned_device(device) -> torch.device:
    """`device` resolved, a bare "cuda" pinned to this thread's current card.
    The CUDA current device belongs to each thread and a new thread starts
    on card 0, so the engine keeps an index: its driver thread makes that
    card current, and its buffers and weights stay on the card the caller
    was on (in a replica, its grant's)."""
    dev = require_cuda(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _to_device(data, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host data -> device tensor without waiting for the device: staged in
    pinned memory and copied asynchronously on the current stream (the
    caching host allocator keeps the staging buffer until the copy ran). A
    plain `torch.tensor(data, device=cuda)` copies from pageable memory and
    synchronizes the stream."""
    t = torch.tensor(data, dtype=dtype)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def prefill_kv(params: Dict, tokens: torch.Tensor, true_len: torch.Tensor,
               cfg: ModelConfig, max_len: int):
    """Prompt pass for ONE right-padded request [1, s_bucket]: returns
    (logits at true_len-1 [vocab], k [L, kvh, max_len, hd], v likewise).
    The engine's admission path uses the batched `prefill_slots`; this stays
    as the single-request entry point."""
    logits, cache = prefill(params, tokens, cfg, max_len,
                            logits_index=true_len.reshape(1) - 1)
    return logits[0], cache["k"][:, 0], cache["v"][:, 0]


def prefill_slots(params: Dict, tokens: torch.Tensor, true_len: torch.Tensor,
                  cfg: ModelConfig, max_len: int):
    """Batched prompt pass over one admission bucket [nb, s_bucket]. Returns
    (first greedy tokens [nb] int32, sampled on the device, and the prefix
    caches k/v [L, nb, kvh, max_len, hd])."""
    logits, cache = prefill(params, tokens, cfg, max_len,
                            logits_index=true_len - 1)
    first = logits.argmax(dim=-1).to(torch.int32)
    return first, cache["k"], cache["v"]


def _write_slots(k_all: torch.Tensor, v_all: torch.Tensor,
                 lengths: torch.Tensor, tokens: torch.Tensor,
                 slots: Sequence[int], k_rows: torch.Tensor,
                 v_rows: torch.Tensor, true_len: torch.Tensor,
                 first: torch.Tensor):
    """Admission scatter: write a prefill bucket's KV rows into the slot
    cache in place. `slots` is a host sequence; entries outside
    [0, num_slots) are batch padding and are dropped (the reference's
    mode="drop"). `k_all`, `v_all` and `lengths` are updated in place;
    `tokens` is NOT: a new vector is returned, because the in-flight decode
    step's pending host copy still reads the previous one."""
    num_slots = k_all.shape[1]
    keep = [(row, int(s)) for row, s in enumerate(slots)
            if 0 <= int(s) < num_slots]
    tokens = tokens.clone()
    if keep:
        dev = k_all.device
        rows = _to_device([r for r, _ in keep], torch.int64, dev)
        dst = _to_device([s for _, s in keep], torch.int64, dev)
        k_all.index_copy_(1, dst, k_rows.index_select(1, rows))
        v_all.index_copy_(1, dst, v_rows.index_select(1, rows))
        lengths.index_copy_(0, dst, true_len.index_select(0, rows).to(
            lengths.dtype))
        tokens.index_copy_(0, dst, first.index_select(0, rows).to(
            tokens.dtype))
    return k_all, v_all, lengths, tokens


def _bucket_len(n: int, max_len: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return min(b, max_len - 1)


def _attn_bucket(pos: int, max_len: int) -> int:
    """Power-of-2 attention window >= the deepest active position (strict
    mask: position pos attends cache rows [0, pos))."""
    b = min(_ATTN_BUCKET_MIN, max_len)
    while b < pos:
        b *= 2
    return min(b, max_len)


def _decode_layers(params: Dict, x: torch.Tensor, cfg: ModelConfig, cos, sin,
                   attend) -> torch.Tensor:
    """The decode layer loop shared by both decode steps; `attend(i, q, k, v)`
    returns layer i's attention output [B, h, hd]."""
    B = x.shape[0]
    for i in range(cfg.n_layers):
        lp = _deq_tree(_layer_slice(params["layers"], i), cfg.dtype)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, lp, h, cos, sin)
        attn = attend(i, q.transpose(1, 2), k[:, 0].to(cfg.dtype),
                      v[:, 0].to(cfg.dtype))
        attn = attn.reshape(B, 1, cfg.n_heads * cfg.head_dim)
        x = x + (attn @ lp["wo"]).to(x.dtype)
        h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(cfg, lp, h2).to(x.dtype)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _write_rows(cache: torch.Tensor, rows: List[torch.Tensor],
                lengths: torch.Tensor) -> None:
    """cache [L, B, kvh, max_len, hd][:, b, :, pos_b] <- rows[l][b] for every
    layer l and slot b, with pos clamped to max_len - 1 (the reference's
    dynamic_update_slice clamps the start index the same way)."""
    B, max_len = cache.shape[1], cache.shape[3]
    pos = lengths.clamp(max=max_len - 1).long()
    b_idx = torch.arange(B, device=cache.device)
    cache[:, b_idx, :, pos] = torch.stack(rows, dim=1)  # [B, L, kvh, hd]


def decode_slots(params: Dict, k_all: torch.Tensor, v_all: torch.Tensor,
                 lengths: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig):
    """One decode step over all slots with per-slot positions (legacy entry
    that returns logits; the engine uses `decode_step_fused`).

    Unlike the reference this writes the new rows into k_all/v_all in place
    and returns them; the attention reads the full max_len with an
    inclusive `<= lengths` mask. Returns (logits [B, V], k_all, v_all)."""
    B = tokens.shape[0]
    hd = cfg.head_dim
    max_len = k_all.shape[-2]
    dev = tokens.device
    cos, sin = rotary_embedding(lengths[:, None], hd, cfg.rope_theta)
    x = _embed_lookup(params["embed"], tokens[:, None], cfg.dtype)
    mask = torch.arange(max_len, device=dev)[None, :] <= lengths[:, None]
    pos = lengths.clamp(max=max_len - 1).long()
    b_idx = torch.arange(B, device=dev)

    def attend(i, q, k_cur, v_cur):
        k_all[i, b_idx, :, pos] = k_cur
        v_all[i, b_idx, :, pos] = v_cur
        return _masked_attention(q, k_all[i], v_all[i], mask[:, None])[:, :, 0]

    x = _decode_layers(params, x, cfg, cos, sin, attend)
    logits = (x[:, 0] @ lm_head_weights(params, cfg)).float()
    return logits, k_all, v_all


def decode_step_fused(params: Dict, k_all: torch.Tensor, v_all: torch.Tensor,
                      lengths: torch.Tensor, tokens: torch.Tensor,
                      cfg: ModelConfig, attn_len: int):
    """The hot decode step: one token for every slot, greedy sampling on the
    device, K/V/length buffers updated IN PLACE.

    The caches are only read inside the layer loop: attention splits into
    (cache window [:attn_len]) + (the current token's own K/V, not written
    yet — STRICT mask `< lengths`), and the per-layer K/V rows are written
    after the loop. `attn_len` is a power-of-2 bucket >= every active
    position. Every slot writes a row, free ones included; positions past
    max_len clamp to the last row, as in the reference.

    Returns (k_all, v_all, lengths (now +1), next_tokens [B] int32).
    `tokens` is not modified."""
    hd = cfg.head_dim
    dev = tokens.device
    cos, sin = rotary_embedding(lengths[:, None], hd, cfg.rope_theta)
    x = _embed_lookup(params["embed"], tokens[:, None], cfg.dtype)  # [B,1,d]
    mask = torch.arange(attn_len, device=dev)[None, :] < lengths[:, None]
    k_rows: List[torch.Tensor] = []
    v_rows: List[torch.Tensor] = []

    def attend(i, q, k_cur, v_cur):
        k_rows.append(k_cur)
        v_rows.append(v_cur)
        return _gqa_decode_attention(
            q, k_all[i, :, :, :attn_len], v_all[i, :, :, :attn_len],
            k_cur, v_cur, mask)

    x = _decode_layers(params, x, cfg, cos, sin, attend)
    _write_rows(k_all, k_rows, lengths)
    _write_rows(v_all, v_rows, lengths)
    logits = (x[:, 0] @ lm_head_weights(params, cfg)).float()
    nxt = logits.argmax(dim=-1).to(torch.int32)
    lengths.add_(1)
    return k_all, v_all, lengths, nxt


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class _HostCopy:
    """A device tensor on its way to the host: the copy into pinned memory
    is queued on the stream right behind the work that produced it, so
    waiting for it never waits for work dispatched later."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event: Optional[torch.cuda.Event] = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t
            self.event = None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@dataclasses.dataclass
class _Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False


class ContinuousBatchingEngine:
    """Host-side slot manager over the prefill/decode step functions.

    Locking: `_step_lock` serializes steppers (at most one step pipeline in
    flight); `_lock` guards only host bookkeeping and is NEVER held across a
    dispatch or a device wait — `progress()` reads and `submit()` complete
    while a step issues its kernels or waits on the device. Only the
    stepping thread touches the device buffers (k, v, lengths, tokens).
    `_cv` (on `_lock`) wakes waiters when tokens land and wakes the driver
    thread when work arrives.

    `params` must already live on `device`. `prefill_calls` and
    `decode_steps` count the forward passes dispatched.
    """

    def __init__(self, params: Dict, cfg: ModelConfig, *, num_slots: int = 4,
                 max_len: int = 512, eos_token: Optional[int] = None,
                 quantize_weights: bool = False, device="cuda"):
        self.device = _pinned_device(device)
        emb = params["embed"]
        emb_dev = (emb["int8"] if isinstance(emb, dict) else emb).device
        if emb_dev != self.device:
            raise ValueError(f"params live on {emb_dev}, engine device is "
                             f"{self.device}")
        if quantize_weights:
            params = quantize_model_params(params, cfg)
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos_token = eos_token
        L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        shape = (L, num_slots, kvh, max_len, hd)
        self.k = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.lengths = torch.zeros((num_slots,), dtype=torch.int32,
                                   device=self.device)
        self.tokens = torch.zeros((num_slots,), dtype=torch.int32,
                                  device=self.device)
        self.prefill_calls = 0
        self.decode_steps = 0
        self._free = list(range(num_slots))
        self._active: Dict[int, _Request] = {}   # slot -> request
        self._waiting: List[_Request] = []
        self._finished: Dict[int, _Request] = {}
        self._next_id = 0
        # host shadow of each slot's position: picks the attention bucket
        # without ever syncing `lengths` off the device
        self._slot_pos = [0] * num_slots
        # in-flight decode: (host copy of tokens [B], {slot: request}
        # captured at dispatch — attribution survives slot reuse)
        self._pending: Optional[Tuple[_HostCopy, Dict[int, _Request]]] = None
        # admissions whose first token hasn't been synced yet
        self._pending_first: List[Tuple[_HostCopy,
                                        List[Tuple[int, _Request]]]] = []
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._step_lock = threading.Lock()
        self._driver: Optional[threading.Thread] = None
        self._driver_stop = False
        self._driver_error: Optional[BaseException] = None

    # ------------------------------------------------------------- requests
    def submit(self, prompt: List[int], *, max_new_tokens: int = 32) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_len - 1:
            raise ValueError(
                f"prompt length {len(prompt)} must be < max_len-1 = "
                f"{self.max_len - 1}")
        with self._lock:
            req = _Request(self._next_id, list(prompt), max_new_tokens)
            self._next_id += 1
            self._waiting.append(req)
            self._cv.notify_all()
            return req.request_id

    def _maybe_finish(self, req: _Request) -> None:
        hit_eos = self.eos_token is not None and req.generated and \
            req.generated[-1] == self.eos_token
        out_of_room = len(req.prompt) + len(req.generated) >= self.max_len - 1
        if len(req.generated) >= req.max_new_tokens or hit_eos or out_of_room:
            req.done = True
            if req.slot >= 0:
                self._active.pop(req.slot, None)
                self._free.append(req.slot)
                self._slot_pos[req.slot] = 0
                req.slot = -1
            self._finished[req.request_id] = req

    # ----------------------------------------------------------------- step
    @staticmethod
    def _to_host(pending: _HostCopy) -> np.ndarray:
        """THE host sync point (device wait). Routed through one method so
        tests can instrument it; always called WITHOUT `_lock` held."""
        return pending.numpy()

    def step(self) -> int:
        """Admit waiting requests (batched, bucketed), dispatch the next
        decode step, then sync + bookkeep the PREVIOUS step's tokens while
        the new one runs on the device. Returns sequences still active."""
        with self._step_lock:
            return self._step_inner()

    def _step_inner(self) -> int:
        with self._lock:
            admissions = self._collect_admissions()
        for bucket, reqs in admissions:
            self._dispatch_prefill(bucket, reqs)      # device enqueue only
        with self._lock:
            prev = self._pending
            plan = self._plan_decode()
        pending = self._dispatch_decode(*plan) if plan else None  # no _lock
        with self._lock:
            self._pending = pending
        self._drain_pending_first()                   # device wait, no _lock
        self._reap(prev)                              # device wait, no _lock
        with self._lock:
            return len(self._active) + len(self._waiting)

    def _collect_admissions(self):
        """Pop waiting requests into free slots, grouped by prompt bucket
        (one batched prefill per bucket). Caller holds `_lock`."""
        by_bucket: Dict[int, List[_Request]] = {}
        while self._waiting and self._free:
            req = self._waiting.pop(0)
            slot = self._free.pop()
            req.slot = slot
            self._active[slot] = req
            self._slot_pos[slot] = len(req.prompt)
            bucket = _bucket_len(len(req.prompt), self.max_len)
            by_bucket.setdefault(bucket, []).append(req)
        return sorted(by_bucket.items())

    def _dispatch_prefill(self, bucket: int, reqs: List[_Request]) -> None:
        """ONE `prefill_slots` call for every same-bucket admission; the
        prefix KV goes straight into the slot cache. The batch is padded to
        a power of 2 (padding rows name an out-of-range slot and are
        dropped). First tokens stay on the device until bookkeeping."""
        rows = [r.prompt + [0] * (bucket - len(r.prompt)) for r in reqs]
        lens = [len(r.prompt) for r in reqs]
        slots = [r.slot for r in reqs]
        for _ in range(_pow2(len(reqs)) - len(reqs)):
            rows.append([0] * bucket)
            lens.append(1)
            slots.append(self.num_slots)  # out of range -> dropped
        true_len = _to_device(lens, torch.int32, self.device)
        first, k_rows, v_rows = prefill_slots(
            self.params, _to_device(rows, torch.int32, self.device),
            true_len, self.cfg, self.max_len)
        self.prefill_calls += 1
        self.k, self.v, self.lengths, self.tokens = _write_slots(
            self.k, self.v, self.lengths, self.tokens, slots, k_rows, v_rows,
            true_len, first)
        self._pending_first.append(
            (_HostCopy(first), [(i, r) for i, r in enumerate(reqs)]))

    def _plan_decode(self):
        """The next decode step's attention bucket and its dispatch-time
        active set (tokens are attributed correctly even if a slot retires
        and is re-admitted before the sync); advances the position shadow.
        Caller holds `_lock`. None when no slot is active."""
        if not self._active:
            return None
        attn_len = _attn_bucket(
            max(self._slot_pos[s] for s in self._active), self.max_len)
        slot_map = dict(self._active)
        for s in slot_map:
            self._slot_pos[s] += 1
        return attn_len, slot_map

    def _dispatch_decode(self, attn_len: int, slot_map: Dict[int, _Request]):
        """Dispatch one fused decode step (no device wait). Runs on the
        stepping thread WITHOUT `_lock`: issuing its kernels takes
        milliseconds of host time."""
        self.k, self.v, self.lengths, tokens_out = decode_step_fused(
            self.params, self.k, self.v, self.lengths, self.tokens,
            self.cfg, attn_len)
        self.decode_steps += 1
        self.tokens = tokens_out
        return _HostCopy(tokens_out), slot_map

    def _drain_pending_first(self) -> None:
        """Sync admissions' first tokens (deferred from dispatch so prefill
        overlaps the decode step queued behind it)."""
        if not self._pending_first:
            return
        batches, self._pending_first = self._pending_first, []
        for first_dev, entries in batches:
            first = self._to_host(first_dev)  # device wait — no _lock held
            with self._lock:
                for row, req in entries:
                    req.generated.append(int(first[row]))
                    self._maybe_finish(req)
                self._cv.notify_all()

    def _reap(self, prev) -> None:
        """Sync + bookkeep a previously dispatched step's tokens. Runs
        while the NEXT step computes on the device (one-step lookahead)."""
        if prev is None:
            return
        tokens_dev, slot_map = prev
        nxt = self._to_host(tokens_dev)  # device wait — no _lock held
        with self._lock:
            for slot, req in slot_map.items():
                if req.done:
                    continue  # finished at dispatch+1; this token is junk
                req.generated.append(int(nxt[slot]))
                self._maybe_finish(req)
            self._cv.notify_all()

    def run_until_done(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self._waiting:
                return

    # ------------------------------------------------------- driver thread
    def start_driver(self) -> None:
        """Background thread that steps the engine whenever there is work:
        callers then just `submit()` and `wait()`/stream."""
        with self._lock:
            if self._driver is not None:
                return
            self._driver_stop = False
            self._driver_error = None
            self._driver = threading.Thread(
                target=self._drive, name="engine-driver", daemon=True)
            self._driver.start()

    def stop_driver(self, timeout: float = 5.0) -> None:
        with self._lock:
            t = self._driver
            if t is None:
                return
            self._driver_stop = True
            self._cv.notify_all()
        t.join(timeout)
        with self._lock:
            self._driver = None

    def _has_work(self) -> bool:
        return bool(self._waiting or self._active or self._pending
                    or self._pending_first)

    def _drive(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # a new thread is on card 0
        while True:
            with self._lock:
                while not self._driver_stop and not self._has_work():
                    self._cv.wait(0.1)
                if self._driver_stop:
                    return
            try:
                self.step()
            except Exception as e:  # surface to waiters instead of hanging
                logger.exception("engine driver thread died")
                with self._lock:
                    self._driver_error = e
                    self._driver = None
                    self._cv.notify_all()
                return

    # -------------------------------------------------------------- results
    def _result_locked(self, req: _Request) -> List[int]:
        toks = req.prompt + req.generated
        if self.eos_token is not None and toks and toks[-1] == self.eos_token:
            toks = toks[:-1]
        return toks

    def result(self, request_id: int) -> Optional[List[int]]:
        with self._lock:
            req = self._finished.get(request_id)
            if req is None:
                return None
            return self._result_locked(req)

    def wait(self, request_id: int,
             timeout: Optional[float] = None) -> List[int]:
        """Block until `request_id` finishes (driver mode). Raises if the
        driver died or the timeout expires."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while request_id not in self._finished:
                if self._driver_error is not None:
                    raise self._driver_error
                if self._driver is None and not self._has_work():
                    raise RuntimeError(
                        "engine has no driver and no work in flight; "
                        "call step() or start_driver()")
                remaining = 0.1 if deadline is None else \
                    min(0.1, deadline - time.monotonic())
                if remaining <= 0:
                    raise TimeoutError(
                        f"request {request_id} not done within {timeout}s")
                self._cv.wait(remaining)
            return self._result_locked(self._finished[request_id])

    def _progress_locked(self, request_id: int):
        req = self._finished.get(request_id)
        if req is not None:
            toks = list(req.generated)
            if (self.eos_token is not None and toks
                    and toks[-1] == self.eos_token):
                toks.pop()
            return toks, True
        for req in list(self._active.values()) + self._waiting:
            if req.request_id == request_id:
                return list(req.generated), req.done
        return [], True  # unknown id

    def progress(self, request_id: int):
        """(tokens generated so far, done) — readable while decoding, for
        token streaming. A trailing EOS is stripped, so streamed output
        always equals the non-streamed suffix."""
        with self._lock:
            return self._progress_locked(request_id)

    def generate(self, prompt: List[int], *, max_new_tokens: int = 32,
                 timeout: Optional[float] = None) -> List[int]:
        rid = self.submit(prompt, max_new_tokens=max_new_tokens)
        if self._driver is not None:
            return self.wait(rid, timeout=timeout)
        while self.result(rid) is None:
            if self.step() == 0 and self.result(rid) is None and \
                    not self._waiting:
                break
        return self.result(rid) or []

    def generate_stream(self, prompt: List[int], *,
                        max_new_tokens: int = 32):
        """Generator yielding tokens AS DECODED (continuous batching keeps
        serving other slots between yields)."""
        rid = self.submit(prompt, max_new_tokens=max_new_tokens)
        emitted = 0
        if self._driver is not None:
            while True:
                with self._lock:
                    while True:
                        toks, done = self._progress_locked(rid)
                        if len(toks) > emitted or done:
                            break
                        if self._driver_error is not None:
                            raise self._driver_error
                        self._cv.wait(0.2)
                while emitted < len(toks):  # yield OUTSIDE the lock
                    yield int(toks[emitted])
                    emitted += 1
                if done:
                    return
        while True:
            active = self.step()
            toks, done = self.progress(rid)
            while emitted < len(toks):
                yield int(toks[emitted])
                emitted += 1
            if done:
                return
            if active == 0:
                return  # nothing left anywhere; request never finished


def _tree_to(tree, device: torch.device):
    """`tree` (nested dicts of tensors) with every tensor on `device`."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def LLMDeployment(params, cfg: ModelConfig, *, num_slots: int = 4,
                  max_len: int = 512, eos_token: Optional[int] = None,
                  quantize_weights: bool = False, device="cuda"):
    """A serve-ready callable class hosting one engine per replica.

    Usage:
        from ray_tpu_torch import serve
        D = serve.deployment(LLMDeployment(params, cfg),
                             ray_actor_options={"num_gpus": 1})
        handle = serve.run(D.bind())
        handle.remote({"prompt": [1, 2, 3], "max_new_tokens": 8})

    The class closes over the weights as host (CPU) tensors, wherever
    `params` lives: the deployment's definition is pickled to the replica,
    and a pickled CUDA tensor would come back on the driver's device index,
    not on the card the replica was granted. Each replica's engine puts
    them on `device`; "cuda" is the card current in the replica's
    `__init__`, which the runtime sets to its grant's (`num_gpus=1`), and
    the engine keeps that index for its driver thread. Raises here, as every
    entry point of the port does, when `device` names CUDA and there is
    none (pass device="cpu").

    Inside a replica the `__serve_start__` lifecycle hook starts the
    engine's background driver thread, so concurrent requests all ride one
    continuously-batched decode loop (each caller blocks only on its own
    request); standalone (no hook) the engine self-steps in the caller.
    """
    require_cuda(device)
    host = _tree_to(params, torch.device("cpu"))

    class _LLM:
        def __init__(self):
            dev = _pinned_device(device)
            self.engine = ContinuousBatchingEngine(
                _tree_to(host, dev), cfg, num_slots=num_slots,
                max_len=max_len, eos_token=eos_token,
                quantize_weights=quantize_weights, device=dev)

        def __serve_start__(self):
            self.engine.start_driver()

        def __serve_stop__(self):
            self.engine.stop_driver()

        def __call__(self, payload):
            prompt = list(payload["prompt"])
            n = int(payload.get("max_new_tokens", 32))
            return self.engine.generate(prompt, max_new_tokens=n)

        def stream(self, payload):
            """Streaming entry: call through a stream handle
            (`handle.options(method_name='stream', stream=True)`) or HTTP
            `POST /<name>/stream?stream=1` — tokens arrive as generated."""
            prompt = list(payload["prompt"])
            n = int(payload.get("max_new_tokens", 32))
            yield from self.engine.generate_stream(prompt, max_new_tokens=n)

    _LLM.__name__ = "LLMDeployment"
    return _LLM
