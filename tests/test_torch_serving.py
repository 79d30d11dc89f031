"""models/serving: the port's step functions and engine against
ray_tpu/models/serving.py at the tiny float32 config.

Step functions: first/next tokens equal, caches within 1e-5. Engine: every
scenario yields the same tokens as the JAX engine given the same parameters,
`tiny_moe` ones included (their routing margins asserted as in
test_torch_moe.py).
"""

import functools
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import ModelConfig as JaxConfig
from ray_tpu.models import init_params as jax_init_params
from ray_tpu.models import serving as jsrv
from ray_tpu_torch.bridge import params_from_jax
from ray_tpu_torch.models import ModelConfig
from ray_tpu_torch.models import serving as tsrv
from ray_tpu_torch.models import servebench
from ray_tpu_torch.ops import moe as tmoe
from test_torch_moe import MARGIN, margins

JCFG, CFG = JaxConfig.tiny(), ModelConfig.tiny()
JCFG_MOE, CFG_MOE = JaxConfig.tiny_moe(), ModelConfig.tiny_moe()
MAX_LEN = 64
RNG = np.random.default_rng(5)


@functools.lru_cache(maxsize=None)
def _params(moe=False):
    jcfg, cfg = (JCFG_MOE, CFG_MOE) if moe else (JCFG, CFG)
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                         device="cpu")
    return jp, tp


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _cache(batch, max_len=MAX_LEN):
    shape = (CFG.n_layers, batch, CFG.n_kv_heads, max_len, CFG.head_dim)
    return RNG.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ step functions


def test_prefill_slots_matches_reference():
    jp, tp = _params()
    tokens = RNG.integers(0, CFG.vocab_size, (4, 16)).astype(np.int32)
    true_len = np.array([16, 3, 9, 1], np.int32)
    jf, jk, jv = jsrv.prefill_slots(jp, jnp.asarray(tokens),
                                    jnp.asarray(true_len), JCFG, MAX_LEN)
    tf, tk, tv = tsrv.prefill_slots(tp, torch.from_numpy(tokens),
                                    torch.from_numpy(true_len), CFG, MAX_LEN)
    assert tf.dtype == torch.int32
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    _close(tk, jk, 1e-5)
    _close(tv, jv, 1e-5)
    logits, k1, v1 = tsrv.prefill_kv(tp, torch.from_numpy(tokens[1:2]),
                                     torch.tensor(3), CFG, MAX_LEN)
    assert int(logits.argmax()) == int(tf[1])
    _close(k1, jk[:, 1], 1e-5)


@pytest.mark.parametrize("attn_len, lengths", [
    (64, [0, 5, 40, 17]),
    (MAX_LEN, [3, MAX_LEN + 3, 63, 0]),   # one freed slot past max_len
    (128, [100, 2, 127, 64]),
])
def test_decode_step_fused_matches_reference(attn_len, lengths):
    jp, tp = _params()
    max_len = max(MAX_LEN, attn_len)
    k, v = _cache(4, max_len), _cache(4, max_len)
    lengths = np.array(lengths, np.int32)
    tokens = RNG.integers(0, CFG.vocab_size, (4,)).astype(np.int32)
    jk, jv, jl, jn = jsrv.decode_step_fused(
        jp, jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray(tokens), JCFG, attn_len)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tl, tt = torch.from_numpy(lengths.copy()), torch.from_numpy(tokens)
    ptrs = (tk.data_ptr(), tv.data_ptr(), tl.data_ptr())
    ok, ov, ol, on = tsrv.decode_step_fused(tp, tk, tv, tl, tt, CFG, attn_len)
    assert (ok.data_ptr(), ov.data_ptr(), ol.data_ptr()) == ptrs  # in place
    assert torch.equal(tt, torch.from_numpy(tokens))  # tokens untouched
    np.testing.assert_array_equal(on.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ol.numpy(), np.asarray(jl))
    _close(ok, jk, 1e-5)
    _close(ov, jv, 1e-5)


def test_decode_slots_matches_reference():
    jp, tp = _params()
    k, v = _cache(3), _cache(3)
    lengths = np.array([4, 0, MAX_LEN + 1], np.int32)
    tokens = RNG.integers(0, CFG.vocab_size, (3,)).astype(np.int32)
    jlog, jk, jv = jsrv.decode_slots(jp, jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(lengths),
                                     jnp.asarray(tokens), JCFG)
    tlog, tk, tv = tsrv.decode_slots(
        tp, torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
        torch.from_numpy(lengths), torch.from_numpy(tokens), CFG)
    _close(tlog, jlog, 1e-4)
    _close(tk, jk, 1e-5)
    _close(tv, jv, 1e-5)


def test_write_slots_drops_padding_rows():
    num_slots = 3
    k, v = _cache(num_slots), _cache(num_slots)
    k_rows, v_rows = _cache(4), _cache(4)
    lengths = np.array([7, 8, 9], np.int32)
    tokens = np.array([1, 2, 3], np.int32)
    slots = [2, 0, num_slots, num_slots]  # two real rows, two padding rows
    true_len = np.array([5, 6, 1, 1], np.int32)
    first = np.array([40, 41, 42, 43], np.int32)
    want = jsrv._write_slots(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray(tokens), jnp.asarray(slots, jnp.int32),
        jnp.asarray(k_rows), jnp.asarray(v_rows), jnp.asarray(true_len),
        jnp.asarray(first))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tl, tt = torch.from_numpy(lengths.copy()), torch.from_numpy(tokens.copy())
    got = tsrv._write_slots(tk, tv, tl, tt, slots, torch.from_numpy(k_rows),
                            torch.from_numpy(v_rows),
                            torch.from_numpy(true_len),
                            torch.from_numpy(first))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0] is tk and got[1] is tv and got[2] is tl  # in place
    assert got[3] is not tt  # the token vector is never written in place
    np.testing.assert_array_equal(tt.numpy(), tokens)


# ------------------------------------------------------------------ engine


def _single(eng):
    return [eng.generate([5, 17, 400, 3], max_new_tokens=8)]


def _interleaved(eng):
    r1 = eng.submit([1, 2, 3], max_new_tokens=10)
    eng.step()
    eng.step()
    r2 = eng.submit([100, 200, 300, 400, 17], max_new_tokens=6)
    eng.step()
    r3 = eng.submit([7], max_new_tokens=4)
    eng.run_until_done()
    return [eng.result(r) for r in (r1, r2, r3)]


def _more_than_slots(eng):
    rids = [eng.submit([i + 1, i + 2], max_new_tokens=5) for i in range(5)]
    eng.run_until_done()
    return [eng.result(r) for r in rids]


def _eos(eng):
    return [eng.generate([9, 8, 7], max_new_tokens=16),
            eng.generate([1, 2, 3], max_new_tokens=16)]


def _bucketed(eng):
    prompts = [[1, 2, 3], [4, 5], list(range(40, 51)), [9]]
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.step()
    with eng._lock:  # one step admitted everything
        assert len(eng._active) == 4 and not eng._waiting
    eng.run_until_done()
    return [eng.result(r) for r in rids]


def _stream(eng):
    return [[5, 17, 400, 3] + list(eng.generate_stream([5, 17, 400, 3],
                                                       max_new_tokens=8))]


def _driver(eng):
    eng.start_driver()
    try:
        prompts = [[1, 2, 3], [100, 200, 300, 400, 17], [7], [9, 8]]
        with ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(eng.generate, p, max_new_tokens=6, timeout=120)
                    for p in prompts]
            outs = [f.result(timeout=120) for f in futs]
        outs.append([5, 6] + list(eng.generate_stream([5, 6],
                                                      max_new_tokens=5)))
        return outs
    finally:
        eng.stop_driver()


def _eight_slots(eng):
    """Eight requests decoding together: with 4 experts at capacity factor
    1.25 a decode step's 8 rows fit 2 tokens an expert, so at least half of
    the 16 top-2 assignments drop, in both packages alike."""
    rids = [eng.submit([3 * i + 1, 3 * i + 2, 3 * i + 3, i + 40],
                       max_new_tokens=6) for i in range(8)]
    eng.run_until_done()
    return [eng.result(r) for r in rids]


SCENARIOS = {
    # name: (run, engine kwargs; moe=True serves tiny_moe)
    "single": (_single, dict(num_slots=2)),
    "interleaved": (_interleaved, dict(num_slots=4)),
    "more_than_slots": (_more_than_slots, dict(num_slots=2)),
    "eos": (_eos, dict(num_slots=2)),
    "bucketed": (_bucketed, dict(num_slots=4)),
    "stream": (_stream, dict(num_slots=2)),
    "driver": (_driver, dict(num_slots=4)),
    "quantized": (_single, dict(num_slots=2, quantize_weights=True)),
    "moe_interleaved": (_interleaved, dict(num_slots=4, moe=True)),
    "moe_eight_slots": (_eight_slots, dict(num_slots=8, moe=True)),
    "moe_quantized": (_single, dict(num_slots=2, quantize_weights=True,
                                    moe=True)),
}


@functools.lru_cache(maxsize=None)
def _eos_token():
    """The third greedy token after [9, 8, 7]: EOS fires mid-generation."""
    jp, _ = _params()
    eng = jsrv.ContinuousBatchingEngine(jp, JCFG, num_slots=2,
                                        max_len=MAX_LEN)
    return eng.generate([9, 8, 7], max_new_tokens=3)[-1]


def _kwargs(name):
    kw = dict(SCENARIOS[name][1], max_len=MAX_LEN)
    kw.pop("moe", None)
    if name == "eos":
        kw["eos_token"] = _eos_token()
    return kw


def _moe(name):
    return SCENARIOS[name][1].get("moe", False)


@functools.lru_cache(maxsize=None)
def _jax_outputs(name):
    jp, _ = _params(_moe(name))
    return SCENARIOS[name][0](jsrv.ContinuousBatchingEngine(
        jp, JCFG_MOE if _moe(name) else JCFG, **_kwargs(name)))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_jax_engine(monkeypatch, name):
    _, tp = _params(_moe(name))
    routed = []
    real = tmoe.top2_gating

    def recording(logits, capacity):
        out = real(logits, capacity)
        routed.append((logits.detach().clone(), int(out[0].sum())))
        return out

    monkeypatch.setattr(tmoe, "top2_gating", recording)
    eng = tsrv.ContinuousBatchingEngine(tp, CFG_MOE if _moe(name) else CFG,
                                        device="cpu", **_kwargs(name))
    got = SCENARIOS[name][0](eng)
    assert got == _jax_outputs(name)
    if name == "eos":
        assert len(got[0]) == 3 + 2  # stopped at the EOS, which is stripped
    assert bool(routed) == _moe(name)
    for logits, _ in routed:
        assert margins(logits) > MARGIN, "a near tie in the router"
    if name == "moe_eight_slots":  # decode steps over 8 rows drop tokens
        assert any(len(lg) == 8 and kept < 16 for lg, kept in routed)


def test_engine_validates_prompts():
    _, tp = _params()
    eng = tsrv.ContinuousBatchingEngine(tp, CFG, num_slots=2, max_len=MAX_LEN,
                                        device="cpu")
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(list(range(MAX_LEN)))
    with pytest.raises(ValueError, match="empty"):
        eng.submit([])
    with pytest.raises(ValueError, match="params live on"):
        tsrv.ContinuousBatchingEngine({"embed": torch.zeros(1, 1,
                                                            device="meta")},
                                      CFG, device="cpu")


def test_cache_buffers_stay_in_place_across_steps():
    """The counterpart of the reference's donation: stepping never
    reallocates the caches or the lengths, and the token vector is a new
    tensor each step (the pending host copy reads the old one)."""
    _, tp = _params()
    eng = tsrv.ContinuousBatchingEngine(tp, CFG, num_slots=2, max_len=MAX_LEN,
                                        device="cpu")
    eng.submit([5, 17, 400, 3], max_new_tokens=40)
    eng.step()
    ptrs = (eng.k.data_ptr(), eng.v.data_ptr(), eng.lengths.data_ptr())
    for _ in range(10):
        tokens = eng.tokens
        eng.step()
        assert (eng.k.data_ptr(), eng.v.data_ptr(),
                eng.lengths.data_ptr()) == ptrs
        assert eng.tokens is not tokens


def test_progress_and_submit_not_blocked_during_step(monkeypatch):
    """Only `_step_lock` is held across the decode dispatch and the host
    sync: `progress()` and `submit()` complete while a step is blocked
    issuing its kernels (inside `decode_step_fused`) or in `_to_host`."""
    import time

    _, tp = _params()
    eng = tsrv.ContinuousBatchingEngine(tp, CFG, num_slots=2, max_len=MAX_LEN,
                                        device="cpu")
    rid = eng.submit([1, 2, 3], max_new_tokens=12)
    eng.step()
    eng.step()
    rids = []

    def blocking(fn):
        entered, release = threading.Event(), threading.Event()

        def slow(*args, **kwargs):
            entered.set()
            release.wait(5.0)
            return fn(*args, **kwargs)

        return slow, entered, release

    for where in ("dispatch", "to_host"):
        with monkeypatch.context() as m:
            if where == "dispatch":
                slow, entered, release = blocking(tsrv.decode_step_fused)
                m.setattr(tsrv, "decode_step_fused", slow)
            else:
                slow, entered, release = blocking(
                    tsrv.ContinuousBatchingEngine._to_host)
                m.setattr(eng, "_to_host", slow, raising=False)
            stepper = threading.Thread(target=eng.step)
            stepper.start()
            try:
                assert entered.wait(5.0), f"step never reached {where}"
                t0 = time.perf_counter()
                _, done = eng.progress(rid)
                rids.append(eng.submit([4, 5], max_new_tokens=4))
                assert time.perf_counter() - t0 < 0.5, where
                assert not done
            finally:
                release.set()
                stepper.join(10.0)
            assert not stepper.is_alive()
    eng.run_until_done()
    assert len(eng.result(rid)) == 3 + 12
    for r in rids:
        assert len(eng.result(r)) == 2 + 4


def test_servebench_rows_on_cpu():
    _, tp = _params()
    dec = servebench.measure_decode(tp, CFG, num_slots=2, max_len=MAX_LEN,
                                    steps=3, warm_steps=2, device="cpu")
    assert dec["num_slots"] == 2 and dec["decode_tokens_per_s"] > 0
    pre = servebench.measure_prefill(tp, CFG, max_len=MAX_LEN, bucket=8,
                                     batch=2, iters=1, device="cpu")
    assert pre["prefill_tokens_per_s"] > 0
    par = servebench.measure_quant_parity(tp, CFG, max_len=MAX_LEN,
                                          device="cpu")
    assert par["logits_parity_ok"], par
    assert par["weight_bytes_ratio"] < 0.3  # float32 -> int8 + row scales
    prof = servebench.profile_decode(tp, CFG, num_slots=2, max_len=MAX_LEN,
                                     steps=2, warm_steps=1, device="cpu")
    assert prof["steps"] == 2 and prof["ms_per_step"] > 0
    assert 0 <= prof["device_idle_share"] <= 1
