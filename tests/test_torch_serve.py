"""The port's pooled serving path against the JAX package at
``tiny_model_config`` widths, float32, in the order the path was ported:

1. ``streaming_chunk_mask`` with one block size per row: equal.
2. ``wav2vec2.chunk_step`` / ``speech_llm.encode_chunk`` with mixed
   ``row_frames``: within 1e-5 of max|out| (float32 sums in another
   order); a row with 0 frames keeps its encoder state bit for bit.
3. The plain ``decode_attention`` with a cache shared by each group of
   B / Bc query rows: bitwise equal to the same call with each cache
   repeated, and within 1e-5 of the JAX reference per slot.
4. ``beam_token_step`` over a pool of prefixes against the JAX step run
   slot by slot: logits and the K/V written within 1e-5 of max.
5. ``batched_beam_search(return_kv=True)`` against JAX's: tokens,
   lengths, EOS flags, steps and the winners' K/V, with per-slot step caps.
6. ``ServingEngine`` against the JAX engine on the settings of
   ``tests/test_serve.py``: every slot's tokens, cache length, the host
   valid_len and the eviction count equal after every tick (beam 2 with a
   mixed (1, 2) pool, a multiplier switch, a close and reopen; beam 1 and
   beam 2 with trims), and a step that raises keeps the deferred trim.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.core import masks as JM
from infinisst_tpu.core.config import StreamConfig as JStream
from infinisst_tpu.data.template import PromptBuilder as JPB
from infinisst_tpu.data.template import StubTokenizer as JST
from infinisst_tpu.decode import beam as JB
from infinisst_tpu.kernels import decode_attention as JA
from infinisst_tpu.models import llama as JL
from infinisst_tpu.models import speech_llm as JSL
from infinisst_tpu.models import wav2vec2 as JW
from infinisst_tpu.serve.engine import ServingEngine as JEngine
from infinisst_tpu.streaming import state as JS
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core import config as TC
from infinisst_tpu_torch.core import masks as TM
from infinisst_tpu_torch.core.config import CONV_LEFT_CONTEXT
from infinisst_tpu_torch.core.rope import llama_rope_freqs
from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
from infinisst_tpu_torch.decode import beam as TB
from infinisst_tpu_torch.kernels import decode_attention as TA
from infinisst_tpu_torch.models import llama as TL
from infinisst_tpu_torch.models import speech_llm as TSL
from infinisst_tpu_torch.models import wav2vec2 as TW
from infinisst_tpu_torch.serve import engine as TE
from infinisst_tpu_torch.streaming import state as TS
from tests.test_agent import CFG, small_special_tokens, tiny_params

torch.set_num_threads(1)

TCFG = TC.tiny_model_config(vocab_size=512).replace(
    tokens=TC.SpecialTokens(**small_special_tokens().__dict__))
JCFG = CFG.replace(tokens=small_special_tokens())
UNIT = 15360  # samples of one 960 ms unit
RTOL = 1e-5  # float32 on both sides, sums in another order


def _close(got, want, rtol=RTOL):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = np.abs(g - w).max()
    assert err <= rtol * np.abs(w).max(), (err, np.abs(w).max())


_PARAMS = {}


def _params():
    if not _PARAMS:
        jp = tiny_params()
        _PARAMS["jax"] = jp
        _PARAMS["torch"] = from_jax(jax.device_get(jp), device="cpu")
    return _PARAMS["jax"], _PARAMS["torch"]


def test_streaming_chunk_mask_per_row_blocks():
    """Per-row block sizes (0 counts as 1), per-row prefixes."""
    prefix = np.asarray([0, 50, 130, 7], np.int32)
    blocks = np.asarray([48, 96, 0, 48], np.int32)
    want = JM.streaming_chunk_mask(96, jnp.asarray(prefix), 96,
                                   jnp.asarray(blocks), 96 + 96)
    got = TM.streaming_chunk_mask(96, torch.from_numpy(prefix), 96,
                                  torch.from_numpy(blocks), 96 + 96)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one int block size keeps its old result
    np.testing.assert_array_equal(
        TM.streaming_chunk_mask(96, torch.from_numpy(prefix), 96, 48,
                                192).numpy(),
        np.asarray(JM.streaming_chunk_mask(96, jnp.asarray(prefix), 96, 48,
                                           192)))


def test_chunk_step_and_encode_chunk_with_row_frames():
    """Two rows at m_max = 2 over three chunks: row 0 at m = 1 (48
    frames a chunk), row 1 at m = 2 that sits the second chunk out (96, 0,
    96 frames); both 96-frame rings wrap."""
    jp, tp = _params()
    w = CFG.w2v2
    B, cache, chunk_frames = 2, 96, 96
    js = JS.init_encoder_state(w.encoder_layers, B, cache,
                               w.encoder_attention_heads, w.head_dim,
                               jnp.float32)
    ts = TS.init_encoder_state(w.encoder_layers, B, cache,
                               w.encoder_attention_heads, w.head_dim,
                               torch.float32, "cpu")
    rng = np.random.RandomState(1)
    j_step = jax.jit(JW.chunk_step, static_argnums=(1, 4, 5))
    for i in range(3):
        rf = np.asarray([48, 0 if i == 1 else 96], np.int32)
        win = rng.randn(B, CONV_LEFT_CONTEXT + 4 * UNIT).astype(np.float32)
        win *= 0.1
        before = (ts.k[:, 1].clone(), ts.v[:, 1].clone())
        fj, js = j_step(jp["w2v2"], w, js, jnp.asarray(win), chunk_frames,
                        cache, jnp.asarray(rf))
        ft, ts = TW.chunk_step(tp["w2v2"], TCFG.w2v2, ts,
                               torch.from_numpy(win), chunk_frames, cache,
                               row_frames=torch.from_numpy(rf))
        # the rows with frames (a row without any is masked padding)
        n = 1 if i == 1 else 2
        _close(ft[:n].numpy(), np.asarray(fj)[:n])
        _close(ts.k.numpy(), js.k)
        _close(ts.v.numpy(), js.v)
        assert ts.n_frames.tolist() == [48 * (i + 1), 96 * (1 + i // 2)]
        if i == 1:  # 0 frames: the row's ring is unchanged, bit for bit
            assert torch.equal(ts.k[:, 1], before[0])
            assert torch.equal(ts.v[:, 1], before[1])
    # encode_chunk: the same rows through the adapter, row 1 sitting out
    rf = np.asarray([48, 0], np.int32)
    win = rng.randn(B, CONV_LEFT_CONTEXT + 4 * UNIT).astype(np.float32) * 0.1
    tj, js2 = jax.jit(JSL.encode_chunk, static_argnums=(1, 4, 5))(
        jp, JCFG, js, jnp.asarray(win), chunk_frames, cache, jnp.asarray(rf))
    tt, ts2 = TSL.encode_chunk(tp, TCFG, ts, torch.from_numpy(win),
                               chunk_frames, cache,
                               row_frames=torch.from_numpy(rf))
    assert tuple(tt.shape) == (B, 24, TCFG.adapter.out_dim)
    _close(tt[:1].numpy(), np.asarray(tj)[:1])
    _close(ts2.k.numpy(), js2.k)
    assert torch.equal(ts2.k[:, 1], ts.k[:, 1])
    assert torch.equal(ts2.v[:, 1], ts.v[:, 1])


@pytest.mark.parametrize("B,Bc", [(8, 2), (6, 3), (4, 4), (4, 1)])
def test_decode_attention_cache_per_group_of_rows(B, Bc):
    H, KV, Dh, C = 8, 2, 16, 40
    rng = np.random.RandomState(B * 10 + Bc)
    q = rng.randn(B, H, Dh).astype(np.float32)
    k = rng.randn(Bc, C, KV, Dh).astype(np.float32)
    v = rng.randn(Bc, C, KV, Dh).astype(np.float32)
    vl = rng.randint(0, C + 5, (Bc,)).astype(np.int32)
    off = rng.randint(0, 900, (Bc,)).astype(np.int32)
    qp = rng.randint(0, 1000, (B,)).astype(np.int32)
    inv = torch.tensor(llama_rope_freqs(Dh, 500000.0, scaling=False),
                       dtype=torch.float32)
    t = torch.from_numpy
    rep = B // Bc
    for key_offset in (None, t(off)):
        got, lse = TA.decode_attention(t(q), t(k), t(v), t(vl), t(qp), inv,
                                       key_offset=key_offset,
                                       return_lse=True)
        r_off = None if key_offset is None else \
            key_offset.repeat_interleave(rep)
        want, want_lse = TA.decode_attention(
            t(q), t(k).repeat_interleave(rep, 0),
            t(v).repeat_interleave(rep, 0), t(vl).repeat_interleave(rep),
            t(qp), inv, key_offset=r_off, return_lse=True)
        assert torch.equal(got, want) and torch.equal(lse, want_lse)
    # per slot against the JAX reference (no key offset there)
    got = TA.decode_attention(t(q), t(k), t(v), t(vl), t(qp), inv)
    for c in range(Bc):
        rows = slice(c * rep, (c + 1) * rep)
        want = JA.decode_attention_reference(
            jnp.asarray(q[rows]), jnp.asarray(np.repeat(k[c:c + 1], rep, 0)),
            jnp.asarray(np.repeat(v[c:c + 1], rep, 0)),
            jnp.asarray(np.repeat(vl[c:c + 1], rep)), jnp.asarray(qp[rows]),
            jnp.asarray(inv.numpy()))
        _close(got[rows].numpy(), want)


def _prefix_states(P, C, vlen, seed):
    ll = CFG.llama
    rng = np.random.RandomState(seed)
    shape = (ll.num_layers, P, C, ll.num_kv_heads, ll.head_dim)
    k = rng.randn(*shape).astype(np.float32) * 0.5
    v = rng.randn(*shape).astype(np.float32) * 0.5
    vl = np.asarray(vlen, np.int32)
    jd = JS.DecoderState(k=jnp.asarray(k), v=jnp.asarray(v),
                         valid_len=jnp.asarray(vl))
    td = TS.DecoderState(k=torch.from_numpy(k.copy()),
                         v=torch.from_numpy(v.copy()),
                         valid_len=torch.from_numpy(vl.astype(np.int64)))
    return jd, td


def test_pooled_beam_token_step_matches_jax_per_slot():
    jp, tp = _params()
    ll = CFG.llama
    P, beam, G, gen_len = 2, 2, 5, 3
    jd, td = _prefix_states(P, 32, [11, 27], seed=2)
    rng = np.random.RandomState(3)
    gshape = (ll.num_layers, P * beam, G, ll.num_kv_heads, ll.head_dim)
    gk = rng.randn(*gshape).astype(np.float32)
    gv = rng.randn(*gshape).astype(np.float32)
    x = rng.randn(P * beam, 1, ll.hidden_size).astype(np.float32)
    lt, gkt, gvt, _ = TL.beam_token_step(
        tp["llama"], TCFG.llama, td, torch.from_numpy(gk.copy()),
        torch.from_numpy(gv.copy()), gen_len, torch.from_numpy(x))
    for p in range(P):
        rows = slice(p * beam, (p + 1) * beam)
        prefix = JS.DecoderState(k=jd.k[:, p:p + 1], v=jd.v[:, p:p + 1],
                                 valid_len=jd.valid_len[p:p + 1])
        lj, gkj, gvj, _ = JL.beam_token_step(
            jp["llama"], ll, prefix, jnp.asarray(gk[:, rows]),
            jnp.asarray(gv[:, rows]), jnp.asarray(gen_len, jnp.int32),
            jnp.asarray(x[rows]))
        _close(lt[rows].numpy(), lj)
        _close(gkt[:, rows].numpy(), gkj)
        _close(gvt[:, rows].numpy(), gvj)


def test_batched_beam_search_matches_jax():
    """Two slots with different prefixes, prompts and histories; slot 0
    may run 8 steps, slot 1 one (an inactive slot in the engine), so slot
    1 stays frozen while slot 0 goes on.  EOS is the tenth of slot 0's
    first step's logits: a finished hypothesis of 6 tokens wins slot 0,
    so its K/V snapshot is what is compared."""
    jp, tp = _params()
    ll = CFG.llama
    P, C, G, Tp = 2, 64, 8, 12
    jd, td = _prefix_states(P, C, [17, 23], seed=5)
    rng = np.random.RandomState(6)
    last = rng.randn(P, ll.vocab_size).astype(np.float32) * 2.0
    eos = int(np.argsort(last[0])[-10])
    prompts = rng.randint(10, 400, (P, Tp)).astype(np.int32)
    plens = np.asarray([9, 12], np.int32)
    hists = rng.randint(10, 400, (P, 16)).astype(np.int32)
    hlens = np.asarray([4, 0], np.int32)
    caps = np.asarray([8, 1], np.int32)
    kw = dict(beam=2, max_new_tokens=G, eos_id=eos, pad_id=504,
              no_repeat_ngram_size=3, repetition_penalty=1.2)
    want = JB.batched_beam_search(
        jp["llama"], ll, jd, jnp.asarray(last), jnp.asarray(prompts),
        jnp.asarray(plens), jnp.asarray(hists), jnp.asarray(hlens),
        JB.BeamSpec(**kw), encoder_ngram_size=3,
        max_steps=jnp.asarray(caps), return_kv=True)
    got = TB.batched_beam_search(
        tp["llama"], TCFG.llama, td, torch.from_numpy(last),
        torch.from_numpy(prompts).long(), plens,
        torch.from_numpy(hists).long(), hlens, TB.BeamSpec(**kw),
        encoder_ngram_size=3, max_steps=caps, return_kv=True)
    assert [r.steps for r in got] == np.asarray(want.steps).tolist()
    assert got[1].steps == 1
    for p, r in enumerate(got):
        assert r.tokens == np.asarray(want.tokens[p]).tolist()
        assert r.n_tokens == int(want.n_tokens[p])
        assert r.hit_eos == bool(want.hit_eos[p])
        np.testing.assert_allclose(r.score, float(want.score[p]), rtol=1e-5)
        n_emit = r.n_tokens if r.hit_eos else r.n_tokens - 1
        assert tuple(r.kv_k.shape) == (ll.num_layers, G, ll.num_kv_heads,
                                       ll.head_dim)
        if n_emit > 0:
            _close(r.kv_k[:, :n_emit].numpy(),
                   np.asarray(want.kv_k[p])[:, :n_emit])
            _close(r.kv_v[:, :n_emit].numpy(),
                   np.asarray(want.kv_v[p])[:, :n_emit])
    assert got[0].hit_eos and got[0].n_tokens > 0  # non-vacuous


LANGS = [("English", "German"), ("English", "Spanish")]


def _stream_kw(cap):
    return dict(max_cache_frames=96, max_llm_cache_tokens=cap,
                llm_cache_capacity=256)


def port_engine(pool, beam, multipliers, multiplier=1, cap=120, **kw):
    """The port's engine on the settings of tests/test_serve.py, on the
    CPU, with English-German and English-Spanish prompts."""
    _, tp = _params()
    return TE.ServingEngine(
        tp, TCFG, TC.StreamConfig(**_stream_kw(cap)),
        {lp: PromptBuilder(StubTokenizer(512, lo=10, hi=400), TCFG.tokens,
                           *lp) for lp in LANGS},
        pool_size=pool, multiplier=multiplier, dtype=torch.float32,
        beam=beam, multipliers=multipliers, device="cpu", **kw)


def _engines(pool, beam, multipliers, multiplier=1, cap=120):
    jp, _ = _params()
    je = JEngine(
        jp, JCFG, JStream(**_stream_kw(cap)),
        {lp: JPB(JST(512, lo=10, hi=400), JCFG.tokens, *lp) for lp in LANGS},
        pool_size=pool, multiplier=multiplier, dtype=jnp.float32, beam=beam,
        multipliers=multipliers)
    return je, port_engine(pool, beam, multipliers, multiplier, cap)


def _same(je, te, label):
    assert te._S == je._S and te.max_new == je.max_new, label
    for i, (a, b) in enumerate(zip(je.slots, te.slots)):
        got = (b.active, b.m, b.target_ids, b.cache_len,
               b.cache_checkpoints, b.done, len(b.pending))
        want = (a.active, a.m, a.target_ids, a.cache_len,
                a.cache_checkpoints, a.done, len(a.pending))
        assert got == want, (label, i, got, want)
    assert te.valid_len_host.tolist() == je.valid_len_host.tolist(), label
    assert te.evictions == je.evictions, label
    assert te.last_ticked == je.last_ticked, label


# (name, pool, beam, multipliers, cap, events): an event list per tick of
# (op, slot, arg); 'push' sends one 960 ms unit (arg: finished)
SCENARIOS = {
    # mixed (1, 2) pool, beam 2: slot 0 switches m = 1 -> 2 at tick 2,
    # slot 1 (m = 2, Spanish) closes after tick 3 and a new m = 1 client
    # takes its slot; the 120-token cache trims from tick 3 on
    "beam2_mixed": (2, 2, (1, 2), 120, [
        [("open", 0, 1), ("open", 1, 2), ("push", 0, 0), ("push", 1, 0)],
        [("push", 0, 0), ("push", 1, 0)],
        [("mult", 0, 2), ("push", 0, 0), ("push", 1, 0)],
        [("push", 0, 0), ("push", 1, 0)],
        [("close", 1, 0), ("open", 1, 1), ("push", 0, 0), ("push", 1, 0)],
        [("push", 0, 0), ("push", 1, 1)],
        [("push", 0, 1)],
    ]),
    # beam 1 (batched greedy), three slots, a 60-token cache: two slots
    # trim in the same tick; one finishes early
    "beam1_trim": (3, 1, None, 60, [
        [("open", 0, 1), ("open", 1, 1), ("push", 0, 0), ("push", 1, 0)],
        [("push", 0, 0), ("push", 1, 0), ("open", 2, 1), ("push", 2, 0)],
        [("push", 0, 0), ("push", 1, 0), ("push", 2, 1)],
        [("push", 0, 0), ("push", 1, 0)],
        [("push", 0, 1), ("push", 1, 1)],
    ]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_matches_jax_every_tick(name):
    pool, beam, mults, cap, events = SCENARIOS[name]
    je, te = _engines(pool, beam, mults, cap=cap)
    rng = np.random.RandomState(0)
    langs = {0: ("English", "German"), 1: ("English", "Spanish"),
             2: ("English", "German")}
    prefills = 0
    for t, tick_events in enumerate(events):
        for op, slot, arg in tick_events:
            if op == "open":
                got = [e.open_stream(f"c{slot}", langs[slot], multiplier=arg)
                       for e in (je, te)]
                assert got == [slot, slot]
            elif op == "close":
                je.close_stream(slot)
                te.close_stream(slot)
            elif op == "mult":
                je.update_multiplier(slot, arg)
                te.update_multiplier(slot, arg)
            else:
                audio = rng.randn(UNIT).astype(np.float32) * 0.1
                je.push_audio(slot, audio, finished=bool(arg))
                te.push_audio(slot, audio, finished=bool(arg))
        out_j, out_t = je.tick(), te.tick()
        assert out_t == out_j, (name, t)
        _same(je, te, (name, t))
        prefills += bool(te.last_ticked)
    assert te.evictions > 0 and all(s.done or not s.active
                                    for s in te.slots)
    # the host mirror is the device's valid_len once the trim is applied
    te.flush_pending_evict()
    np.testing.assert_array_equal(te.dec_state.valid_len.numpy(),
                                  te.valid_len_host)
    assert te.forwards["prefill"] == prefills < len(events) + (beam == 1)


def test_failed_step_keeps_the_deferred_trim(monkeypatch):
    """A step that raises leaves the engine's device state and its
    pending trim as they were; the next tick applies the trim."""
    te = port_engine(1, 2, None, cap=60)
    rng = np.random.RandomState(1)
    te.open_stream("c0")
    while te._pending_evict is None:
        te.push_audio(0, rng.randn(UNIT).astype(np.float32) * 0.1)
        te.tick()
    keep, sys_lens = (a.copy() for a in te._pending_evict)
    vlen = te.dec_state.valid_len.clone()
    k = te.dec_state.k

    def boom(*args, **kw):
        raise RuntimeError("step failed")

    monkeypatch.setattr(TSL, "encode_chunk", boom)
    te.push_audio(0, rng.randn(UNIT).astype(np.float32) * 0.1)
    with pytest.raises(RuntimeError, match="step failed"):
        te.tick()
    assert te._pending_evict is not None
    np.testing.assert_array_equal(te._pending_evict[0], keep)
    np.testing.assert_array_equal(te._pending_evict[1], sys_lens)
    assert torch.equal(te.dec_state.valid_len, vlen) and te.dec_state.k is k
    te.flush_pending_evict()
    assert te.dec_state.valid_len.tolist() == [int(sys_lens[0] + keep[0])]


@pytest.mark.parametrize("option", [dict(speculative=True),
                                    dict(do_sample=True),
                                    dict(spec_guard=False)])
def test_unported_engine_options_raise(option):
    """The JAX constructor's speculative, sampling and guard options are
    taken, and its refusals kept: pooled sampling without speculation,
    speculation above beam 1, an unknown option."""
    def make(beam=1, **kw):
        return port_engine(1, beam, None, **kw)

    if "do_sample" in option:
        with pytest.raises(ValueError, match="speculative"):
            make(**option)
        eng = make(speculative=True, **option)
        assert eng.do_sample and eng.speculative
    else:
        eng = make(**option)
        assert eng.speculative == option.get("speculative", False)
        assert (eng._spec_breakeven is not None) == eng.speculative
    with pytest.raises(ValueError, match="beam=1"):
        make(speculative=True, beam=2)
    with pytest.raises(TypeError):
        make(no_such_option=1)
