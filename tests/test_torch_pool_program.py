"""The serving pool's tick as one device program (JAX's execution model
for ``serve/engine.py``'s ``_build_step``), on ``tiny_model_config``,
CPU, float32:

1. The device beam loop (``decode/beam.py``: ``BeamLoop`` over a pool,
   driven by ``batched_beam_search``) at P = 3 against JAX
   ``batched_beam_search``: per-row step caps (an inactive row's cap of
   1), an EOS bias of +3 in both frameworks so that rows finish and one
   stops early, ``return_kv``.  Tokens, n_tokens, hit_eos and steps
   equal; scores and the winners' K/V within 1e-5.
2. The probe on the device loop against JAX ``beam_search(attn_probe=,
   attn_stop_idx=)`` row by row, three rows in one pool with no stop, a
   stop at 12 and a stop at 0 (reached at the first step): equal tokens,
   steps and attention traces.
3. Pool batch invariance: each stream alone (``beam_search``) equals its
   row in the pool, the K/V too.
4. The engine's tick: one program for every mix of multipliers (the
   beam program, or the greedy one at beam 1), and its host reads,
   counted under a ``TorchFunctionMode``: at most the tick's steps + 1
   (a ``done`` or ``go`` a step and the packed result).
5. The counts recorded around one tick's pieces (``core/graphs``) equal
   what the tick counted: one prefill and steps - 1 beam forwards.
6. A tick that raises: in its prologue, before the state is written, the
   next ticks equal a twin engine's that never saw the failed chunk
   (tokens, slot table, the device and host cache lengths); past the
   prologue's writes, in the beam loop or the greedy scan, the engine
   refuses the next tick.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from infinisst_tpu.decode import beam as JB
from infinisst_tpu.models import llama as JL
from infinisst_tpu.streaming.state import DecoderState as JDS
from infinisst_tpu.streaming.state import init_decoder_state
from infinisst_tpu_torch.core import graphs
from infinisst_tpu_torch.decode import beam as TB
from infinisst_tpu_torch.decode import logits as TLP
from infinisst_tpu_torch.models import llama as TL
from infinisst_tpu_torch.models import speech_llm as TSL
from infinisst_tpu_torch.streaming.state import DecoderState as TDS
from tests.test_torch_serve import TCFG, UNIT, _close, _params, port_engine

torch.set_num_threads(1)

LCFG = TCFG.llama
P, C, G, TP = 3, 48, 8, 20
EOS, BIAS = 100, 3.0
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__index__",
              "__float__", "cpu", "numpy")


@pytest.fixture(scope="module")
def pool():
    """Three prefix caches after prompts of 20, 14 and 17 ids (the tiny
    Llama, JAX's prefill), their last logits, prompts and histories."""
    jp, tp = _params()
    rng = np.random.RandomState(31)
    plens = [20, 14, 17]
    ks, vs, vls, firsts, prompts = [], [], [], [], []
    for n in plens:
        prompt = rng.randint(10, 400, (TP,)).astype(np.int32)
        st = init_decoder_state(LCFG.num_layers, 1, C, LCFG.num_kv_heads,
                                LCFG.head_dim, jnp.float32)
        logits, st = JL.decode_step(
            jp["llama"], LCFG, st,
            JL.embed(jp["llama"], jnp.asarray(prompt[:n])[None]))
        ks.append(np.asarray(st.k))
        vs.append(np.asarray(st.v))
        vls.append(int(st.valid_len[0]))
        firsts.append(np.asarray(logits[0, -1]))
        prompts.append(prompt)
    k, v = np.concatenate(ks, 1), np.concatenate(vs, 1)
    vl = np.asarray(vls, np.int32)
    return dict(
        jp=jp, tp=tp, plens=np.asarray(plens, np.int32),
        first=np.stack(firsts), prompts=np.stack(prompts),
        hists=rng.randint(10, 400, (P, 12)).astype(np.int32),
        hlens=np.asarray([5, 0, 12], np.int32),
        jdec=JDS(k=jnp.asarray(k), v=jnp.asarray(v),
                 valid_len=jnp.asarray(vl)),
        tdec=TDS(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
                 valid_len=torch.from_numpy(vl.astype(np.int64))))


def _bias_eos(monkeypatch):
    """+BIAS on the EOS logit of every beam step, in both frameworks (the
    first logits are biased by the caller)."""
    j_step, t_step = JL.beam_token_step, TL.beam_token_step

    def j_biased(*a, **k):
        out = j_step(*a, **k)
        return (out[0].at[:, EOS].add(BIAS),) + tuple(out[1:])

    def t_biased(*a, **k):
        out = t_step(*a, **k)
        lg = out[0].clone()
        lg[:, EOS] += BIAS
        return (lg,) + tuple(out[1:])

    monkeypatch.setattr(JL, "beam_token_step", j_biased)
    monkeypatch.setattr(TL, "beam_token_step", t_biased)


def _spec(beam):
    return dict(beam=beam, max_new_tokens=G, eos_id=EOS, pad_id=504,
                no_repeat_ngram_size=3, repetition_penalty=1.2)


def _port(c, first, spec, rows=slice(None), **kw):
    """The port's batched_beam_search over ``rows`` of the pool."""
    dec = TDS(k=c["tdec"].k[:, rows], v=c["tdec"].v[:, rows],
              valid_len=c["tdec"].valid_len[rows])
    return TB.batched_beam_search(
        c["tp"]["llama"], LCFG, dec, torch.from_numpy(first[rows]),
        torch.from_numpy(c["prompts"][rows]).long(), c["plens"][rows],
        torch.from_numpy(c["hists"][rows]).long(), c["hlens"][rows],
        TB.BeamSpec(**spec), encoder_ngram_size=3, **kw)


def _n_emit(r):
    return r.n_tokens if r.hit_eos else max(r.n_tokens - 1, 0)


@pytest.mark.parametrize("beam", [2, 4])
def test_device_pool_loop_matches_jax(pool, monkeypatch, beam):
    c = pool
    _bias_eos(monkeypatch)
    first = c["first"].copy()
    first[:, EOS] += BIAS
    caps = np.asarray([G, 1, G], np.int32)  # row 1: an inactive row
    spec = _spec(beam)
    want = jax.device_get(JB.batched_beam_search(
        c["jp"]["llama"], LCFG, c["jdec"], jnp.asarray(first),
        jnp.asarray(c["prompts"]), jnp.asarray(c["plens"]),
        jnp.asarray(c["hists"]), jnp.asarray(c["hlens"]),
        JB.BeamSpec(**spec), encoder_ngram_size=3,
        max_steps=jnp.asarray(caps), return_kv=True))
    got = _port(c, first, spec, max_steps=caps, return_kv=True)
    assert [r.steps for r in got] == np.asarray(want.steps).tolist()
    for p, r in enumerate(got):
        assert r.tokens == np.asarray(want.tokens[p]).tolist(), p
        assert r.n_tokens == int(want.n_tokens[p])
        assert r.hit_eos == bool(want.hit_eos[p])
        np.testing.assert_allclose(r.score, float(want.score[p]), rtol=1e-5)
        n = _n_emit(r)
        assert tuple(r.kv_k.shape) == (LCFG.num_layers, G,
                                       LCFG.num_kv_heads, LCFG.head_dim)
        if n:
            _close(r.kv_k[:, :n].numpy(), np.asarray(want.kv_k[p])[:, :n])
            _close(r.kv_v[:, :n].numpy(), np.asarray(want.kv_v[p])[:, :n])
    # non-vacuous: the inactive row stops at once, a finished hypothesis
    # wins somewhere and some live row stops before its cap
    assert got[1].steps == 1
    assert any(r.hit_eos and _n_emit(r) > 0 for r in got)
    assert any(r.steps < cap for r, cap in zip(got, caps) if cap > 1)


@pytest.mark.parametrize("beam", [2, 3])
def test_probed_pool_matches_jax_per_row(pool, beam):
    """The probe (layer 1, prefix keys 2..14) with the prefill's index 7
    as every row's first; row 0 without a stop, row 1 stops at 12, row 2
    at 0 (every beam is in the zone after the first step)."""
    c = pool
    spec = _spec(beam)
    probe, stops = (1, 2, 14), [None, 12, 0]
    got = _port(c, c["first"], spec, max_steps=[7, 7, 7], attn_probe=probe,
                first_attn_idx=[7, 7, 7], attn_stop_idx=[10 ** 6, 12, 0])
    for p, stop in enumerate(stops):
        jdec = JDS(k=c["jdec"].k[:, p:p + 1], v=c["jdec"].v[:, p:p + 1],
                   valid_len=c["jdec"].valid_len[p:p + 1])
        want = jax.device_get(JB.beam_search(
            c["jp"]["llama"], LCFG, jdec, jnp.asarray(c["first"][p]),
            jnp.asarray(c["prompts"][p]), jnp.asarray(c["plens"][p]),
            jnp.asarray(c["hists"][p]), jnp.asarray(c["hlens"][p]),
            JB.BeamSpec(**spec), encoder_ngram_size=3,
            max_steps=jnp.asarray(7, jnp.int32), attn_probe=probe,
            first_attn_idx=jnp.asarray(7, jnp.int32),
            attn_stop_idx=None if stop is None else jnp.asarray(
                stop, jnp.int32)))
        r = got[p]
        assert r.tokens == np.asarray(want.tokens).tolist(), p
        assert (r.n_tokens, r.steps, r.hit_eos) == (
            int(want.n_tokens), int(want.steps), bool(want.hit_eos)), p
        assert r.attn_idx == np.asarray(want.attn_idx).tolist(), p
        assert r.attn_idx[0] == 7
    assert got[2].steps == 1  # the stop zone, reached on the device
    assert got[0].steps == 7


@pytest.mark.parametrize("beam", [1, 4])
def test_each_stream_alone_equals_its_row_in_the_pool(pool, beam):
    c = pool
    spec = _spec(beam)
    pooled = _port(c, c["first"], spec, return_kv=True)
    for p in range(P):
        dec = TDS(k=c["tdec"].k[:, p:p + 1], v=c["tdec"].v[:, p:p + 1],
                  valid_len=c["tdec"].valid_len[p:p + 1])
        alone = TB.beam_search(
            c["tp"]["llama"], LCFG, dec, torch.from_numpy(c["first"][p]),
            torch.from_numpy(c["prompts"][p]).long(), int(c["plens"][p]),
            torch.from_numpy(c["hists"][p]).long(), int(c["hlens"][p]),
            TB.BeamSpec(**spec), encoder_ngram_size=3, return_kv=True)
        r = pooled[p]
        assert (alone.tokens, alone.n_tokens, alone.steps, alone.hit_eos) \
            == (r.tokens, r.n_tokens, r.steps, r.hit_eos), p
        np.testing.assert_allclose(alone.score, r.score, rtol=1e-6)
        n = _n_emit(r)
        _close(alone.kv_k[:, :n].numpy(), r.kv_k[:, :n].numpy())
        _close(alone.kv_v[:, :n].numpy(), r.kv_v[:, :n].numpy())


# ---------------------------------------------------------------------------
# the engine's tick


class _HostReads(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in HOST_READS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _ticks(eng, n_ticks, ms, seed=3):
    """Open one slot a multiplier in ``ms`` and tick ``n_ticks`` times,
    one 960 ms unit pushed a slot a tick; yields after each tick the host
    reads it made and its token forwards."""
    rng = np.random.RandomState(seed)
    slots = [eng.open_stream(f"c{i}", multiplier=m)
             for i, m in enumerate(ms)]
    for _ in range(n_ticks):
        for s in slots:
            eng.push_audio(s, rng.randn(UNIT).astype(np.float32) * 0.1)
        before = eng.forwards["token"]
        with _HostReads() as mode:
            eng.tick()
        yield mode.n, eng.forwards["token"] - before


@pytest.mark.parametrize("beam,ms", [(2, (1, 2, 1)), (1, (1, 1))])
def test_tick_is_one_program_and_reads_steps_plus_one(beam, ms):
    """A mixed (1, 2) beam pool, with a multiplier switch, and a greedy
    pool: one program each, whatever the multipliers of the tick; every
    tick reads the device at most steps + 1 times (steps = the token
    forwards + 1)."""
    eng = port_engine(3, beam, (1, 2), cap=60)
    n = 0
    for i, (reads, n_fwd) in enumerate(_ticks(eng, 4, ms)):
        if i == 1 and beam > 1:
            eng.update_multiplier(0, 2)
        assert 0 < reads <= n_fwd + 2, (i, reads, n_fwd)
        n += n_fwd
    assert n > 0 and eng.evictions > 0
    assert list(eng._programs) == ["beam" if beam > 1 else "greedy"]


def test_replays_count_what_the_tick_recorded():
    """The delta of the registered counts around one tick's pieces, taken
    back and added again (what a replay adds), is what the tick counted:
    one prefill and steps - 1 beam forwards over the pool."""
    eng = port_engine(2, 2, None)
    rng = np.random.RandomState(8)
    for i in range(2):
        eng.open_stream(f"c{i}")
        eng.push_audio(i, rng.randn(UNIT).astype(np.float32) * 0.1)
    before = eng.forwards["token"]
    snap = graphs._snapshot()
    eng.tick()
    counted = [dict(c) for c in graphs._counters]
    delta = graphs._delta(snap)
    graphs._restore(snap)
    graphs._add(delta)
    assert [dict(c) for c in graphs._counters] == counted
    L, n_fwd = LCFG.num_layers, eng.forwards["token"] - before
    want = {f"decode_step L={L}": 1}
    if n_fwd:
        want[f"beam_token_step L={L}"] = n_fwd
    assert dict(next(dd for d, dd in delta if d is TL.forward_counts)) == want
    assert n_fwd > 0


def _boom(*args, **kw):
    raise RuntimeError("step failed")


def _until_a_trim(engs, rng):
    """Open two m = 1 slots in each engine and tick them alike, one unit
    a slot a tick, until a trim is pending."""
    for e in engs:
        for i in range(2):
            e.open_stream(f"c{i}")
    while engs[0]._pending_evict is None:
        _push_and_tick(engs, rng)
    assert all(e._pending_evict is not None for e in engs)


def _push(engs, rng):
    units = [rng.randn(UNIT).astype(np.float32) * 0.1 for _ in range(2)]
    for e in engs:
        for i, u in enumerate(units):
            e.push_audio(i, u)


def _push_and_tick(engs, rng):
    _push(engs, rng)
    return [e.tick() for e in engs]


def _table(eng):
    return ([(s.active, s.m, s.target_ids, s.cache_len, s.cache_checkpoints,
              s.first_chunk, s.system_prompt_size) for s in eng.slots],
            eng.valid_len_host.tolist(), eng.dec_state.valid_len.tolist(),
            eng.evictions)


@pytest.mark.parametrize("beam", [2, 1])
def test_tick_failing_in_its_prologue_then_matches_a_twin(monkeypatch, beam):
    """A tick whose encoder raises writes nothing and keeps the pending
    trim: every later tick gives the tokens, slot table and cache lengths
    of a twin engine that never saw the failed tick's chunk."""
    eng, twin = (port_engine(2, beam, None, cap=60) for _ in range(2))
    rng = np.random.RandomState(5)
    _until_a_trim((eng, twin), rng)
    with monkeypatch.context() as mp:
        mp.setattr(TSL, "encode_chunk", _boom)
        _push((eng,), rng)
        with pytest.raises(RuntimeError, match="step failed"):
            eng.tick()
    assert _table(eng) == _table(twin)
    n = 0
    for i in range(3):
        got, want = _push_and_tick((eng, twin), rng)
        assert got == want and _table(eng) == _table(twin), i
        n += sum(len(s.target_ids) for s in eng.slots)
    assert n > 0


@pytest.mark.parametrize("beam,module,name", [(2, TB, "beam_forward"),
                                              (1, TLP, "process_scores")])
def test_tick_failing_past_its_prologue_refuses_the_next(monkeypatch, beam,
                                                         module, name):
    """A tick that raises in its beam loop or greedy scan, after the
    prologue applied the trim and prefilled in place, leaves the cache a
    prompt ahead of the slot table: the next tick raises instead of
    running on it."""
    eng = port_engine(2, beam, None, cap=60)
    rng = np.random.RandomState(6)
    _until_a_trim((eng,), rng)
    with monkeypatch.context() as mp:
        mp.setattr(module, name, _boom)
        _push((eng,), rng)
        with pytest.raises(RuntimeError, match="step failed"):
            eng.tick()
    assert eng._pending_evict is None
    assert (eng.dec_state.valid_len.numpy() > eng.valid_len_host).all()
    _push((eng,), rng)
    with pytest.raises(RuntimeError, match="cannot tick again"):
        eng.tick()
