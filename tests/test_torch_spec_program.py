"""The speculative decoders as device programs (JAX's execution model):
the device-resident loops against the JAX package, the sampler against
the draws of the host loop it replaced, the agents and the engine
against JAX, and the host reads of a chunk and a tick.

(a) ``speculative.batched_speculative_greedy`` (``SpecLoop``,
    ``start_spec``, ``spec_round``) against JAX
    ``batched_speculative_greedy`` on the tiny float32 Llama of
    ``tests/test_speculative.py``: a pool of three prompts (one row
    inactive, per-row caps, one above G), d in {1, 2}, k in {1, 3}, a
    +3 logit bias on EOS in both frameworks (the first logits and every
    ``decode_step``'s), with a roomy and a near-full cache.  Tokens,
    n_tokens, hit_eos, rounds, drafted and accepted equal; the committed
    cache (every slot) within 1e-6 x its largest magnitude.
(b) The sampler draws exactly the ids recorded from the parent's host
    loop (``speculative_sample``, ``batched_speculative_sample`` and the
    sampling engine at seeds 0-2, recorded at commit
    f4ca9c108beaa0c76b68d81e927d05a1317e2d14); at top_k 1 it is JAX's
    greedy.
(c) ``spec_beam.spec_beam_search`` (``SpecBeamLoop``, the anchor, the
    round, the finish) against JAX ``spec_beam_search`` and the port's
    ``beam_search``, d in {1, 2}, with and without the EOS bias (the
    first logits, ``beam_token_step``'s and ``beam_tree_step``'s):
    tokens, n_tokens, steps, hit_eos, rounds, drafted and accepted equal;
    the score within 1e-6 relative.
(d) The speculative greedy and speculative-beam agents against the JAX
    agent, push by push, over a stream with two evictions and a tail;
    the speculative engine against the JAX engine tick by tick,
    greedy and sampling, through a guard trip into the fallback program.
(e) Host reads under a ``TorchFunctionMode``: at most rounds + 2 a
    speculative chunk or tick, 2 x rounds + 2 a spec-beam chunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.agents.infinisst import InfiniSSTAgent as JAgent
from infinisst_tpu.agents.infinisst import InfiniSSTOptions as JOptions
from infinisst_tpu.core.config import StreamConfig as JStream
from infinisst_tpu.data.template import PromptBuilder as JPromptBuilder
from infinisst_tpu.data.template import StubTokenizer as JStub
from infinisst_tpu.decode import beam as JB
from infinisst_tpu.decode import spec_beam as JSB
from infinisst_tpu.decode import speculative as JS
from infinisst_tpu.models import llama as JL
from infinisst_tpu.serve.engine import ServingEngine as JEngine
from infinisst_tpu.streaming.state import init_decoder_state
from infinisst_tpu_torch.agents.infinisst import (
    InfiniSSTAgent,
    InfiniSSTOptions,
)
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core import config as TC
from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
from infinisst_tpu_torch.decode import beam as TB
from infinisst_tpu_torch.decode import spec_beam as TSB
from infinisst_tpu_torch.decode import speculative as TS
from infinisst_tpu_torch.models import llama as TL
from infinisst_tpu_torch.streaming.state import DecoderState
from tests.test_agent import CFG as AGENT_CFG
from tests.test_agent import VOCAB, small_special_tokens, tiny_params
from tests.test_speculative import CFG, G, NGRAM, PAD, REP
from tests.test_torch_chunk_program import _HostReads
from tests.test_torch_serve import JCFG, LANGS, _params, _same, _stream_kw
from tests.test_torch_serve import port_engine
from tests.test_torch_spec_guard import _slots
from tests.test_torch_speculative import TCFG, _sspec, both, t_dec, t_sample

torch.set_num_threads(1)

EOS, BIAS = 5, 3.0
PLEN = 9


def _bias(monkeypatch, names):
    """Add BIAS to the EOS logit of every forward ``names`` of llama
    returns, in both frameworks."""
    for name in names:
        j_fn, t_fn = getattr(JL, name), getattr(TL, name)

        def j_biased(*a, _f=j_fn, **k):
            out = _f(*a, **k)
            return (out[0].at[..., EOS].add(BIAS),) + tuple(out[1:])

        def t_biased(*a, _f=t_fn, **k):
            out = _f(*a, **k)
            lg = out[0].clone()
            lg[..., EOS] += BIAS
            return (lg,) + tuple(out[1:])

        monkeypatch.setattr(JL, name, j_biased)
        monkeypatch.setattr(TL, name, t_biased)


_POOL = {}


def _pool(cap):
    """Three prompts prefilled into a pool's cache of ``cap`` slots, in
    both frameworks: (jax (params, ids, dec, first), port (...))."""
    if cap not in _POOL:
        params = JL.init_params(jax.random.PRNGKey(0), CFG, jnp.float32)
        ids = jax.random.randint(jax.random.PRNGKey(100), (3, PLEN), 1,
                                 CFG.vocab_size).astype(jnp.int32)
        dec = init_decoder_state(CFG.num_layers, 3, cap, CFG.num_kv_heads,
                                 CFG.head_dim, jnp.float32)
        logits, dec = JL.decode_step(params, CFG, dec, JL.embed(params, ids))
        _POOL[cap] = (params, ids, dec, logits[:, -1],
                      from_jax(jax.device_get(params), device="cpu"))
    params, ids, dec, first, tp = _POOL[cap]
    return (params, ids, jax.tree.map(jnp.copy, dec), first), (
        tp, torch.from_numpy(np.array(ids)).long(), t_dec(dec),
        torch.from_numpy(np.array(first)))


ACTIVE = [True, False, True]
CAPS = [G + 5, G, 5]


def _jax_pool(j, spec, first_bias=0.0):
    params, ids, dec, first = j
    return JS.batched_speculative_greedy(
        params, CFG, dec, first.at[:, EOS].add(first_bias), ids,
        jnp.full((3,), PLEN, jnp.int32), jnp.full((3, 16), PAD, jnp.int32),
        jnp.zeros((3,), jnp.int32), spec, jnp.asarray(ACTIVE),
        row_max_new=jnp.asarray(CAPS, jnp.int32), encoder_ngram_size=NGRAM)


def _port_pool(t, spec, first_bias=0.0, sample=None):
    params, ids, dec, first = t
    first = first.clone()
    first[:, EOS] += first_bias
    args = (params, TCFG, dec, first, ids, [PLEN] * 3,
            torch.full((3, 16), PAD, dtype=torch.int64), [0] * 3, spec)
    kw = dict(row_max_new=np.array(CAPS), encoder_ngram_size=NGRAM)
    if sample is not None:
        return TS.batched_speculative_sample(*args, sample, ACTIVE, **kw)
    return TS.batched_speculative_greedy(*args, ACTIVE, **kw)


def _jspec(d, k, **kw):
    return JS.SpecSpec(max_new_tokens=G, eos_id=EOS, pad_id=PAD,
                       draft_layers=d, draft_k=k,
                       no_repeat_ngram_size=NGRAM, repetition_penalty=REP,
                       **kw)


def _equal_outputs(got, want):
    """tokens, n, hit_eos, -, rounds, drafted, accepted equal."""
    for i in (0, 1, 2, 4, 5, 6):
        np.testing.assert_array_equal(np.asarray(got[i]),
                                      np.asarray(want[i]), err_msg=str(i))


# ---------------------------------------------------------------------------
# (a) the greedy loop against JAX


@pytest.mark.parametrize("cache", ["roomy", "near_full"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("d", [1, 2])
def test_device_greedy_matches_jax(monkeypatch, d, k, cache):
    _bias(monkeypatch, ["decode_step"])
    cap = 64 if cache == "roomy" else PLEN + k + 1
    j, t = _pool(cap)
    spec = _jspec(d, k)
    want = _jax_pool(j, spec, BIAS)
    got = _port_pool(t, TS.SpecSpec(*spec), BIAS)
    _equal_outputs(got, want)
    dec, jdec = got[3], want[3]
    np.testing.assert_array_equal(dec.valid_len.numpy(),
                                  np.asarray(jdec.valid_len))
    for a, b in ((dec.k, jdec.k), (dec.v, jdec.v)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()
    n = got[1].tolist()
    assert n[1] == 0 and n[2] <= 5  # the inactive row, the cap
    if cache == "roomy":  # the bias makes EOS end a row mid-stream
        assert bool(got[2].any())


# ---------------------------------------------------------------------------
# (b) the sampler: the parent's draws, kept


# ``speculative_sample`` on ``both(0)``'s prefix (d 1, k 3, temperature
# 1.3, top_k 8, top_p 0.92, EOS id 80) with generators seeded 0-2:
# (tokens, n_tokens, hit_eos, rounds, drafted, accepted, valid_len)
RECORDED_SINGLE = {
    0: ([111, 50, 72, 49, 65, 94, 28, 65, 0, 0, 0, 0], 8, True, 9, 27, 0,
        17),
    1: ([111, 84, 50, 65, 72, 115, 65, 122, 56, 96, 28, 24], 12, False, 11,
        33, 1, 21),
    2: ([19, 3, 84, 65, 122, 100, 39, 28, 115, 0, 0, 0], 9, True, 9, 27, 1,
        18),
}
# ``batched_speculative_sample`` on a pool of three copies of
# ``both(2)``'s prefix (d 2, k 3, temperature 1.1, top_p 0.9, no EOS),
# rows active / inactive / active, caps G + 7, G, 5: (tokens, n, rounds,
# drafted, accepted, valid_len), hit_eos all False
RECORDED_BATCHED = {
    0: ([[51, 1, 38, 115, 49, 114, 30, 58, 51, 67, 89, 74], [0] * 12,
         [81, 74, 39, 114, 43] + [0] * 7], [12, 0, 5], 4, [12, 0, 6],
        [8, 0, 3], [21, 9, 14]),
    1: ([[54, 88, 35, 13, 65, 119, 115, 91, 43, 4, 83, 74], [0] * 12,
         [7, 98, 61, 107, 81] + [0] * 7], [12, 0, 5], 5, [15, 0, 9],
        [7, 0, 2], [21, 9, 14]),
    2: ([[63, 74, 117, 21, 98, 30, 86, 26, 59, 61, 67, 48], [0] * 12,
         [38, 50, 126, 42, 116] + [0] * 7], [12, 0, 5], 8, [24, 0, 6],
        [4, 0, 3], [21, 9, 14]),
}
# the sampling engine (pool 2, d 1, k 3, temperature 1.2, top_k 8, top_p
# 0.9, no guard), ``_slots`` after 4 ticks: each slot's tokens and the
# pool's statistics
RECORDED_ENGINE = {
    0: ([[383, 485, 494, 289, 383, 171, 379, 196, 131, 10, 263, 287, 379,
          215, 60, 10, 13, 266, 14, 93, 263, 391, 447, 50, 75, 105, 403,
          427, 472, 401, 450, 494, 14, 75, 239, 447, 403, 383, 10, 119],
         [114, 383, 119, 379, 239, 266, 75, 276, 167, 217, 276, 239, 296,
          436, 494, 75, 55, 263, 450, 403, 263, 450, 10, 391, 67, 50, 227,
          436, 75, 492, 302, 67, 10, 75, 492, 239, 119, 391, 263, 450]],
        {"rounds": 29, "drafted": 171, "accepted": 23, "emitted": 80}),
    1: ([[217, 276, 504, 196, 76, 13, 211, 391, 10, 85, 217, 368, 276, 105,
          379, 215, 196, 75, 10, 371, 456, 67, 215, 391, 10, 119, 379, 427,
          289, 266, 276, 379, 10, 391, 215, 196, 75, 494, 484, 472],
         [276, 75, 211, 67, 76, 10, 171, 193, 36, 139, 263, 75, 67, 484,
          445, 276, 215, 76, 312, 394, 48, 276, 239, 327, 87, 395, 219, 215,
          391, 342, 217, 296, 312, 456, 391, 504, 31, 69, 472, 75]],
        {"rounds": 31, "drafted": 171, "accepted": 23, "emitted": 80}),
    2: ([[211, 67, 391, 49, 249, 160, 447, 296, 436, 312, 276, 239, 494, 13,
          313, 93, 383, 119, 305, 131, 75, 14, 391, 93, 211, 492, 239, 119,
          265, 130, 76, 75, 131, 403, 119, 391, 93, 239, 305, 67],
         [383, 50, 424, 49, 14, 281, 167, 401, 75, 341, 217, 371, 167, 484,
          472, 75, 67, 296, 10, 50, 456, 76, 10, 131, 171, 427, 239, 484,
          85, 329, 217, 75, 85, 257, 239, 298, 447, 67, 371, 281]],
        {"rounds": 31, "drafted": 177, "accepted": 21, "emitted": 80}),
}


def _recorded_single(seed):
    _, t = both(0)
    r = t_sample(t, _sspec(1, k=3, temperature=1.3, top_k=8, top_p=0.92,
                           eos_id=80), seed=seed)
    return (r.tokens, r.n_tokens, r.hit_eos, r.rounds, r.drafted,
            r.accepted, int(r.dec.valid_len[0])), RECORDED_SINGLE[seed]


def _recorded_batched(seed):
    _, t = both(2)
    params, prompt, dec, first = t
    B = 3
    bdec = DecoderState(dec.k.repeat(1, B, 1, 1, 1),
                        dec.v.repeat(1, B, 1, 1, 1), dec.valid_len.repeat(B))
    out = TS.batched_speculative_sample(
        params, TCFG, bdec, first[None].repeat(B, 1),
        prompt[None].repeat(B, 1), [len(prompt)] * B,
        torch.full((B, 16), PAD, dtype=torch.int64), [0] * B,
        _sspec(2, k=3, temperature=1.1, top_p=0.9),
        torch.Generator().manual_seed(seed), ACTIVE,
        row_max_new=np.array([G + 7, G, 5]), encoder_ngram_size=NGRAM)
    assert not bool(out[2].any())
    got = (out[0].tolist(), out[1].tolist(), int(out[4]), out[5].tolist(),
           out[6].tolist(), out[3].valid_len.tolist())
    return got, RECORDED_BATCHED[seed]


def _recorded_engine(seed):
    eng = port_engine(2, 1, None, speculative=True, spec_draft_layers=1,
                      spec_k=3, do_sample=True, temperature=1.2, top_k=8,
                      top_p=0.9, spec_guard=False, sample_seed=seed)
    got = (_slots(eng, n_ticks=4), dict(eng.spec_stats))
    assert list(eng._programs) == ["spec_sample"]
    return got, RECORDED_ENGINE[seed]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("where", ["single", "batched", "engine"])
def test_sampler_draws_the_recorded_ids(where, seed):
    got, want = {"single": _recorded_single, "batched": _recorded_batched,
                 "engine": _recorded_engine}[where](seed)
    assert got == want


@pytest.mark.parametrize("d", [1, 2])
def test_sampler_topk1_is_jax_greedy(monkeypatch, d):
    """top_k 1 makes every law a point mass: the pool of (a) (EOS bias,
    caps, an inactive row) emits JAX's greedy output, any seed."""
    _bias(monkeypatch, ["decode_step"])
    j, t = _pool(64)
    want = _jax_pool(j, _jspec(d, 3), BIAS)
    spec = _sspec(d, k=3, top_k=1, eos_id=EOS)
    for seed in (0, 1):
        _, t = _pool(64)
        got = _port_pool(t, spec, BIAS,
                         sample=torch.Generator().manual_seed(seed))
        for i in (0, 1, 2):
            np.testing.assert_array_equal(np.asarray(got[i]),
                                          np.asarray(want[i]))


# ---------------------------------------------------------------------------
# (c) speculative beam search against JAX and beam_search


HIST = jnp.full((16,), PAD, jnp.int32)


@pytest.mark.parametrize("bias", [0.0, BIAS])
@pytest.mark.parametrize("d", [1, 2])
def test_device_spec_beam_matches_jax(monkeypatch, d, bias):
    if bias:
        _bias(monkeypatch, ["beam_token_step", "beam_tree_step"])
    j, t = both(1)
    spec = TB.BeamSpec(beam=3, max_new_tokens=G, eos_id=EOS, pad_id=PAD,
                       no_repeat_ngram_size=NGRAM, repetition_penalty=REP)
    params, prompt, dec, first = t
    tfirst = first.clone()
    tfirst[EOS] += bias
    args = (params, TCFG, dec, tfirst, prompt, len(prompt),
            torch.full((16,), PAD, dtype=torch.int64), 0, spec)
    got = TSB.spec_beam_search(*args, draft_layers=d, draft_k=3,
                               encoder_ngram_size=NGRAM)
    jp, jprompt, jdec, jfirst = j
    want = JSB.spec_beam_search(
        jp, CFG, jdec, jfirst.at[EOS].add(bias), jprompt,
        jnp.asarray(PLEN, jnp.int32), HIST, jnp.zeros((), jnp.int32),
        JB.BeamSpec(*spec), draft_layers=d, draft_k=3,
        encoder_ngram_size=NGRAM)
    assert got.tokens == np.asarray(want.tokens).tolist()
    assert (got.n_tokens, got.steps, got.hit_eos, got.rounds, got.drafted,
            got.accepted) == (int(want.n_tokens), int(want.steps),
                              bool(want.hit_eos), int(want.rounds),
                              int(want.drafted), int(want.accepted))
    assert got.score == pytest.approx(float(want.score), rel=1e-6)
    ref = TB.beam_search(*args, encoder_ngram_size=NGRAM)
    assert (got.tokens[:got.n_tokens], got.n_tokens, got.hit_eos,
            got.steps) == (ref.tokens[:ref.n_tokens], ref.n_tokens,
                           ref.hit_eos, ref.steps)
    assert got.hit_eos == bool(bias)  # the bias ends the search at EOS


# ---------------------------------------------------------------------------
# (d) the agents and the engine against JAX


MAX_CACHE, CAPACITY = 64, 160
SPEC = dict(speculative=True, spec_draft_layers=2, spec_k=3,
            spec_guard=False)


def _port_agent(**kw):
    cfg = TC.tiny_model_config(vocab_size=VOCAB).replace(
        tokens=TC.SpecialTokens(**small_special_tokens().__dict__))
    stream = TC.StreamConfig(max_cache_frames=96,
                             max_llm_cache_tokens=MAX_CACHE,
                             llm_cache_capacity=CAPACITY)
    builder = PromptBuilder(StubTokenizer(vocab_size=VOCAB, lo=10, hi=400),
                            cfg.tokens)
    opts = InfiniSSTOptions(max_llm_cache_size=MAX_CACHE,
                            no_repeat_ngram_lookback=32, **kw)
    return InfiniSSTAgent(_params()[1], cfg, stream, builder, opts,
                          param_dtype=torch.float32, device="cpu")


def _jax_agent(**kw):
    cfg = AGENT_CFG.replace(tokens=small_special_tokens())
    stream = JStream(max_cache_frames=96, max_llm_cache_tokens=MAX_CACHE,
                     llm_cache_capacity=CAPACITY)
    builder = JPromptBuilder(JStub(vocab_size=VOCAB, lo=10, hi=400),
                             cfg.tokens)
    opts = JOptions(max_llm_cache_size=MAX_CACHE,
                    no_repeat_ngram_lookback=32, spec_warm_fallback=False,
                    **kw)
    return JAgent(tiny_params(), cfg, stream, builder, opts,
                  param_dtype=jnp.float32)


@pytest.mark.parametrize("beam", [1, 4])
def test_speculative_agents_match_jax(beam):
    """Speculative greedy (beam 1) and speculative beam search (beam 4):
    the JAX agent's tokens push by push, over six chunks with two
    evictions and a one-unit tail; one program a key."""
    kw = dict(SPEC, beam=beam, spec_beam=beam > 1)
    port, jax_agent = _port_agent(**kw), _jax_agent(**kw)
    rng = np.random.RandomState(21)
    sizes = [port.chunk_samples] * 6 + [5000]
    for i, n in enumerate(sizes):
        audio = rng.randn(n).astype(np.float32) * 0.1
        last = i == len(sizes) - 1
        got = port.push(audio, finished=last)
        want = jax_agent.push(audio, finished=last)
        assert port.states.target_ids == list(jax_agent.states.target_ids), i
        assert (got.is_read(), getattr(got, "content", None)) == (
            want.is_read(), getattr(want, "content", None))
    assert port.evictions == jax_agent.evictions >= 2
    assert (port.spec_rounds, port.spec_accepted) == (
        jax_agent.spec_rounds, jax_agent.spec_accepted)
    assert port.spec_rounds > 0 and port.states.target_ids
    kind = "spec_beam" if beam > 1 else "spec"
    assert {k[3] for k in port._programs} == {kind}


@pytest.mark.parametrize("sample", [False, True])
def test_speculative_engine_matches_jax_across_the_trip(sample):
    """The speculative pool (greedy; sampling at top_k 1) against the JAX
    engine tick by tick: slots, caches, statistics and the guard's trip
    into the fallback program (greedy: the plain greedy program;
    sampling: the d = L self-draft)."""
    kw = dict(speculative=True, spec_draft_layers=1, spec_k=3,
              spec_guard_patience=2)
    if sample:
        kw.update(do_sample=True, top_k=1)
    jeng = JEngine(_params()[0], JCFG, JStream(**_stream_kw(120)),
                   {lp: JPromptBuilder(JStub(512, lo=10, hi=400),
                                       JCFG.tokens, *lp) for lp in LANGS},
                   pool_size=2, beam=1, dtype=jnp.float32,
                   spec_warm_fallback=False, **kw)
    teng = port_engine(2, 1, None, **kw)
    slots = [(jeng.open_stream(f"c{i}"), teng.open_stream(f"c{i}"))
             for i in range(2)]
    rng = np.random.RandomState(0)
    for tick in range(6):
        for js, ts in slots:
            audio = rng.randn(teng.chunk_samples).astype(np.float32) * 0.1
            jeng.push_audio(js, audio)
            teng.push_audio(ts, audio)
        assert teng.tick() == jeng.tick(), tick
        _same(jeng, teng, tick)
        assert teng.spec_stats == jeng.spec_stats, tick
        assert teng.spec_fallback_active == jeng.spec_fallback_active, tick
    assert teng.spec_fallback_active
    fallback = "spec_sample_self" if sample else "greedy"
    assert list(teng._programs) == [
        "spec_sample" if sample else "spec", fallback]


# ---------------------------------------------------------------------------
# (e) host reads


@pytest.mark.parametrize("kind", ["spec", "spec_sample", "spec_beam"])
def test_speculative_chunk_reads(kind):
    """Every push of one chunk reads ``go`` once a round (spec beam: after
    T and after R) and the packed vector once."""
    kw = dict(SPEC, do_sample=kind == "spec_sample",
              spec_beam=kind == "spec_beam",
              beam=4 if kind == "spec_beam" else 1, top_k=8)
    agent = _port_agent(**kw)
    rng = np.random.RandomState(5)
    for _ in range(3):
        audio = rng.randn(agent.chunk_samples).astype(np.float32) * 0.1
        with _HostReads() as mode:
            agent.push(audio)
        r = agent.last_result.rounds
        bound = 2 * r + 2 if kind == "spec_beam" else r + 2
        assert 0 < mode.n <= bound, (mode.n, r)
    assert {k[3] for k in agent._programs} == {kind}


@pytest.mark.parametrize("sample", [False, True])
def test_speculative_tick_reads(sample):
    """A speculative tick reads ``go`` once a round and the packed vector
    once: rounds + 2."""
    eng = port_engine(2, 1, None, speculative=True, spec_draft_layers=1,
                      spec_k=3, spec_guard=False, do_sample=sample)
    slots = [eng.open_stream(f"c{i}") for i in range(2)]
    rng = np.random.RandomState(1)
    for _ in range(3):
        for s in slots:
            eng.push_audio(s, rng.randn(eng.chunk_samples).astype(
                np.float32) * 0.1)
        before = eng.spec_stats["rounds"]
        with _HostReads() as mode:
            eng.tick()
        r = eng.spec_stats["rounds"] - before
        assert 0 < mode.n <= r + 2, (mode.n, r)
