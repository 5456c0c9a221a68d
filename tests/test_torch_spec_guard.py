"""The acceptance guard of the port's agent and engine against the JAX
package on the CPU, on the tiny float32 agent and pool of
``tests/test_agent.py`` / ``tests/test_spec_guard.py``.

A speculative stream whose tokens per verify round stay below the
weight-stream break-even for ``spec_guard_patience`` chunks (ticks) drops
to its plain decoder: speculative greedy to beam 1 (the pool to its plain
batched greedy), speculative beam to plain beam, speculative sampling to
the plain sampler; a sampling pool to the d = L self-draft.  Tokens are
compared exactly: with the JAX agent and sampling engine (the same trip,
the same tokens every chunk), and with the plain decoders (the guarded
stream trips before the chunk where this model's batched verify first
flips a near-tie against the sequential beam step, as JAX's stream
does).  Mirrors
``tests/test_spec_guard.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from infinisst_tpu.core.config import StreamConfig as JStream
from infinisst_tpu.data.template import PromptBuilder as JBuilder
from infinisst_tpu.data.template import StubTokenizer as JStub
from infinisst_tpu.decode.speculative import breakeven_tokens_per_round
from infinisst_tpu.serve.engine import ServingEngine as JEngine
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.decode import speculative as TS
from tests.test_agent import CFG, VOCAB, make_agent, small_special_tokens
from tests.test_agent import tiny_params
from tests.test_torch_agent import make_port_agent
from tests.test_torch_serve import port_engine

torch.set_num_threads(1)

_TP = {}


def _tp():
    if not _TP:
        _TP["p"] = from_jax(jax.device_get(tiny_params()), device="cpu")
    return _TP["p"]


def run_stream(agent, n_chunks=5, seed=3):
    """Per-chunk tokens, and the token index where the guard tripped."""
    rng = np.random.RandomState(seed)
    out, trip_at = [], None
    for i in range(n_chunks):
        before = len(agent.states.target_ids)
        agent.push(rng.randn(agent.chunk_samples).astype(np.float32) * 0.1,
                   finished=(i == n_chunks - 1))
        out.append(list(agent.states.target_ids[before:]))
        if trip_at is None and agent.spec_fallback_active:
            trip_at = i
    return out, trip_at


def beam1(agent):
    agent.opts.beam = 1
    return agent


def test_breakeven_model_sanity():
    """Above 1; deeper drafts and longer k cost more; a d = L draft sits
    at or below its k + 1 tokens; a narrower head lowers it; the JAX
    value on the same tiny model."""
    params = _tp()["llama"]
    L = CFG.llama.num_layers
    small = TS.breakeven_tokens_per_round(params, L, 1, 2)
    assert small > 1.0
    assert TS.breakeven_tokens_per_round(params, L, L, 2) > small
    assert TS.breakeven_tokens_per_round(params, L, 1, 6) > small
    assert 3 + 1 >= TS.breakeven_tokens_per_round(params, L, L, 3)
    head = TS.make_draft_head(params["lm_head"], 64)
    assert TS.breakeven_tokens_per_round(params, L, 1, 2,
                                         draft_head=head) < small
    assert small == breakeven_tokens_per_round(tiny_params()["llama"], L, 1,
                                               2)


def test_guard_trips_on_a_zero_accept_draft_and_stays_exact():
    """A d = 1 draft on the 2-layer random model accepts almost nothing:
    the guard trips after 2 chunks, as the JAX agent's does, and every
    chunk's tokens equal the JAX guarded agent's and the port's plain
    beam 1 agent's; the statistics stop at the trip."""
    kw = dict(speculative=True, spec_draft_layers=1, spec_k=3,
              spec_guard_patience=2)
    guarded = make_port_agent(_tp(), **kw)
    out, trip = run_stream(guarded)
    assert guarded.spec_fallback_active and trip == 1
    rounds = guarded.spec_rounds
    jax_agent = make_agent(spec_warm_fallback=False, **kw)
    jout, jtrip = run_stream(jax_agent)
    assert out == jout and trip == jtrip
    assert (rounds, guarded.spec_accepted) == (jax_agent.spec_rounds,
                                               jax_agent.spec_accepted)
    assert out == run_stream(beam1(make_port_agent(_tp())))[0]
    assert sum(map(len, out)) > 0
    # the fallback committed nothing speculatively: the bookkeeping holds
    guarded.flush_pending_evict()
    assert guarded.llm_cache_len == (int(guarded.dec_state.valid_len[0])
                                     + guarded.pend_n_host)


def test_guard_opt_out_and_accept_all():
    """--spec-no-guard keeps speculating (the raw envelope); accept_all
    never arms the guard."""
    raw = make_port_agent(_tp(), speculative=True, spec_draft_layers=1,
                          spec_k=3, spec_guard=False)
    run_stream(raw, n_chunks=4)
    assert raw._spec_breakeven is None and not raw.spec_fallback_active
    assert raw.spec_rounds > 0
    ceiling = make_port_agent(_tp(), speculative=True, spec_draft_layers=1,
                              spec_k=3, spec_accept_all=True)
    assert ceiling._spec_breakeven is None


def test_spec_beam_falls_back_to_plain_beam():
    """Speculative beam's fallback is plain beam search: every chunk's
    tokens equal the plain beam agent's, across the trip."""
    guarded = make_port_agent(_tp(), speculative=True, spec_beam=True,
                              spec_draft_layers=1, spec_k=2,
                              spec_guard_patience=2)
    out, trip = run_stream(guarded)
    assert guarded.spec_fallback_active and trip is not None
    assert out == run_stream(make_port_agent(_tp()))[0]
    guarded.flush_pending_evict()
    assert guarded.llm_cache_len == (int(guarded.dec_state.valid_len[0])
                                     + guarded.pend_n_host)


def test_sampling_falls_back_to_the_plain_sampler():
    """Speculative sampling's fallback is the plain sampler: at top_k = 1
    both are the greedy chain, so the guarded stream equals beam 1 and
    the unguarded one up to the trip."""
    kw = dict(speculative=True, spec_draft_layers=1, spec_k=3,
              do_sample=True, top_k=1, sample_seed=7)
    guarded = make_port_agent(_tp(), spec_guard_patience=2, **kw)
    out, trip = run_stream(guarded)
    assert guarded.spec_fallback_active and trip == 1
    assert out == run_stream(beam1(make_port_agent(_tp())))[0]
    twin, _ = run_stream(make_port_agent(_tp(), spec_guard=False, **kw),
                         n_chunks=trip + 1)
    assert out[: trip + 1] == twin


def _slots(eng, n_ticks=6):
    """Each slot's tokens after ``n_ticks`` ticks of seeded noise into a
    pool of two."""
    slots = [eng.open_stream(f"c{i}") for i in range(2)]
    rng = np.random.RandomState(0)
    for _ in range(n_ticks):
        for s in slots:
            eng.push_audio(s, rng.randn(eng.chunk_samples).astype(
                np.float32) * 0.1)
        eng.tick()
    return [list(eng.slots[s].target_ids) for s in slots]


def test_engine_guard_trips_the_pool_and_stays_exact():
    """The pool-wide guard: a zero-accept pooled draft trips it after two
    ticks and swaps the pool to the plain batched greedy; every slot's
    tokens equal the plain greedy pool's and the unguarded speculative
    pool's."""
    kw = dict(speculative=True, spec_draft_layers=1, spec_k=3)
    guarded = port_engine(2, 1, None, spec_guard_patience=2, **kw)
    out = _slots(guarded)
    assert guarded.spec_fallback_active
    rounds = guarded.spec_stats["rounds"]
    assert 0 < rounds and guarded.forwards["verify"] == rounds
    raw = port_engine(2, 1, None, spec_guard=False, **kw)
    assert out == _slots(raw) == _slots(port_engine(2, 1, None))
    assert not raw.spec_fallback_active and raw.spec_stats["rounds"] > rounds
    assert sum(map(len, out)) > 0


def test_engine_sampling_guard_takes_the_self_draft():
    """A sampling pool trips to the d = L self-draft, as the JAX engine's
    does (the settings of tests/test_spec_guard.py:215): the JAX engine's
    tokens at top_k = 1 and its statistics (after the trip only the
    emitted count grows)."""
    kw = dict(speculative=True, spec_draft_layers=1, spec_k=3,
              do_sample=True, top_k=1, spec_guard_patience=2)
    cfg = CFG.replace(tokens=small_special_tokens())
    stream = JStream(max_cache_frames=96, max_llm_cache_tokens=120,
                     llm_cache_capacity=256)
    jeng = JEngine(tiny_params(), cfg, stream, {("English", "German"):
                   JBuilder(JStub(vocab_size=VOCAB, lo=10, hi=400),
                            cfg.tokens)},
                   pool_size=2, beam=1, dtype=jnp.float32,
                   spec_warm_fallback=False, **kw)
    teng = port_engine(2, 1, None, **kw)
    tout, jout = _slots(teng), _slots(jeng)
    assert teng.spec_fallback_active and jeng.spec_fallback_active
    assert tout == jout and teng.spec_stats == jeng.spec_stats
    assert teng.spec_stats["emitted"] == sum(map(len, tout))


def test_speculative_commit_precedes_the_trim():
    """Why speculative greedy leaves beam 1 greedy after a trim (ROADMAP
    §3): the plain path commits a chunk's tokens in the next
    chunk's prefill, after the deferred trim, so their K/V above the
    first layer attend over the trimmed cache; the speculative verify
    computed them before it.  Over the first trims of the tiny stream
    the two caches hold the same tokens (layer 0 K equal) and the same
    prompts, and differ at the earlier chunks' tokens from layer 1 on."""
    from infinisst_tpu_torch.models import llama as TL

    grabbed = {}
    plain = beam1(make_port_agent(_tp()))
    spec = make_port_agent(_tp(), speculative=True, spec_draft_layers=1,
                           spec_k=3, spec_guard=False)
    for name, agent in (("plain", plain), ("spec", spec)):
        run_stream(agent, n_chunks=5)
        agent.flush_pending_evict()
        if name == "plain":  # commit the pending tokens as a prefill does
            n = agent.pend_n
            x = TL.embed(agent.params["llama"],
                         torch.as_tensor(agent.pend_tokens[None, :n]))
            _, agent.dec_state = TL.decode_step(
                agent.params["llama"], agent.cfg.llama, agent.dec_state, x)
        grabbed[name] = agent.dec_state
    assert plain.evictions == spec.evictions > 0
    kp, ks = grabbed["plain"].k, grabbed["spec"].k
    n = int(grabbed["spec"].valid_len[0])
    assert int(grabbed["plain"].valid_len[0]) == n
    torch.testing.assert_close(kp[0, :, :n], ks[0, :, :n], rtol=1e-5,
                               atol=1e-5)
    gap = (kp[1:, :, :n] - ks[1:, :, :n]).abs().amax(dim=(0, 1, 3, 4))
    assert float(gap.max()) > 1e-2  # the tokens' context differs
    assert int((gap < 1e-5).sum()) > n // 2  # the prompts' does not
