"""The plain beam chunk step as one device program (JAX's execution
model): the device-resident beam search and the agent's chunk program
against the JAX package, and the host reads of a chunk.

(a) ``decode/beam.beam_search`` (the device-resident loop: ``BeamLoop``,
    ``beam_select``, ``beam_forward``, ``beam_finish``) against JAX
    ``beam_search`` on the tiny float32 Llama: beam 1, 2 and 4,
    repetition penalty 1.3, no-repeat-ngram 3 (and the cross-chunk
    history's), length penalty 1.0 and 0.7, with a logit bias of +3 on
    EOS in both frameworks (added to the first logits and to every
    ``beam_token_step``'s), so that finished hypotheses and the early stop
    happen; and once unbiased (the length cap).  Tokens, n_tokens,
    hit_eos and steps equal; the score to 1e-6 relative.
(b) The same cases against the stream's row in a pool of three
    (``batched_beam_search``): the pool is batch invariant.
(c) The agent, whose plain beam step is the chunk program, against the
    JAX agent token for token, push by push: m = 1 at beam 4 and m = 2 at
    beam 1, over a stream with at least two evictions and a finishing
    tail chunk.
(d) The host reads of one chunk step, counted under a
    ``TorchFunctionMode`` (item, tolist, __bool__, __int__, __index__,
    __float__, cpu, numpy): one ``done`` a beam step and one packed
    vector, steps + 1 in all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from infinisst_tpu.agents.infinisst import InfiniSSTAgent as JAgent
from infinisst_tpu.agents.infinisst import InfiniSSTOptions as JOptions
from infinisst_tpu.core.config import StreamConfig as JStream
from infinisst_tpu.core.config import tiny_model_config
from infinisst_tpu.data.template import PromptBuilder as JPromptBuilder
from infinisst_tpu.data.template import StubTokenizer as JStub
from infinisst_tpu.decode import beam as JB
from infinisst_tpu.models import llama as JL
from infinisst_tpu.streaming.state import init_decoder_state
from infinisst_tpu_torch.agents.infinisst import (
    InfiniSSTAgent,
    InfiniSSTOptions,
)
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core import config as TC
from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
from infinisst_tpu_torch.decode import beam as TB
from infinisst_tpu_torch.models import llama as TL
from infinisst_tpu_torch.streaming.state import DecoderState as TDS
from tests.test_agent import CFG as JCFG
from tests.test_agent import VOCAB, small_special_tokens, tiny_params

torch.set_num_threads(1)

LCFG = tiny_model_config(vocab_size=512).llama
EOS = 7  # with a +3 bias, a top candidate within the first steps
BIAS = 3.0
G = 10
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__index__",
              "__float__", "cpu", "numpy")


@pytest.fixture(scope="module")
def beam_case():
    """The tiny Llama's prefix cache after a 15-id prompt, in both
    frameworks."""
    jp = JL.init_params(jax.random.PRNGKey(0), LCFG)
    tp = from_jax(jax.device_get(jp), device="cpu")
    rng = np.random.RandomState(11)
    prompt = rng.randint(0, 500, (15,)).astype(np.int32)
    hist = rng.randint(0, 500, (16,)).astype(np.int32)
    st = init_decoder_state(LCFG.num_layers, 1, 48, LCFG.num_kv_heads,
                            LCFG.head_dim, jnp.float32)
    logits, st = JL.decode_step(jp, LCFG, st,
                                JL.embed(jp, jnp.asarray(prompt)[None]))
    prefix = TDS(k=torch.from_numpy(np.array(st.k)),
                 v=torch.from_numpy(np.array(st.v)),
                 valid_len=torch.from_numpy(np.array(st.valid_len)).long())
    return dict(jp=jp, tp=tp, prompt=prompt, hist=hist, jst=st,
                prefix=prefix, first=np.array(logits[0, -1]))


def _bias_steps(monkeypatch, bias):
    """Add ``bias`` to the EOS logit of every beam step, in both
    frameworks (the first logits are biased by the caller)."""
    if not bias:
        return
    j_step, t_step = JL.beam_token_step, TL.beam_token_step

    def j_biased(*a, **k):
        out = j_step(*a, **k)
        return (out[0].at[:, EOS].add(bias),) + tuple(out[1:])

    def t_biased(*a, **k):
        out = t_step(*a, **k)
        lg = out[0].clone()
        lg[:, EOS] += bias
        return (lg,) + tuple(out[1:])

    monkeypatch.setattr(JL, "beam_token_step", j_biased)
    monkeypatch.setattr(TL, "beam_token_step", t_biased)


CASES = [(b, lp, BIAS) for b in (1, 2, 4) for lp in (1.0, 0.7)] + \
    [(4, 1.0, 0.0)]


def _spec(beam, length_penalty):
    return dict(beam=beam, max_new_tokens=G, eos_id=EOS, pad_id=504,
                no_repeat_ngram_size=3, repetition_penalty=1.3,
                length_penalty=length_penalty)


def _port_args(c, bias):
    first = torch.from_numpy(c["first"].copy())
    first[EOS] += bias
    return (c["tp"], LCFG, c["prefix"], first,
            torch.from_numpy(c["prompt"]).long(), 15,
            torch.from_numpy(c["hist"]).long(), 9)


def _same(got, want_tokens, want_n, want_steps, want_eos):
    assert list(got.tokens) == list(want_tokens)
    assert got.n_tokens == want_n
    assert got.steps == want_steps
    assert got.hit_eos == want_eos


@pytest.mark.parametrize("beam,length_penalty,bias", CASES)
def test_device_beam_search_matches_jax(beam_case, monkeypatch, beam,
                                        length_penalty, bias):
    c = beam_case
    _bias_steps(monkeypatch, bias)
    first = c["first"].copy()
    first[EOS] += bias
    spec = _spec(beam, length_penalty)
    sup = np.zeros((LCFG.vocab_size,), bool)
    sup[[3, 77]] = True
    want = jax.device_get(JB.beam_search(
        c["jp"], LCFG, c["jst"], jnp.asarray(first),
        jnp.asarray(c["prompt"]), jnp.asarray(15, jnp.int32),
        jnp.asarray(c["hist"]), jnp.asarray(9, jnp.int32),
        JB.BeamSpec(**spec), encoder_ngram_size=3,
        suppress_mask=jnp.asarray(sup),
    ))
    got = TB.beam_search(*_port_args(c, bias), TB.BeamSpec(**spec),
                         encoder_ngram_size=3,
                         suppress_mask=torch.from_numpy(sup))
    _same(got, np.asarray(want.tokens).tolist(), int(want.n_tokens),
          int(want.steps), bool(want.hit_eos))
    np.testing.assert_allclose(got.score, float(want.score), rtol=1e-6)
    if bias:  # the bias does what it is for: EOS ends the winner
        assert got.hit_eos


@pytest.mark.parametrize("beam,length_penalty,bias", CASES)
def test_device_beam_search_matches_batched(beam_case, monkeypatch, beam,
                                            length_penalty, bias):
    """The stream alone equals its row (the middle one) in a pool of
    three; the other rows hold the same cache cut to 9 and 12 keys, with
    other first logits and histories."""
    c = beam_case
    _bias_steps(monkeypatch, bias)
    args = _port_args(c, bias)
    spec = TB.BeamSpec(**_spec(beam, length_penalty))
    got = TB.beam_search(*args, spec, encoder_ngram_size=3)
    pre = args[2]
    dec = TDS(k=pre.k.repeat(1, 3, 1, 1, 1), v=pre.v.repeat(1, 3, 1, 1, 1),
              valid_len=torch.tensor([9, 15, 12]))
    first = torch.stack([args[3].roll(5), args[3], args[3].roll(-3)])
    hist = args[6][None].repeat(3, 1)
    _, want, _ = TB.batched_beam_search(
        args[0], LCFG, dec, first, args[4][None].repeat(3, 1), [9, 15, 12],
        torch.stack([hist[0].roll(1), hist[1], hist[2].roll(2)]), [4, 9, 16],
        spec, encoder_ngram_size=3)
    _same(got, want.tokens, want.n_tokens, want.steps, want.hit_eos)
    np.testing.assert_allclose(got.score, want.score, rtol=1e-6)


def test_the_early_stop_is_exercised(beam_case, monkeypatch):
    """With the bias, some cases stop before the cap (the worst finished
    hypothesis beats every live beam's best possible score)."""
    _bias_steps(monkeypatch, BIAS)
    steps = [TB.beam_search(*_port_args(beam_case, BIAS),
                            TB.BeamSpec(**_spec(b, lp)),
                            encoder_ngram_size=3).steps
             for b, lp, _ in CASES[:-1]]
    assert min(steps) < G and all(s <= G for s in steps), steps


# ---------------------------------------------------------------------------
# the agent


MAX_CACHE, CAPACITY = 64, 160


def _port_agent(params, multiplier, beam):
    cfg = TC.tiny_model_config(vocab_size=VOCAB).replace(
        tokens=TC.SpecialTokens(**small_special_tokens().__dict__))
    stream = TC.StreamConfig(max_cache_frames=96,
                             max_llm_cache_tokens=MAX_CACHE,
                             llm_cache_capacity=CAPACITY)
    builder = PromptBuilder(StubTokenizer(vocab_size=VOCAB, lo=10, hi=400),
                            cfg.tokens)
    opts = InfiniSSTOptions(latency_multiplier=multiplier, beam=beam,
                            max_llm_cache_size=MAX_CACHE,
                            no_repeat_ngram_lookback=32)
    return InfiniSSTAgent(params, cfg, stream, builder, opts,
                          param_dtype=torch.float32, device="cpu")


def _jax_agent(multiplier, beam):
    cfg = JCFG.replace(tokens=small_special_tokens())
    stream = JStream(max_cache_frames=96, max_llm_cache_tokens=MAX_CACHE,
                     llm_cache_capacity=CAPACITY)
    builder = JPromptBuilder(JStub(vocab_size=VOCAB, lo=10, hi=400),
                             cfg.tokens)
    opts = JOptions(latency_multiplier=multiplier, beam=beam,
                    max_llm_cache_size=MAX_CACHE,
                    no_repeat_ngram_lookback=32)
    return JAgent(tiny_params(), cfg, stream, builder, opts,
                  param_dtype=jnp.float32)


def _stream(agent, n_full, tail):
    rng = np.random.RandomState(21)
    out = []
    sizes = [agent.chunk_samples] * n_full + [tail]
    for i, n in enumerate(sizes):
        before = len(agent.states.target_ids)
        act = agent.push(rng.randn(n).astype(np.float32) * 0.1,
                         finished=i == len(sizes) - 1)
        out.append([int(t) for t in agent.states.target_ids[before:]])
    assert act.finished
    return out


@pytest.mark.parametrize("multiplier,beam,n_full", [(1, 4, 6), (2, 1, 4)])
def test_agent_chunk_program_matches_jax(multiplier, beam, n_full):
    port = _port_agent(from_jax(jax.device_get(tiny_params()), device="cpu"),
                       multiplier, beam)
    jax_agent = _jax_agent(multiplier, beam)
    tail = 5000  # one 960 ms unit, padded: a tail key (n_units < m at m=2)
    got = _stream(port, n_full, tail)
    want = _stream(jax_agent, n_full, tail)
    assert got == want, (got, want)
    assert port.evictions == jax_agent.evictions >= 2
    assert sum(map(len, got)) > 0
    # one program per key: the first chunk, the steady one and, at m = 2,
    # the tail of one unit
    keys = sorted(port._programs)
    assert len(keys) == multiplier + 1, keys
    assert all(k[3] == beam for k in keys), keys
    assert int(port.enc_state.n_frames[0]) == 48 * (multiplier * n_full + 1)


class _HostReads(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in HOST_READS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_chunk_step_reads_the_host_once_a_beam_step():
    """Every push of one chunk (the first key's and the steady key's)
    reads the device steps + 1 times: ``done`` after each beam step's
    bookkeeping and the packed result once; the trim bookkeeping runs on
    the host from the packed vector."""
    agent = _port_agent(from_jax(jax.device_get(tiny_params()), device="cpu"),
                        1, 4)
    rng = np.random.RandomState(5)
    for _ in range(4):
        audio = rng.randn(agent.chunk_samples).astype(np.float32) * 0.1
        with _HostReads() as mode:
            agent.push(audio)
        steps = agent.last_result.steps
        assert 0 < mode.n <= steps + 1, (mode.n, steps)


def test_replays_count_what_their_capture_recorded():
    """The counts that a replay must keep true (the kernels' launches,
    llama's forwards) are registered with ``core.graphs``; the delta
    recorded around one chunk's pieces, added back after they are taken
    back, is what the chunk counted: one prefill and steps - 1 beam
    forwards, as its beam steps say."""
    from infinisst_tpu_torch.core import graphs
    from infinisst_tpu_torch.kernels import decode_attention as A
    from infinisst_tpu_torch.kernels import quant_matmul as K

    for counts in (K.launch_counts, K.internal_counts, A.launch_counts,
                   A.launch_shapes, TL.forward_counts):
        assert any(counts is c for c in graphs._counters)
    agent = _port_agent(from_jax(jax.device_get(tiny_params()), device="cpu"),
                        1, 4)
    audio = np.random.RandomState(6).randn(agent.chunk_samples) * 0.1
    snap = graphs._snapshot()
    agent.push(audio.astype(np.float32))
    counted = [dict(c) for c in graphs._counters]
    delta = graphs._delta(snap)
    graphs._restore(snap)
    graphs._add(delta)
    assert [dict(c) for c in graphs._counters] == counted
    L, steps = LCFG.num_layers, agent.last_result.steps
    want = {f"decode_step L={L}": 1}
    if steps > 1:
        want[f"beam_token_step L={L}"] = steps - 1
    assert dict(next(dd for d, dd in delta if d is TL.forward_counts)) == want
