"""The port's AlignAtt slice against the JAX package, on the CPU at the
tiny config of ``tests/test_alignatt.py:_mk``: the block-causal mask, the
offline wav2vec2 ``forward``, the attention probe of ``decode_step`` and
``beam_token_step``, the probed ``beam_search``, the AlignAtt and
StreamAtt agents push by push, and ``translate_waveform``.

The JAX ``decode_step`` slices its probe at a0:a1 of [cache (C) | new
(S)], so on the fresh cache of an AlignAtt prefill it reads the masked
cache block and returns 0 on every row (``test_jax_prefill_probe_reads_
the_empty_cache``).  The port reads the prompt's own span, C + a0 :
C + a1; the JAX side is held to it by calling its ``decode_step`` with
the span shifted by C (its agents through a wrapper installed for this
module only; no JAX file is edited).

float32 on both sides.  Probed indices and tokens must be equal; values
agree to the tolerance each test states (sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.agents.alignatt import AlignAttAgent as JAlignAtt
from infinisst_tpu.agents.alignatt import AlignAttOptions as JAlignAttOpts
from infinisst_tpu.agents.streamatt import StreamAttAgent as JStreamAtt
from infinisst_tpu.agents.streamatt import StreamAttOptions as JStreamAttOpts
from infinisst_tpu.core import masks as JM
from infinisst_tpu.core.config import CONV_LEFT_CONTEXT
from infinisst_tpu.core.config import StreamConfig as JStreamConfig
from infinisst_tpu.data.template import PromptBuilder as JPromptBuilder
from infinisst_tpu.data.template import StubTokenizer as JStub
from infinisst_tpu.decode import beam as JB
from infinisst_tpu.models import llama as JL
from infinisst_tpu.models import wav2vec2 as JW
from infinisst_tpu.streaming.state import init_decoder_state
from infinisst_tpu.tools import translate as JTR
from infinisst_tpu_torch.agents.alignatt import AlignAttAgent, AlignAttOptions
from infinisst_tpu_torch.agents.streamatt import (
    StreamAttAgent,
    StreamAttOptions,
)
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core import config as TC
from infinisst_tpu_torch.core import masks as TM
from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
from infinisst_tpu_torch.decode import beam as TB
from infinisst_tpu_torch.models import llama as TL
from infinisst_tpu_torch.models import wav2vec2 as TW
from infinisst_tpu_torch.streaming.state import DecoderState as TDS
from infinisst_tpu_torch.tools import translate as TTR
from tests.test_agent import CFG, small_special_tokens, tiny_params

torch.set_num_threads(1)

CHUNK = 15360  # 960 ms
LCFG = CFG.llama


@pytest.fixture(scope="module")
def params():
    jp = tiny_params()
    return jp, from_jax(jax.device_get(jp), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _opts(**kw):
    base = dict(latency_multiplier=1, beam=2, attn_layer=1, frame_num=1,
                length_bucket_chunks=2, decode_buf_tokens=16,
                no_repeat_ngram_lookback=16)
    base.update(kw)
    return base


def _jax_agent(jp, cls, opts_cls, **kw):
    """tests/test_alignatt.py:_mk."""
    cfg = CFG.replace(tokens=small_special_tokens())
    stream = JStreamConfig(max_cache_frames=96, llm_cache_capacity=256)
    builder = JPromptBuilder(JStub(512, lo=10, hi=400), cfg.tokens)
    return cls(jp, cfg, stream, builder, opts_cls(**_opts(**kw)),
               param_dtype=jnp.float32)


def _port_agent(tp, cls, opts_cls, **kw):
    cfg = TC.tiny_model_config(vocab_size=512).replace(
        tokens=TC.SpecialTokens(**small_special_tokens().__dict__))
    stream = TC.StreamConfig(max_cache_frames=96, llm_cache_capacity=256)
    builder = PromptBuilder(StubTokenizer(512, lo=10, hi=400), cfg.tokens)
    return cls(tp, cfg, stream, builder, opts_cls(**_opts(**kw)),
               param_dtype=torch.float32, device="cpu")


def shift_jax_probe(mp):
    """Install, through the monkeypatch ``mp``, a JAX ``decode_step`` whose
    probe span is shifted by the cache width, so that it reads the new
    block as the port does."""
    orig = JL.decode_step

    def shifted(params, cfg, state, x_embed, valid_mask=None,
                attn_probe=None):
        if attn_probe is not None:
            C = state.k.shape[2]
            attn_probe = (attn_probe[0], attn_probe[1] + C,
                          attn_probe[2] + C)
        return orig(params, cfg, state, x_embed, valid_mask=valid_mask,
                    attn_probe=attn_probe)

    mp.setattr(JL, "decode_step", shifted)


@pytest.fixture(scope="module")
def shifted_jax_probe():
    with pytest.MonkeyPatch.context() as mp:
        shift_jax_probe(mp)
        yield


# ---------------------------------------------------------------------------
# the mask and the offline encoder


@pytest.mark.parametrize("seq,cache,block", [
    (12, None, 1), (12, None, 4), (20, 6, 4), (48, 10**7, 10**7),
    (30, 0, 5), (17, 3, 1),
])
def test_block_causal_mask_matches_jax(seq, cache, block):
    want = np.asarray(JM.block_causal_mask(seq, cache, block))
    got = TM.block_causal_mask(seq, cache, block).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lengths,block,cache", [
    (None, 10**7, 10**7), ([96, 70], 10**7, 10**7), (None, 8, 24),
    ([96, 41], 16, 40),
])
def test_wav2vec2_forward_matches_jax(params, lengths, block, cache):
    """Two rows of 1.92 s: bidirectional (the AlignAtt encoder) and block
    -causal with a window, with and without frame_lengths; float32 within
    1e-5."""
    jp, tp = params
    rng = np.random.RandomState(8)
    x = (rng.randn(2, CONV_LEFT_CONTEXT + 2 * CHUNK) * 0.1).astype(
        np.float32)
    fl = None if lengths is None else np.asarray(lengths, np.int32)
    want = JW.forward(jp["w2v2"], CFG.w2v2, jnp.asarray(x), block, cache,
                      frame_lengths=None if fl is None else jnp.asarray(fl))
    got = TW.forward(tp["w2v2"], TC.tiny_model_config(512).w2v2, _t(x),
                     block, cache,
                     frame_lengths=None if fl is None else _t(fl).long())
    assert got.shape == want.shape == (2, 96, CFG.w2v2.encoder_embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_offline_prompt_matches_jax():
    toks = small_special_tokens()
    jb = JPromptBuilder(JStub(512, lo=10, hi=400), toks, "English",
                        "Chinese")
    tb = PromptBuilder(StubTokenizer(512, lo=10, hi=400),
                       TC.SpecialTokens(**toks.__dict__), "English",
                       "Chinese")
    assert tb.offline_system_text() == jb.offline_system_text()
    for n, tgt in ((24, []), (360, [11, 12, 13])):
        w, g = jb.offline_prompt(n, tgt), tb.offline_prompt(n, tgt)
        np.testing.assert_array_equal(g.ids, w.ids)
        assert (g.patch_start, g.n_patches) == (w.patch_start, w.n_patches)


# ---------------------------------------------------------------------------
# the probe


def _prefill_inputs(seed=3, S=24, C=40):
    rng = np.random.RandomState(seed)
    x = (rng.randn(1, S, LCFG.hidden_size) * 0.5).astype(np.float32)
    valid = (np.arange(S)[None] < S - 3).astype(np.int32)
    st = init_decoder_state(LCFG.num_layers, 1, C, LCFG.num_kv_heads,
                            LCFG.head_dim, jnp.float32)
    return x, valid, st


def _port_state(st):
    return TDS(k=_t(st.k).clone(), v=_t(st.v).clone(),
               valid_len=_t(st.valid_len).long())


def test_decode_step_probe_matches_jax_shifted(params):
    """The port's prefill probe over the new block's span (4, 16) equals
    JAX's called with the span shifted by C = 40; the logits agree."""
    jp, tp = params
    x, valid, st = _prefill_inputs()
    C = st.k.shape[2]
    lw, _, pw = JL.decode_step(jp["llama"], LCFG, st, jnp.asarray(x),
                               valid_mask=jnp.asarray(valid),
                               attn_probe=(1, 4 + C, 16 + C))
    lg, state, pg = TL.decode_step(tp["llama"], LCFG, _port_state(st), _t(x),
                                   valid_mask=_t(valid).long(),
                                   attn_probe=(1, 4, 16))
    assert pg.shape == (1, 24) and int(state.valid_len[0]) == 21
    np.testing.assert_array_equal(pg.numpy(), np.asarray(pw))
    # rows 8.. see the span (causal): their argmaxes are not all 0
    assert pg[0, 8:].unique().numel() > 1
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(lw)).max())
    # without a probe the step returns (logits, state), as before
    assert len(TL.decode_step(tp["llama"], LCFG, _port_state(st), _t(x))) == 2


def test_jax_prefill_probe_reads_the_empty_cache(params):
    """The JAX fault the port does not copy: called as its AlignAtt agent
    calls it (fresh cache, the span unshifted), JAX's probe is 0 on every
    row; the port's is not."""
    jp, tp = params
    x, valid, st = _prefill_inputs()
    _, _, pw = JL.decode_step(jp["llama"], LCFG, st, jnp.asarray(x),
                              valid_mask=jnp.asarray(valid),
                              attn_probe=(1, 4, 16))
    assert np.asarray(pw).tolist() == [[0] * 24]
    _, _, pg = TL.decode_step(tp["llama"], LCFG, _port_state(st), _t(x),
                              valid_mask=_t(valid).long(),
                              attn_probe=(1, 4, 16))
    assert pg.numpy().max() > 0


def _prefix(jp, seed=5, n=30, C=48):
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, 500, (n,)).astype(np.int32)
    st = init_decoder_state(LCFG.num_layers, 1, C, LCFG.num_kv_heads,
                            LCFG.head_dim, jnp.float32)
    logits, st = JL.decode_step(jp["llama"], LCFG, st,
                                JL.embed(jp["llama"], jnp.asarray(prompt)[None]))
    return prompt, st, logits[0, -1]


@pytest.mark.parametrize("layer", [1, 0, -1])
def test_beam_token_step_probe_matches_jax(params, layer):
    """Three beams at generated length 2 over a 30-key prefix, the span
    (5, 23): equal probes; logits within 1e-5 relative."""
    jp, tp = params
    _, st, _ = _prefix(jp)
    rng = np.random.RandomState(6)
    beam, G = 3, 6
    L, KV, Dh = LCFG.num_layers, LCFG.num_kv_heads, LCFG.head_dim
    gk = (rng.randn(L, beam, G, KV, Dh) * 0.5).astype(np.float32)
    gv = (rng.randn(L, beam, G, KV, Dh) * 0.5).astype(np.float32)
    x = (rng.randn(beam, 1, LCFG.hidden_size) * 0.5).astype(np.float32)
    probe = (layer, 5, 23)
    lw, _, _, aw = JL.beam_token_step(jp["llama"], LCFG, st, jnp.asarray(gk),
                                      jnp.asarray(gv), jnp.asarray(2),
                                      jnp.asarray(x), attn_probe=probe)
    lg, _, _, ag = TL.beam_token_step(tp["llama"], LCFG, _port_state(st),
                                      _t(gk), _t(gv), 2, _t(x),
                                      attn_probe=probe)
    np.testing.assert_array_equal(ag.numpy(), np.asarray(aw))
    assert ag.numpy().max() > 0
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(lw)).max())
    _, _, _, none = TL.beam_token_step(tp["llama"], LCFG, _port_state(st),
                                       _t(gk), _t(gv), 2, _t(x))
    assert none.tolist() == [-1] * beam


@pytest.mark.parametrize("stop", [None, 12, 0])
def test_probed_beam_search_matches_jax(params, stop):
    """``beam_search`` with the probe, the prefill's index as the first
    token's, and the early stop at ``stop`` (0: every beam is in the zone
    at once): equal tokens, lengths, steps, EOS flag and attention
    trace."""
    jp, tp = params
    prompt, st, first = _prefix(jp)
    spec = dict(beam=3, max_new_tokens=10, eos_id=501, pad_id=504,
                no_repeat_ngram_size=3, repetition_penalty=1.2)
    probe = (1, 4, 26)
    want = JB.beam_search(
        jp["llama"], LCFG, st, first, jnp.asarray(prompt),
        jnp.asarray(30, jnp.int32), jnp.zeros((1,), jnp.int32),
        jnp.asarray(0, jnp.int32), JB.BeamSpec(**spec),
        max_steps=jnp.asarray(9, jnp.int32), attn_probe=probe,
        first_attn_idx=jnp.asarray(7, jnp.int32),
        attn_stop_idx=None if stop is None else jnp.asarray(stop, jnp.int32),
    )
    got = TB.beam_search(
        tp["llama"], LCFG, _port_state(st), _t(first), _t(prompt).long(), 30,
        torch.zeros((1,), dtype=torch.int64), 0, TB.BeamSpec(**spec),
        max_steps=9, attn_probe=probe, first_attn_idx=7, attn_stop_idx=stop,
    )
    assert got.tokens == np.asarray(want.tokens).tolist()
    assert got.n_tokens == int(want.n_tokens)
    assert got.steps == int(want.steps)
    assert got.hit_eos == bool(want.hit_eos)
    assert got.attn_idx == np.asarray(want.attn_idx).tolist()
    assert got.attn_idx[0] == 7
    if stop == 0:
        assert got.steps == 1
    elif stop is None:
        assert got.steps == 9


# ---------------------------------------------------------------------------
# the agents, push by push


def _push_run(agent, n, seed, finish, record):
    """``record`` after every push, and the port agent's (beam steps,
    max_steps) of each call."""
    rng = np.random.RandomState(seed)
    out, calls = [], []
    for i in range(n):
        act = agent.push(rng.randn(CHUNK).astype(np.float32) * 0.1,
                         finished=finish and i == n - 1)
        out.append(record(agent, act))
        if hasattr(agent, "last_call"):
            calls.append((agent.last_result.steps,
                          agent.last_call["max_steps"]))
    return out, calls


def _aa_record(agent, act):
    return (act.is_read(), None if act.is_read() else
            (act.content, act.finished),
            list(agent.states.target_ids),
            [int(a) for a in agent.states.most_attended_indices])


def _sa_record(agent, act):
    return (act.is_read(), len(agent.states.source),
            list(agent.states.target_ids))


# the runs, shared by the tests below: (label, agent kind, options, pushes,
# seed, record)
RUNS = {
    "parity": ("alignatt", {}, 4, 0, _aa_record),
    "early_stop": ("alignatt", dict(attn_early_stop=True), 4, 4, _aa_record),
    "streamatt": ("streamatt", dict(text_preserve_num=2,
                                    min_speech_duration=0.5,
                                    max_speech_duration=1.5,
                                    target_lang="Chinese"), 5, 1,
                  _sa_record),
}


@pytest.fixture(scope="module")
def runs(params, shifted_jax_probe):
    jp, tp = params
    kinds = {"alignatt": ((JAlignAtt, JAlignAttOpts),
                          (AlignAttAgent, AlignAttOptions)),
             "streamatt": ((JStreamAtt, JStreamAttOpts),
                           (StreamAttAgent, StreamAttOptions))}
    out = {}
    for label, (kind, kw, n, seed, record) in RUNS.items():
        (jc, jo), (tc, to) = kinds[kind]
        ja, ta = _jax_agent(jp, jc, jo, **kw), _port_agent(tp, tc, to, **kw)
        finish = kind == "alignatt"
        want, _ = _push_run(ja, n, seed, finish, record)
        got, calls = _push_run(ta, n, seed, finish, record)
        out[label] = (want, got, ja, ta, calls)
    return out


@pytest.mark.parametrize("label", ["parity", "early_stop"])
def test_alignatt_agent_matches_jax(runs, label):
    """Equal actions, target ids and most-attended indices after every
    push, through the finished one."""
    want, got, _, _, calls = runs[label]
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, (label, i)
    assert got[-1][1][1] is True  # finished
    assert got[-1][2]  # the finished push emits
    assert any(g[3] for g in got[:-1])  # a history trace mid-stream
    stopped = [s < m for s, m in calls[:-1]]
    # the early stop ends a mid-stream loop before its cap; parity never
    assert any(stopped) == (label == "early_stop"), calls


def test_streamatt_agent_matches_jax(runs):
    """Equal source lengths and target ids after every push; the history
    pruning keeps at most 1.5 s of audio and two words."""
    want, got, _, ta, _ = runs["streamatt"]
    assert got == want
    assert all(n <= int(1.5 * 16000) for _, n, _ in got)
    assert any(n < (i + 1) * CHUNK for i, (_, n, _) in enumerate(got))
    assert len(ta.states.target_ids) <= 2


def test_translate_waveform_matches_jax(runs):
    """The offline condition on the parity run's agents (reset first): a
    2.5 s waveform, pushed whole and finished, translates to the same
    text."""
    _, _, ja, ta, _ = runs["parity"]
    wav = (np.random.RandomState(12).randn(40000) * 0.1).astype(np.float32)
    want = JTR.translate_waveform(ja, wav)
    got = TTR.translate_waveform(ta, wav)
    assert got == want and got
    assert TTR.translate_waveform(ta, wav[:4000]) == ""  # under 0.32 s
