"""The port's streaming agent as a whole.

1. The tiny float32 agent of ``tests/test_agent.py:make_agent`` (beam 2,
   parameters from the JAX ``init_params`` through ``from_jax``)
   reproduces ``tests/golden_agent_outputs.json`` token for token over the
   5 chunks of ``tests/test_golden_agent.py:_run_tiny_agent``.
2. W8A8 tiny variants (per-channel, and grouped with and without a
   grouped lm_head): one chunk of JAX ``prefill_chunk`` + ``beam_search``
   against the port: equal tokens, and prefill logits within 2e-3 of
   max|logits| (an activation on a rounding boundary may quantize one int8
   step apart between the frameworks; the kernels themselves are bitwise
   equal).
3. The agent's bookkeeping over a longer stream with evictions.
4. ``update_multiplier`` and ``InfiniSSTOptions.quantize`` against the JAX
   agent (equal tokens); a failed step keeps the deferred trim; an
   unwritable ``dpo_sampling`` file does not fail the stream.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.core.config import CONV_LEFT_CONTEXT
from infinisst_tpu.data.template import PromptBuilder as JPromptBuilder
from infinisst_tpu.data.template import StubTokenizer as JStub
from infinisst_tpu.decode import beam as JB
from infinisst_tpu.models import adapter as JA
from infinisst_tpu.models import quant as JQ
from infinisst_tpu.models import speech_llm as JSL
from infinisst_tpu.models import wav2vec2 as JW
from infinisst_tpu.streaming import state as JS
from infinisst_tpu_torch.agents.infinisst import (
    InfiniSSTAgent,
    InfiniSSTOptions,
)
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core import config as TC
from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
from infinisst_tpu_torch.decode import beam as TB
from infinisst_tpu_torch.models import speech_llm as TSL
from infinisst_tpu_torch.streaming import state as TS
from tests.test_agent import (
    CFG,
    VOCAB,
    make_agent,
    small_special_tokens,
    tiny_params,
)

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "golden_agent_outputs.json")


def _tokens():
    return TC.SpecialTokens(**small_special_tokens().__dict__)


def make_port_agent(params, max_llm_cache_size=120, capacity=256, **opt_kw):
    """The port's counterpart of tests/test_agent.py:make_agent."""
    cfg = TC.tiny_model_config(vocab_size=VOCAB).replace(tokens=_tokens())
    stream = TC.StreamConfig(max_cache_frames=96,
                             max_llm_cache_tokens=max_llm_cache_size,
                             llm_cache_capacity=capacity)
    builder = PromptBuilder(StubTokenizer(vocab_size=VOCAB, lo=10, hi=400),
                            cfg.tokens)
    opts = InfiniSSTOptions(beam=2, max_llm_cache_size=max_llm_cache_size,
                            no_repeat_ngram_lookback=32, **opt_kw)
    return InfiniSSTAgent(params, cfg, stream, builder, opts,
                          param_dtype=torch.float32, device="cpu")


def test_agent_reproduces_golden_outputs():
    agent = make_port_agent(from_jax(jax.device_get(tiny_params()),
                                     device="cpu"))
    rng = np.random.RandomState(1234)
    per_chunk = []
    for i in range(5):
        audio = rng.randn(agent.chunk_samples).astype(np.float32) * 0.1
        before = len(agent.states.target_ids)
        agent.push(audio, finished=(i == 4))
        per_chunk.append([int(t) for t in agent.states.target_ids[before:]])
    with open(FIXTURE) as f:
        want = json.load(f)["per_chunk_token_ids"]
    assert per_chunk == want


def test_reset_replays_the_stream():
    """``reset`` clears the caches, the history ring, the pending tokens
    and the host states: the same audio then gives the same tokens."""
    agent = make_port_agent(from_jax(jax.device_get(tiny_params()),
                                     device="cpu"))

    def run():
        rng = np.random.RandomState(1234)
        out = []
        for _ in range(2):
            before = len(agent.states.target_ids)
            agent.push(rng.randn(agent.chunk_samples).astype(np.float32)
                       * 0.1)
            out.append(list(agent.states.target_ids[before:]))
        return out

    first = run()
    agent.reset()
    assert agent.llm_cache_len == 0 and agent.states.target_ids == []
    assert int(agent.enc_state.n_frames[0]) == 0
    assert run() == first


def test_policy_reads_and_finishes_without_the_model():
    """Below ``min_start_sec`` the policy reads; a finished stream
    shorter than 0.32 s finishes with an empty write.  Neither path
    touches the model (the agent has no parameters)."""
    agent = make_port_agent(None, min_start_sec=2.0)
    assert agent.push(np.zeros(16000, np.float32)).is_read()
    agent = make_port_agent(None)
    act = agent.push(np.zeros(4000, np.float32), finished=True)
    assert not act.is_read() and act.finished and act.content == ""


def _check_w8a8_chunk(**quant_kw):
    """One chunk of JAX prefill + beam search against the port with W8A8
    weights made by JAX ``init_quantized_llama(**quant_kw)``."""
    k = jax.random.PRNGKey(0)
    jp = {
        "w2v2": JW.init_params(jax.random.fold_in(k, 0), CFG.w2v2),
        "adapter": JA.init_params(jax.random.fold_in(k, 1), CFG.adapter),
        "llama": JQ.init_quantized_llama(
            jax.random.fold_in(k, 2), CFG.llama, act_int8=True,
            lm_head_int8=True, embed_dtype=jnp.float32, **quant_kw,
        ),
    }
    tp = from_jax(jax.device_get(jp), device="cpu")
    tokens = small_special_tokens()
    prompt = JPromptBuilder(JStub(vocab_size=VOCAB, lo=10, hi=400),
                            tokens).chunk_prompt(1, True)
    win = (np.random.RandomState(2).randn(1, CONV_LEFT_CONTEXT + 2 * 15360)
           * 0.1).astype(np.float32)
    w, ll = CFG.w2v2, CFG.llama
    jstate = JSL.StreamState(
        JS.init_encoder_state(w.encoder_layers, 1, 96,
                              w.encoder_attention_heads, w.head_dim,
                              jnp.float32),
        JS.init_decoder_state(ll.num_layers, 1, 128, ll.num_kv_heads,
                              ll.head_dim, jnp.float32),
    )
    tstate = TSL.StreamState(
        TS.init_encoder_state(w.encoder_layers, 1, 96,
                              w.encoder_attention_heads, w.head_dim,
                              torch.float32, "cpu"),
        TS.init_decoder_state(ll.num_layers, 1, 128, ll.num_kv_heads,
                              ll.head_dim, torch.float32, "cpu"),
    )
    ids = prompt.ids.astype(np.int32)
    lj, sj = JSL.prefill_chunk(jp, CFG, jstate, jnp.asarray(win),
                               jnp.asarray(ids)[None], prompt.patch_start,
                               48, 96)
    lt, st = TSL.prefill_chunk(tp, TC.tiny_model_config(vocab_size=VOCAB),
                               tstate, torch.from_numpy(win),
                               torch.from_numpy(ids).long()[None],
                               prompt.patch_start, 48, 96)
    err = np.abs(lt.numpy() - np.asarray(lj)).max()
    assert err <= 2e-3 * np.abs(np.asarray(lj)).max(), err

    spec = dict(beam=4, max_new_tokens=10, eos_id=tokens.eos,
                pad_id=tokens.pad, no_repeat_ngram_size=5,
                repetition_penalty=1.2)
    hist = np.full((32,), tokens.pad, np.int32)
    want = JB.beam_search(
        jp["llama"], CFG.llama, sj.decoder, lj[0, -1], jnp.asarray(ids),
        jnp.asarray(len(ids), jnp.int32), jnp.asarray(hist),
        jnp.asarray(0, jnp.int32), JB.BeamSpec(**spec), encoder_ngram_size=5,
    )
    got = TB.beam_search(
        tp["llama"], CFG.llama, st.decoder, lt[0, -1],
        torch.from_numpy(ids).long(), len(ids),
        torch.from_numpy(hist).long(), 0, TB.BeamSpec(**spec),
        encoder_ngram_size=5,
    )
    assert got.tokens == np.asarray(want.tokens).tolist()
    assert got.n_tokens == int(want.n_tokens)


def test_w8a8_chunk_matches_jax():
    _check_w8a8_chunk()


@pytest.mark.parametrize("head_group_size", [None, 32])
def test_grouped_w8a8_chunk_matches_jax(head_group_size):
    """The ``--group128`` layout at tiny widths: groups of 32 on every
    projection (G = 2, and 4 on the down projection), with the per-channel
    or a grouped lm_head; JAX runs it through its XLA path."""
    _check_w8a8_chunk(group_size=32, head_group_size=head_group_size)


def test_agent_long_stream_bookkeeping():
    """Many eviction cycles: the logical cache mirror stays bounded and
    equals the physical cache plus the pending tokens; the encoder
    consumed every frame; the tail chunk is padded and finishes."""
    agent = make_port_agent(
        from_jax(jax.device_get(tiny_params()), device="cpu"),
        max_llm_cache_size=64, capacity=160,
    )
    rng = np.random.RandomState(11)
    peak = 0
    n = 12
    for i in range(n):
        act = agent.push(rng.randn(agent.chunk_samples).astype(np.float32)
                         * 0.1)
        peak = max(peak, agent.llm_cache_len)
    act = agent.push(rng.randn(5000).astype(np.float32) * 0.1, finished=True)
    assert not act.is_read() and act.finished
    assert int(agent.enc_state.n_frames[0]) == (n + 1) * 48
    assert agent.evictions >= 3
    assert peak <= 64 + agent.system_prompt_size + 21 + agent.max_new
    agent.flush_pending_evict()
    assert agent.llm_cache_len == (
        int(agent.dec_state.valid_len[0]) + agent.pend_n_host
    )


@pytest.mark.parametrize("option", ["speculative", "do_sample", "spec_beam"])
def test_unported_options_raise(option):
    """The options that raised before the speculative stack was ported
    now run a chunk (spec_beam together with speculative, as the JAX
    agent needs); what the JAX agent refuses still raises ValueError."""
    tp = from_jax(jax.device_get(tiny_params()), device="cpu")
    kw = dict(spec_draft_layers=1, spec_k=2, **{option: True})
    if option == "spec_beam":
        kw["speculative"] = True
    agent = make_port_agent(tp, **kw)
    rng = np.random.RandomState(0)
    agent.push(rng.randn(agent.chunk_samples).astype(np.float32) * 0.1)
    assert agent.states.target_ids
    assert (agent.spec_rounds > 0) == (option != "do_sample")
    with pytest.raises(ValueError):
        make_port_agent(tp, speculative=True, spec_beam=True,
                        do_sample=True)


def _push_chunks(agent, rng, sizes):
    out = []
    for n in sizes:
        before = len(agent.states.target_ids)
        agent.push(rng.randn(n).astype(np.float32) * 0.1)
        out.append([int(t) for t in agent.states.target_ids[before:]])
    return out


def test_update_multiplier_matches_jax():
    """One chunk at m=1, then ``update_multiplier(2)`` and one chunk at
    m=2 (JAX ``tests/test_agent.py:test_update_multiplier_mid_stream``):
    the geometry follows m, the encoder consumed 48 + 96 frames, and each
    chunk's tokens equal the JAX agent's over the same audio."""
    port = make_port_agent(from_jax(jax.device_get(tiny_params()),
                                    device="cpu"))
    jax_agent = make_agent(multiplier=1)
    got, want = [], []
    for agent, out in ((port, got), (jax_agent, want)):
        rng = np.random.RandomState(7)
        out += _push_chunks(agent, rng, [15360])
        assert agent.chunk_samples == 15360
        agent.update_multiplier(2)
        assert (agent.chunk_samples, agent.chunk_frames, agent.max_new) == \
            (30720, 96, 20)
        out += _push_chunks(agent, rng, [30720])
        assert int(agent.enc_state.n_frames[0]) == 48 + 96
    assert got == want and any(got[1]), (got, want)
    with pytest.raises(ValueError, match="outside 1..4"):
        port.update_multiplier(5)


# widths that tile by 128 columns, as quantize_llama_params requires
WIDE_CFG = CFG.replace(
    adapter=CFG.adapter.__class__(conv_layers=CFG.adapter.conv_layers,
                                  in_dim=64, out_dim=256),
    llama=CFG.llama.__class__(vocab_size=VOCAB, hidden_size=256,
                              intermediate_size=384, num_layers=2,
                              num_heads=2, num_kv_heads=1, head_dim=128,
                              rope_scaling=False),
)


def test_quantize_option_matches_jax(monkeypatch):
    """``InfiniSSTOptions.quantize``: the agent's Llama leaves equal JAX
    ``quantize_llama_params`` (packed K-major), and one chunk gives the
    JAX agent's tokens (its weight-only Pallas kernel in interpret
    mode)."""
    from infinisst_tpu.agents.infinisst import InfiniSSTAgent as JAgent
    from infinisst_tpu.agents.infinisst import InfiniSSTOptions as JOptions
    from infinisst_tpu.core.config import StreamConfig as JStream
    from infinisst_tpu.kernels.quant_matmul import quantized_matmul
    from infinisst_tpu.models import llama as JL

    monkeypatch.setattr(
        JQ, "quantized_matmul",
        lambda y, w, s, interpret=False: quantized_matmul(
            y, w, s, tile_o=128, interpret=True),
    )
    k = jax.random.PRNGKey(0)
    jp = {
        "w2v2": JW.init_params(jax.random.fold_in(k, 0), WIDE_CFG.w2v2),
        "adapter": JA.init_params(jax.random.fold_in(k, 1),
                                  WIDE_CFG.adapter),
        "llama": JL.init_params(jax.random.fold_in(k, 2), WIDE_CFG.llama),
    }
    port_cfg = TC.ModelConfig(
        w2v2=TC.W2V2Config(**WIDE_CFG.w2v2.__dict__),
        adapter=TC.AdapterConfig(**WIDE_CFG.adapter.__dict__),
        llama=TC.LlamaConfig(**WIDE_CFG.llama.__dict__),
        tokens=_tokens(),
    )
    stream = TC.StreamConfig(max_cache_frames=96, max_llm_cache_tokens=120,
                             llm_cache_capacity=256)
    builder = PromptBuilder(StubTokenizer(vocab_size=VOCAB, lo=10, hi=400),
                            port_cfg.tokens)
    port = InfiniSSTAgent(
        from_jax(jax.device_get(jp), device="cpu"), port_cfg, stream,
        builder, InfiniSSTOptions(beam=2, max_llm_cache_size=120,
                                  no_repeat_ngram_lookback=32,
                                  quantize=True),
        param_dtype=torch.float32, device="cpu",
    )
    want_llama = from_jax(jax.device_get(JQ.quantize_llama_params(
        jp["llama"])), device="cpu")
    got_layers = port.params["llama"]["layers"]
    for name in JQ.QUANT_KEYS:
        assert set(got_layers[name]) == {"q_kmajor", "scale"}
        for key in ("q_kmajor", "scale"):
            assert torch.equal(got_layers[name][key],
                               want_llama["layers"][name][key]), name
    assert torch.equal(port.params["llama"]["lm_head"],
                       want_llama["lm_head"])

    jax_agent = JAgent(
        jp, WIDE_CFG.replace(tokens=small_special_tokens()),
        JStream(max_cache_frames=96, max_llm_cache_tokens=120,
                llm_cache_capacity=256),
        JPromptBuilder(JStub(vocab_size=VOCAB, lo=10, hi=400),
                       small_special_tokens()),
        JOptions(beam=2, max_llm_cache_size=120, no_repeat_ngram_lookback=32,
                 quantize=True),
        param_dtype=jnp.float32,
    )
    got = _push_chunks(port, np.random.RandomState(3), [15360])
    want = _push_chunks(jax_agent, np.random.RandomState(3), [15360])
    assert got == want and any(got[0]), (got, want)


def test_failed_step_keeps_the_deferred_trim(monkeypatch):
    """A chunk step that raises before its eviction has run keeps the
    trim for the next step; the next step applies it with the system
    prompt pinned, and on the success path nothing else changes."""
    from infinisst_tpu_torch.models import llama as TL

    agent = make_port_agent(
        from_jax(jax.device_get(tiny_params()), device="cpu"),
        max_llm_cache_size=64, capacity=160,
    )
    rng = np.random.RandomState(11)
    while agent._pending_evict is None:
        agent.push(rng.randn(agent.chunk_samples).astype(np.float32) * 0.1)
    pending = agent._pending_evict
    sys_len = agent.system_prompt_size
    assert pending[1] == sys_len > 0
    sys_k = agent.dec_state.k[:, :, :sys_len].clone()
    evict = TL.evict_cache

    def fail(*a, **k):
        raise RuntimeError("step failed before its eviction")

    monkeypatch.setattr(TL, "evict_cache", fail)
    with pytest.raises(RuntimeError, match="before its eviction"):
        agent.push(rng.randn(agent.chunk_samples).astype(np.float32) * 0.1)
    assert agent._pending_evict == pending
    monkeypatch.setattr(TL, "evict_cache", evict)
    seen = []

    def spy(state, keep, sys):
        seen.append((int(keep[0]), int(sys)))
        return evict(state, keep, sys)

    monkeypatch.setattr(TL, "evict_cache", spy)
    agent.push(rng.randn(agent.chunk_samples).astype(np.float32) * 0.1)
    assert seen[0] == pending
    assert torch.equal(agent.dec_state.k[:, :, :sys_len], sys_k)
    agent.flush_pending_evict()
    assert agent.llm_cache_len == (
        int(agent.dec_state.valid_len[0]) + agent.pend_n_host
    )


def test_unwritable_translation_file_still_writes(tmp_path, capsys):
    """``dpo_sampling`` appends the stream's translations at its end; an
    unwritable file is reported and the ``WriteAction`` is returned, as
    in the JAX agent."""
    agent = make_port_agent(
        from_jax(jax.device_get(tiny_params()), device="cpu"),
        dpo_sampling=True, output_file=str(tmp_path / "no_dir" / "t.json"),
    )
    act = agent.push(np.random.RandomState(2).randn(15360).astype(
        np.float32) * 0.1, finished=True)
    assert not act.is_read() and act.finished
    assert "Error writing translations to file" in capsys.readouterr().out
