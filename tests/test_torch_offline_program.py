"""The AlignAtt / StreamAtt call as one device program per (n_units,
prompt bucket), as JAX jits ``_offline_fn``, against the JAX package on
the CPU at the tiny config of ``tests/test_torch_alignatt.py`` (its JAX
``decode_step`` wrapped to read the prefill probe over the prompt's own
span, ``shift_jax_probe``; no JAX file is edited).

- Two calls in one key, with other prompt lengths, step caps and stop
  zones, equal to JAX's jitted ``offline_generate`` on tokens, the probed
  trace and the prefill's probes, parity and early stop; one program is
  made and reused.
- A call reads the host at most steps + 1 times (counted under a
  ``TorchFunctionMode``, as ``tests/test_torch_chunk_program.py``).
- The program's static buffers keep their addresses across calls and
  keys (a CUDA graph replays on them).
- A call that raises inside ``beam_forward`` leaves the agent's states
  as they were, and the next call equals a fresh agent's.

float32 on both sides; tokens and indices are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.agents.alignatt import AlignAttAgent as JAlignAtt
from infinisst_tpu.agents.alignatt import AlignAttOptions as JAlignAttOpts
from infinisst_tpu_torch.agents.alignatt import AlignAttAgent, AlignAttOptions
from infinisst_tpu_torch.agents.streamatt import (
    StreamAttAgent,
    StreamAttOptions,
)
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core.config import CONV_LEFT_CONTEXT
from infinisst_tpu_torch.decode import beam as TB
from tests.test_agent import tiny_params
from tests.test_torch_alignatt import (
    CHUNK,
    _jax_agent,
    _port_agent,
    shift_jax_probe,
)
from tests.test_torch_chunk_program import _HostReads

torch.set_num_threads(1)

N_UNITS = 2


@pytest.fixture(scope="module")
def params():
    jp = tiny_params()
    return jp, from_jax(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def shifted():
    with pytest.MonkeyPatch.context() as mp:
        shift_jax_probe(mp)
        yield


def _inputs(agent, seed, n_target):
    """One call's inputs as the policy builds them: N_UNITS units of
    seeded noise, the offline prompt with ``n_target`` target ids, padded
    to its bucket.  Returns (audio (1, T) f32, ids (1, pbucket), plen)."""
    rng = np.random.RandomState(seed)
    audio = np.zeros((1, CONV_LEFT_CONTEXT + N_UNITS * CHUNK), np.float32)
    audio[0, CONV_LEFT_CONTEXT:] = rng.randn(N_UNITS * CHUNK) * 0.1
    target = list(rng.randint(10, 400, size=n_target))
    prompt = agent.builder.offline_prompt(12 * N_UNITS, target)
    plen = len(prompt.ids)
    pbucket = -(-plen // 64) * 64
    ids = np.full((1, pbucket), agent.cfg.tokens.pad, np.int64)
    ids[0, :plen] = prompt.ids
    return audio, ids, plen


# (target ids, max_steps, stop_idx) of the two calls, one key
CALLS = ((3, 9, 14), (11, 16, 20))


@pytest.mark.parametrize("early_stop", [False, True])
def test_two_calls_in_one_key_match_jax(params, shifted, early_stop):
    jp, tp = params
    port = _port_agent(tp, AlignAttAgent, AlignAttOptions,
                       attn_early_stop=early_stop)
    jax_agent = _jax_agent(jp, JAlignAtt, JAlignAttOpts,
                           attn_early_stop=early_stop)
    G = port.opts.decode_buf_tokens
    buckets = set()
    for seed, (n_tgt, max_steps, stop) in enumerate(CALLS):
        audio, ids, plen = _inputs(port, seed, n_tgt)
        buckets.add(ids.shape[1])
        res, probes = port._offline_generate(audio, ids, plen, N_UNITS,
                                             max_steps, stop)
        fn = jax_agent._offline_fn(N_UNITS, ids.shape[1])
        want, jprobes = jax.device_get(fn(
            jax_agent.params, jnp.asarray(audio), jnp.asarray(ids, jnp.int32),
            jnp.asarray(plen, jnp.int32), jnp.asarray(max_steps, jnp.int32),
            jnp.asarray(stop, jnp.int32)))
        n = int(want.n_tokens)
        assert res.n_tokens == n and res.steps == int(want.steps)
        assert res.hit_eos == bool(want.hit_eos)
        assert res.tokens[:n] == want.tokens[:n].tolist()
        assert res.attn_idx == want.attn_idx.tolist()
        assert probes == jprobes[0].tolist()
        assert len(probes) == ids.shape[1]
    assert len(buckets) == 1, buckets
    assert list(port._programs) == [(N_UNITS, buckets.pop())]


def test_a_call_reads_the_host_steps_plus_one_times(params):
    _, tp = params
    agent = _port_agent(tp, AlignAttAgent, AlignAttOptions)
    rng = np.random.RandomState(2)
    for _ in range(3):
        with _HostReads() as mode:
            agent.push(rng.randn(CHUNK).astype(np.float32) * 0.1)
        steps = agent.last_result.steps
        assert 0 < mode.n <= steps + 1, (mode.n, steps)


def _addresses(agent):
    buf = agent._offline
    ptrs = {f"shared {name}": t.data_ptr() for name, t in
            (("k", buf.k), ("v", buf.v), ("valid_len", buf.valid_len),
             ("hist", buf.hist), ("hist_len", buf.hist_len))}
    ptrs.update({f"loop {f}": t.data_ptr() for f, t in
                 zip(TB.BeamLoop._fields, buf.loop) if t is not None})
    for key, prog in agent._programs.items():
        for name, t in zip(("audio", "ids", "scalars"), prog.inputs):
            ptrs[f"{key} {name}"] = t.data_ptr()
        ptrs[f"{key} packed"] = prog.packed.data_ptr()
    return ptrs


def test_static_buffers_keep_their_addresses(params):
    """Over StreamAtt calls at two audio lengths (two keys) and several
    prompt lengths, every buffer a program reads or writes keeps its
    address, and every key's cache is a view of the shared one."""
    _, tp = params
    agent = _port_agent(tp, StreamAttAgent, StreamAttOptions,
                        text_preserve_num=2, min_speech_duration=0.5,
                        max_speech_duration=2.88, length_bucket_chunks=1,
                        max_audio_chunks=3)
    rng = np.random.RandomState(6)
    seen = {}
    for _ in range(6):
        agent.push(rng.randn(CHUNK).astype(np.float32) * 0.1)
        for name, ptr in _addresses(agent).items():
            assert seen.setdefault(name, ptr) == ptr, name
    assert len(agent._programs) >= 2, list(agent._programs)


def test_a_failed_call_leaves_the_states_and_the_next_call_matches(
        params, monkeypatch):
    _, tp = params
    rng = np.random.RandomState(9)
    chunks = [rng.randn(CHUNK).astype(np.float32) * 0.1 for _ in range(3)]
    agent = _port_agent(tp, AlignAttAgent, AlignAttOptions)
    fresh = _port_agent(tp, AlignAttAgent, AlignAttOptions)
    for c in chunks[:2]:
        agent.push(c)
        fresh.push(c)
    st = agent.states
    before = (list(st.target_ids), list(st.most_attended_indices), st.src_len)
    forward = TB.beam_forward
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("beam_forward failed")
        return forward(*a, **kw)

    monkeypatch.setattr(TB, "beam_forward", broken)
    with pytest.raises(RuntimeError, match="beam_forward failed"):
        agent.push(chunks[2])
    monkeypatch.setattr(TB, "beam_forward", forward)
    assert (list(st.target_ids), list(st.most_attended_indices),
            st.src_len) == before
    act = agent.policy()
    want = fresh.push(chunks[2])
    assert (act.is_read(), getattr(act, "content", None)) == (
        want.is_read(), getattr(want, "content", None))
    assert st.target_ids == fresh.states.target_ids
    assert st.most_attended_indices == fresh.states.most_attended_indices
    assert agent.last_result == fresh.last_result
