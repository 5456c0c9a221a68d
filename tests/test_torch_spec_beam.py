"""The port's speculative beam search against the JAX package on the CPU
at the tiny decoder of ``tests/test_speculative.py`` (float32):
``llama.beam_tree_step`` (the prefix block through ``decode_attention``'s
plain version, the per-beam and tree blocks in float32, merged by their
log-sum-exp) and ``decode/spec_beam.spec_beam_search``.

- ``beam_tree_step`` on a reparenting tree against JAX's: logits within
  1e-5 (one softmax there, three merged blocks here); the tree K/V
  within 1e-5 (float32 projections summed in another order: a few ulps
  at the first layer, the attention's differences above it);
  and against the port's own sequential ``beam_token_step`` chain within
  2e-4, as the JAX test holds JAX's.
- ``spec_beam_search``: the winner (tokens, length, hit_eos, steps) of the
  port's ``beam_search`` and of JAX's ``spec_beam_search`` exactly, the
  score within 1e-4; rounds, drafted and accepted equal JAX's.
Mirrors ``tests/test_spec_beam.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.decode import beam as JB
from infinisst_tpu.decode import spec_beam as JSB
from infinisst_tpu.models import llama as JL
from infinisst_tpu.streaming.state import init_decoder_state
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.decode import beam as TB
from infinisst_tpu_torch.decode import spec_beam as TSB
from infinisst_tpu_torch.decode import speculative as TS
from infinisst_tpu_torch.models import llama as TL
from infinisst_tpu_torch.train import draft as TD
from tests.test_agent import tiny_params
from tests.test_speculative import CFG, G, NGRAM, PAD, REP
from tests.test_torch_agent import make_port_agent
from tests.test_torch_speculative import TCFG, both, t_dec

torch.set_num_threads(1)

HIST = jnp.full((16,), PAD, jnp.int32)
HLEN = jnp.zeros((), jnp.int32)


def _tree(B, S, t, rng):
    """A drafted tree of S levels over B beams with reparenting (level 1
    all from slot 0): (srcs, toks, x tokens (N,), node_pos, bias (N, N),
    root (N,)), node n = s * B + b."""
    srcs = [rng.permutation(B) for _ in range(S)]
    srcs[1] = np.zeros(B, np.int64)
    toks = [rng.randint(1, CFG.vocab_size, B) for _ in range(S)]
    N = S * B
    anc = np.zeros((S, S, B), np.int64)
    for s in range(S):
        cur = np.arange(B)
        anc[s, s] = cur
        for sp in range(s, 0, -1):
            cur = np.asarray(srcs[sp])[cur]
            anc[s, sp - 1] = cur
    root = np.zeros((N,), np.int64)
    mask = np.zeros((N, N), bool)
    pos = np.zeros((N,), np.int64)
    x = np.zeros((N,), np.int64)
    for s in range(S):
        for b in range(B):
            n = s * B + b
            pos[n], x[n] = t + s, toks[s][b]
            root[n] = srcs[0][anc[s, 0, b]]
            for sp in range(s + 1):
                mask[n, sp * B + anc[s, sp, b]] = True
    bias = np.where(mask, 0.0, -1e9).astype(np.float32)
    return srcs, toks, x, pos, bias, root


def test_beam_tree_step_matches_jax():
    B, S, Gb, t = 3, 4, 8, 2
    rng = np.random.RandomState(0)
    jp = JL.init_params(jax.random.PRNGKey(1), CFG, jnp.float32)
    tp = from_jax(jax.device_get(jp), device="cpu")
    prompt = jnp.asarray(rng.randint(1, CFG.vocab_size, 7), jnp.int32)
    dec = init_decoder_state(CFG.num_layers, 1, 64, CFG.num_kv_heads,
                             CFG.head_dim, jnp.float32)
    _, dec = JL.decode_step(jp, CFG, dec, JL.embed(jp, prompt[None]))
    KV, Dh, NL = CFG.num_kv_heads, CFG.head_dim, CFG.num_layers
    gk = jnp.zeros((NL, B, Gb, KV, Dh), jnp.float32)
    gv = jnp.zeros_like(gk)
    for step in range(t):  # t committed tokens on each beam
        toks = jnp.asarray(rng.randint(1, CFG.vocab_size, B), jnp.int32)
        _, gk, gv, _ = JL.beam_token_step(
            jp, CFG, dec, gk, gv, jnp.asarray(step, jnp.int32),
            JL.embed(jp, toks[:, None]))
    srcs, toks, x, pos, bias, root = _tree(B, S, t, rng)
    jl, jk, jv = JL.beam_tree_step(
        jp, CFG, dec, gk, gv, jnp.asarray(t, jnp.int32),
        JL.embed(jp, jnp.asarray(x, jnp.int32)[None])[0],
        jnp.asarray(pos, jnp.int32), jnp.asarray(bias),
        jnp.asarray(root, jnp.int32))
    pdec = t_dec(dec)
    tgk = torch.from_numpy(np.array(gk))
    tgv = torch.from_numpy(np.array(gv))
    tl, tk, tv = TL.beam_tree_step(
        tp, TCFG, pdec, tgk, tgv, t, TL.embed(tp, torch.from_numpy(x)),
        torch.from_numpy(pos), torch.from_numpy(bias),
        torch.from_numpy(root))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    # the port's own sequential chain: beam_token_step level by level
    # with the committed buffers reordered by the composed sources
    k, v = tgk.clone(), tgv.clone()
    for s in range(S):
        sel = torch.from_numpy(np.asarray(srcs[s]))
        k, v = k[:, sel], v[:, sel]
        lg, k, v, _ = TL.beam_token_step(
            tp, TCFG, pdec, k, v, t + s,
            TL.embed(tp, torch.from_numpy(np.asarray(toks[s]))[:, None]))
        torch.testing.assert_close(tl[s * B:(s + 1) * B], lg, rtol=2e-4,
                                   atol=2e-4)
        torch.testing.assert_close(tk[:, s * B:(s + 1) * B], k[:, :, t + s],
                                   rtol=2e-4, atol=2e-4)


def _bspec(eos=-1, beam=3):
    return TB.BeamSpec(beam=beam, max_new_tokens=G, eos_id=eos, pad_id=PAD,
                       no_repeat_ngram_size=NGRAM, repetition_penalty=REP)


def _args(t):
    params, prompt, dec, first = t
    return (params, TCFG, dec, first, prompt, len(prompt),
            torch.full((16,), PAD, dtype=torch.int64), 0)


def port_beam(t, spec):
    return TB.beam_search(*_args(t), spec, encoder_ngram_size=NGRAM)


def port_spec(t, spec, d, k=3, **kw):
    return TSB.spec_beam_search(*_args(t), spec, draft_layers=d, draft_k=k,
                                encoder_ngram_size=NGRAM, **kw)


def jax_spec(j, spec, d, k=3):
    params, prompt, dec, first = j
    return JSB.spec_beam_search(
        params, CFG, dec, first, prompt, jnp.asarray(len(prompt), jnp.int32),
        HIST, HLEN, JB.BeamSpec(*spec), draft_layers=d, draft_k=k,
        encoder_ngram_size=NGRAM)


def same_winner(res, ref):
    assert res.tokens[: res.n_tokens] == list(ref.tokens[: int(
        ref.n_tokens)])
    assert (res.n_tokens, res.hit_eos, res.steps) == (
        int(ref.n_tokens), bool(ref.hit_eos), int(ref.steps))
    assert res.score == pytest.approx(float(ref.score), rel=1e-4, abs=1e-5)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_beam_matches_beam_search(seed, d):
    """The winner of ``beam_search`` for a terrible (d = 1) through a
    perfect (d = L) draft; a perfect draft takes at most half the
    rounds."""
    _, t = both(seed)
    spec = _bspec()
    ref, res = port_beam(t, spec), port_spec(t, spec, d)
    same_winner(res, ref)
    assert res.rounds <= res.steps
    if d == CFG.num_layers:
        assert res.rounds <= -(-res.steps // 2)


@pytest.mark.parametrize("seed, d", [(0, 1), (1, 4)])
def test_spec_beam_matches_jax(seed, d):
    """JAX's ``spec_beam_search``: its winner and its round, draft and
    acceptance counts."""
    j, t = both(seed)
    spec = _bspec()
    jr, res = jax_spec(j, spec, d), port_spec(t, spec, d)
    same_winner(res, jr)
    assert (res.rounds, res.drafted, res.accepted) == (
        int(jr.rounds), int(jr.drafted), int(jr.accepted))


def test_eos_and_finished_hypotheses():
    """EOS mid-search: the finished-hypothesis slots and the finalisation
    of ``beam_search`` and of JAX's ``spec_beam_search``."""
    j, t = both(4)
    free = port_beam(t, _bspec())
    assert free.n_tokens >= 3
    spec = _bspec(eos=free.tokens[2])
    ref = port_beam(t, spec)
    for d in (1, 4):
        same_winner(port_spec(t, spec, d), ref)
    same_winner(port_spec(t, spec, 1), jax_spec(j, spec, 1))


def test_draft_levers_stay_exact():
    """A shortlist head and a garbage exit adapter change only the
    proposals, never the winner."""
    _, t = both(5)
    spec = _bspec()
    ref = port_beam(t, spec)
    g = torch.Generator().manual_seed(3)
    ada = {"ln": torch.ones(CFG.hidden_size),
           "w1": torch.randn((CFG.hidden_size, 16), generator=g),
           "w2": torch.randn((16, CFG.hidden_size), generator=g)}
    for kw in (dict(draft_head=TS.make_draft_head(t[0]["lm_head"], 32)),
               dict(exit_adapter=ada)):
        same_winner(port_spec(t, spec, 1, **kw), ref)


def test_accept_all_machinery():
    """accept_all forces every drafted level: ceil(steps / (k+1))
    rounds."""
    _, t = both(6)
    res = port_spec(t, _bspec(), 1, k=3, accept_all=True)
    assert res.n_tokens > 0
    assert res.rounds == -(-res.steps // 4)
    assert res.accepted == res.steps - res.rounds


def test_beam_token_step_exit_adapter_hook():
    """The draft's exit adapter runs in ``beam_token_step``: a zero one
    is the identity, a nonzero one changes the logits (and equals JAX's
    hook)."""
    j, t = both(0)
    B = 2
    gk = torch.zeros((CFG.num_layers, B, 4, CFG.num_kv_heads, CFG.head_dim))
    toks = torch.tensor([[5], [9]])
    params, _, dec, _ = t
    base, *_ = TL.beam_token_step(params, TCFG, dec, gk.clone(), gk.clone(),
                                  0, TL.embed(params, toks))
    zero = dict(params, exit_adapter=TD.init_exit_adapter(
        torch.Generator().manual_seed(0), TCFG, rank=8))
    got, *_ = TL.beam_token_step(zero, TCFG, dec, gk.clone(), gk.clone(), 0,
                                 TL.embed(params, toks))
    torch.testing.assert_close(got, base, rtol=0, atol=0)
    hot = dict(params, exit_adapter={k: v + 0.5 for k, v in
                                     zero["exit_adapter"].items()})
    got, *_ = TL.beam_token_step(hot, TCFG, dec, gk.clone(), gk.clone(), 0,
                                 TL.embed(params, toks))
    assert float((got - base).abs().max()) > 1e-3
    jhot = dict(j[0], exit_adapter={k: jnp.asarray(v.numpy()) for k, v in
                                    hot["exit_adapter"].items()})
    jgk = jnp.zeros(gk.shape, jnp.float32)
    want, *_ = JL.beam_token_step(
        jhot, CFG, j[2], jgk, jgk, jnp.asarray(0, jnp.int32),
        JL.embed(j[0], jnp.asarray(toks.numpy(), jnp.int32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_spec_beam_agent_reproduces_the_golden_outputs():
    """The tiny agent with --speculative --spec-beam (d = 1, a terrible
    draft) on the golden stream reproduces
    ``tests/golden_agent_outputs.json``, the JAX plain beam agent's
    tokens, chunk by chunk, with the deferred commit's bookkeeping."""
    fixture = os.path.join(os.path.dirname(__file__),
                           "golden_agent_outputs.json")
    with open(fixture) as f:
        want = json.load(f)["per_chunk_token_ids"]
    tp = from_jax(jax.device_get(tiny_params()), device="cpu")
    agent = make_port_agent(tp, speculative=True, spec_beam=True,
                            spec_draft_layers=1, spec_k=3, spec_guard=False)
    rng = np.random.RandomState(1234)
    got = []
    for i in range(5):
        before = len(agent.states.target_ids)
        agent.push(rng.randn(agent.chunk_samples).astype(np.float32) * 0.1,
                   finished=(i == 4))
        got.append(list(agent.states.target_ids[before:]))
    assert got == want
    assert agent.spec_rounds > 0 and agent.spec_drafted > 0
    agent.flush_pending_evict()
    assert agent.llm_cache_len == (int(agent.dec_state.valid_len[0])
                                   + agent.pend_n_host)
