"""The port's sampling path against the JAX package on the CPU: the HF
filter stack (``decode/logits.py``: temperature, top-k, top-p,
epsilon), ``beam.sample_decode`` and the agent's seeded sampling.

- The filters keep exactly JAX's sets, ties included (top-k keeps every
  score >= the k-th; top-p keeps the token that crosses p); the top-p
  cases put p at least 1e-6 from every cumulative boundary, where
  float32 cumulative sums of the two frameworks may round apart.
- ``sample_decode`` at top_k = 1 is the greedy chain (JAX's
  ``sample_decode`` at top_k = 1 and the port's beam 1), token for token.
- The first token's law: the processed target distribution of both
  frameworks agrees within 1e-6, and 4000 draws of the port pass
  Pearson's chi-square against it (below the 0.999 quantile).  Draws are
  not compared with JAX's: the generators differ.
- The same (seed, chunk) gives the same tokens.
Mirrors ``tests/test_spec_sampling.py:76-189`` and
``tests/test_agent.py:157``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.decode import beam as JB
from infinisst_tpu.decode import logits as JLP
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.decode import beam as TB
from infinisst_tpu_torch.decode import logits as TLP
from tests.test_agent import make_agent, tiny_params
from tests.test_speculative import CFG as JCFG
from tests.test_speculative import G, NGRAM, PAD, REP
from tests.test_torch_agent import make_port_agent
from tests.test_torch_speculative import TCFG, both, port_greedy

torch.set_num_threads(1)

NEG = -1e9


def _kept(x):
    return np.asarray(x) > NEG / 2


def _check(port_out, jax_out):
    """The same kept set and the same kept values."""
    got, want = port_out.numpy(), np.asarray(jax_out)
    np.testing.assert_array_equal(_kept(got), _kept(want))
    np.testing.assert_array_equal(np.where(_kept(got), got, 0),
                                  np.where(_kept(want), want, 0))


def _tied_scores():
    """Rows of log-softmax scores with ties at several ranks."""
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 6, size=(4, 40)).astype(np.float32) / 2.0
    raw[1] = 1.0  # a flat row: every token tied
    raw[2, :3] = 5.0  # three tied maxima
    return np.array(jax.nn.log_softmax(jnp.asarray(raw), -1))


@pytest.mark.parametrize("k", [0, 1, 2, 3, 5, 45])
def test_top_k_filter_keeps_ties(k):
    s = _tied_scores()
    _check(TLP.top_k_filter(torch.from_numpy(s), k),
           JLP.top_k_filter(jnp.asarray(s), k))


def _top_p_edges(s):
    """p values at least 1e-6 from every cumulative boundary of each row
    (midpoints between consecutive boundaries, in float64), and the
    extremes."""
    probs = np.exp(np.sort(s.astype(np.float64), -1)[:, ::-1])
    probs /= probs.sum(-1, keepdims=True)
    cum = np.cumsum(probs, -1)
    bounds = np.unique(np.round(cum.ravel(), 9))
    mids = (bounds[:-1] + bounds[1:]) / 2
    gaps = np.diff(bounds) / 2
    mids = mids[gaps > 1e-6]
    pick = mids[np.linspace(0, len(mids) - 1, 6).astype(int)]
    return [1e-4, *pick.tolist(), 0.999999, 1.0]


def test_top_p_filter_at_its_edges():
    rng = np.random.RandomState(1)
    rows = np.concatenate([_tied_scores(), np.array(jax.nn.log_softmax(
        jnp.asarray(rng.randn(3, 40).astype(np.float32) * 2), -1))])
    for p in _top_p_edges(rows):
        _check(TLP.top_p_filter(torch.from_numpy(rows), p),
               JLP.top_p_filter(jnp.asarray(rows), p))
    # the token that crosses p stays, and so does the top-1 at any p
    kept = TLP.top_p_filter(torch.from_numpy(rows), 1e-4) > NEG / 2
    assert bool((kept.sum(-1) >= 1).all())


@pytest.mark.parametrize("eps", [0.0, 0.01, 0.03, 0.2, 0.9])
def test_epsilon_filter_keeps_the_top1(eps):
    s = _tied_scores()
    got = TLP.epsilon_filter(torch.from_numpy(s), eps)
    _check(got, JLP.epsilon_filter(jnp.asarray(s), eps))
    assert bool(((got > NEG / 2).sum(-1) >= 1).all())


def test_temperature_and_the_processed_law():
    """``temperature_scale`` and the whole processed law of
    ``sample_scores`` (temperature, penalties, n-gram bans, top-k, top-p,
    epsilon) against JAX sample_decode's process on the same logits and
    buffers, within 1e-6."""
    (jp, jprompt, _, jfirst), (_, prompt, _, first) = both(3)
    spec = TB.SampleSpec(max_new_tokens=G, eos_id=-1, pad_id=PAD,
                         temperature=1.3, top_k=8, top_p=0.92,
                         epsilon_cutoff=0.01, no_repeat_ngram_size=NGRAM,
                         repetition_penalty=REP)
    x = np.random.RandomState(2).randn(3, 50).astype(np.float32)
    for t in (0.5, 1.0, 1e-9):
        np.testing.assert_array_equal(
            TLP.temperature_scale(torch.from_numpy(x), t).numpy(),
            np.asarray(JLP.temperature_scale(jnp.asarray(x), t)))
    got = _port_law(prompt, first, spec)
    want = _jax_law(jprompt, jfirst, spec)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _buffers(prompt):
    Tb = len(prompt) + G
    buf = np.full((1, Tb), PAD, np.int64)
    buf[0, : len(prompt)] = np.asarray(prompt)
    return buf


def _port_law(prompt, first, spec):
    s = TLP.sample_scores(
        first[None], torch.from_numpy(_buffers(prompt)),
        torch.tensor([len(prompt)]), spec,
        torch.full((1, 16), PAD, dtype=torch.int64),
        torch.zeros((1,), dtype=torch.int64), NGRAM)
    return torch.softmax(s, -1)[0]


def _jax_law(prompt, first, spec):
    """The process of JAX ``sample_decode`` (``beam.py:552-575``)."""
    buf = jnp.asarray(_buffers(prompt), jnp.int32)
    slen = jnp.asarray([len(prompt)], jnp.int32)
    s = jax.nn.log_softmax(
        JLP.temperature_scale(first.astype(jnp.float32), spec.temperature),
        -1)[None]
    s = JLP.repetition_penalty(
        s, buf, jnp.arange(buf.shape[1])[None] < slen[:, None], REP)
    s = JLP.no_repeat_ngram(s, buf, slen, NGRAM)
    s = JLP.encoder_no_repeat_ngram(
        s, jnp.full((1, 16), PAD, jnp.int32), jnp.zeros((1,), jnp.int32),
        buf, slen, NGRAM)
    s = JLP.top_k_filter(s, spec.top_k)
    s = JLP.top_p_filter(s, spec.top_p)
    s = JLP.epsilon_filter(s, spec.epsilon_cutoff)
    return np.asarray(jax.nn.softmax(s, -1)[0])


def _t_sample(t, spec, gen):
    params, prompt, dec, first = t
    return TB.sample_decode(
        params, TCFG, dec, first, prompt, len(prompt),
        torch.full((16,), PAD, dtype=torch.int64), 0, spec, gen,
        encoder_ngram_size=NGRAM)


def test_sample_decode_topk1_is_greedy():
    """top_k = 1: JAX ``sample_decode``'s tokens and the port's beam 1,
    token for token, whatever the generator."""
    j, t = both(0)
    jparams, jprompt, jdec, jfirst = j
    spec = TB.SampleSpec(max_new_tokens=G, eos_id=-1, pad_id=PAD, top_k=1,
                         no_repeat_ngram_size=NGRAM, repetition_penalty=REP)
    jr = JB.sample_decode(
        jparams, JCFG, jdec, jfirst,
        jprompt, jnp.asarray(len(jprompt), jnp.int32),
        jnp.full((16,), PAD, jnp.int32), jnp.zeros((), jnp.int32),
        JB.SampleSpec(*spec), jax.random.PRNGKey(0),
        encoder_ngram_size=NGRAM)
    want = jr.tokens[: int(jr.n_tokens)].tolist()
    assert want == port_greedy(t)
    for seed in (0, 1):
        res = _t_sample(t, spec, torch.Generator().manual_seed(seed))
        assert res.tokens[: res.n_tokens] == want
        assert res.steps == int(jr.steps) and not res.hit_eos


def test_first_token_law_chi_square():
    """4000 first draws of ``sample_decode`` (one generator, max 1 new
    token, so no forward) against the processed target law: Pearson's
    chi-square below its 0.999 quantile, on a concentrated stack
    (temperature 1.3, top-k 8, top-p 0.92)."""
    from scipy.stats import chi2

    from tests.test_torch_speculative import _chi2

    _, t = both(3)
    spec = TB.SampleSpec(max_new_tokens=1, eos_id=-1, pad_id=PAD,
                         temperature=1.3, top_k=8, top_p=0.92,
                         no_repeat_ngram_size=NGRAM, repetition_penalty=REP)
    law = _port_law(t[1], t[3], spec).double()
    gen = torch.Generator().manual_seed(7)
    N = 4000
    draws = [_t_sample(t, spec, gen).tokens[0] for _ in range(N)]
    counts = np.bincount(draws, minlength=law.shape[0])
    assert set(np.nonzero(counts)[0]) <= set(np.nonzero(law.numpy())[0])
    stat, dof = _chi2(counts, law)
    assert dof >= 3 and stat < chi2.ppf(0.999, dof), (stat, dof)


def test_chunk_generator_is_seeded_per_chunk():
    a = TLP.chunk_generator(4, 2, "cpu")
    b = TLP.chunk_generator(4, 2, "cpu")
    c = TLP.chunk_generator(4, 3, "cpu")
    x, y, z = (torch.rand(8, generator=g) for g in (a, b, c))
    assert torch.equal(x, y) and not torch.equal(x, z)


def _run(agent, n=3, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        before = len(agent.states.target_ids)
        agent.push(rng.randn(agent.chunk_samples).astype(np.float32) * 0.1,
                   finished=(i == n - 1))
        out.append(list(agent.states.target_ids[before:]))
    return out


def test_sampling_agent_is_seeded_and_topk1_is_jax_greedy():
    """The agent's --do-sample: the same seed gives the same tokens chunk
    by chunk, another seed others; at top_k = 1 the JAX sampling agent's
    tokens, every chunk."""
    tp = from_jax(jax.device_get(tiny_params()), device="cpu")
    kw = dict(do_sample=True, temperature=1.2, top_k=8)
    first = _run(make_port_agent(tp, sample_seed=4, **kw))
    assert first == _run(make_port_agent(tp, sample_seed=4, **kw))
    assert first != _run(make_port_agent(tp, sample_seed=5, **kw))
    assert sum(map(len, first)) > 0
    kw = dict(do_sample=True, top_k=1, sample_seed=2)
    assert _run(make_port_agent(tp, **kw)) == _run(make_agent(**kw))


# ---------------------------------------------------------------------------
# the sampling chunk as a device program (pieces A, S, D, F per key (m,
# n_units, first, "sample")): the draws of the host loop it replaced, kept


# the tiny agent's sampled ids (temperature 1.2, top_k 8, top_p 0.9; four
# chunks of ``_run``'s noise), recorded from the host loop of
# ``sample_decode`` at commit 471733121f03a1cb782a04661ccdafa0725d55b2
RECORDED_CHUNKS = {
    0: [[383, 67, 266, 239, 208, 119, 504, 75, 55],
        [263, 276, 504, 211, 75, 10, 105, 391, 472],
        [394, 296, 312, 391, 10, 75, 75, 55, 305],
        [394, 391, 64, 351, 75, 55, 266, 472, 238]],
    4: [[171, 75, 383, 173, 10, 211, 313, 265, 51],
        [456, 48, 305, 391, 10, 75, 105, 276, 379],
        [217, 75, 296, 60, 494, 20, 93, 131, 50],
        [263, 327, 174, 160, 494, 329, 239, 67, 10]],
}
# the speculative sampling stream of the same filters (draft d = 1, k = 3,
# patience 2; ``run_stream``'s five chunks), whose guard trips after chunk
# 1 and which samples with the plain sampler from chunk 2 on, recorded at
# the same commit
RECORDED_SPEC_CHUNKS = {
    0: [[383, 50, 131, 10, 224, 484, 296, 256, 60],
        [219, 239, 305, 238, 64, 391, 287, 279, 265],
        [394, 436, 494, 371, 105, 75, 131, 55, 119],
        [378, 12, 494, 287, 279, 379, 371, 161, 10],
        [379, 67, 504, 10, 484, 14, 391, 119, 75]],
    4: [[394, 75, 383, 211, 14, 296, 60, 378, 131],
        [494, 329, 379, 276, 10, 119, 256, 371, 161],
        [217, 75, 312, 265, 391, 78, 296, 10, 494],
        [263, 327, 504, 239, 305, 67, 50, 227, 436],
        [266, 504, 10, 171, 135, 67, 403, 105, 379]],
}
# ``sample_decode`` on ``both(0)``'s prefix (temperature 1.5, top_k 6,
# top_p 0.95, EOS id 80) with generators seeded 0-3: (tokens, n_tokens,
# steps), recorded at the same commit; every draw stream ends at EOS
RECORDED_DECODE = {
    0: ([111, 50], 2, 3),
    1: ([111, 122, 100, 24, 115], 5, 6),
    2: ([], 0, 1),
    3: ([111, 84, 65, 122], 4, 5),
}
FILTERS = dict(do_sample=True, temperature=1.2, top_k=8, top_p=0.9)


@pytest.mark.parametrize("seed", [0, 4])
def test_sampling_program_draws_the_recorded_ids(seed):
    tp = from_jax(jax.device_get(tiny_params()), device="cpu")
    agent = make_port_agent(tp, sample_seed=seed, **FILTERS)
    assert _run(agent, n=4) == RECORDED_CHUNKS[seed]
    assert {k[3] for k in agent._programs} == {"sample"}


@pytest.mark.parametrize("seed", [0, 4])
def test_speculative_sampling_falls_back_to_the_program(seed):
    from tests.test_torch_spec_guard import run_stream

    tp = from_jax(jax.device_get(tiny_params()), device="cpu")
    agent = make_port_agent(tp, speculative=True, spec_draft_layers=1,
                            spec_k=3, sample_seed=seed,
                            spec_guard_patience=2, **FILTERS)
    out, trip = run_stream(agent)
    assert trip == 1 and out == RECORDED_SPEC_CHUNKS[seed]
    # the chunks up to the trip ran the speculative sampling program, the
    # chunks after it the sampling program, one key a (m, n_units, first)
    # as the stream met them
    prog = agent._programs[(1, 1, False, "sample")]
    assert list(agent._programs) == [(1, 1, True, "spec_sample"),
                                     (1, 1, False, "spec_sample"),
                                     (1, 1, False, "sample")]
    assert prog.loop.t.item() == agent.last_result.steps


@pytest.mark.parametrize("seed", sorted(RECORDED_DECODE))
def test_sample_decode_draws_the_recorded_tokens(seed):
    _, t = both(0)
    spec = TB.SampleSpec(max_new_tokens=G, eos_id=80, pad_id=PAD,
                         temperature=1.5, top_k=6, top_p=0.95,
                         no_repeat_ngram_size=NGRAM, repetition_penalty=REP)
    res = _t_sample(t, spec, torch.Generator().manual_seed(seed))
    tokens, n, steps = RECORDED_DECODE[seed]
    assert (res.tokens, res.n_tokens, res.steps, res.hit_eos) == (
        tokens + [PAD] * (G - n), n, steps, True)


def test_sampling_chunk_reads_the_host_steps_plus_one_times():
    """One ``go`` a draw and the packed result once, every chunk."""
    from tests.test_torch_chunk_program import _HostReads

    tp = from_jax(jax.device_get(tiny_params()), device="cpu")
    agent = make_port_agent(tp, sample_seed=3, **FILTERS)
    rng = np.random.RandomState(8)
    for _ in range(3):
        audio = rng.randn(agent.chunk_samples).astype(np.float32) * 0.1
        with _HostReads() as mode:
            agent.push(audio)
        steps = agent.last_result.steps
        assert 0 < mode.n <= steps + 1, (mode.n, steps)


def test_sampling_program_topk1_is_jax_sampling_agent():
    """top_k = 1 at m = 2 with a finishing tail (three keys of the
    program): the JAX sampling agent's tokens, chunk by chunk."""
    tp = from_jax(jax.device_get(tiny_params()), device="cpu")
    kw = dict(do_sample=True, top_k=1, sample_seed=6)
    port = make_port_agent(tp, latency_multiplier=2, **kw)
    jax_agent = make_agent(multiplier=2, **kw)
    rng = np.random.RandomState(4)
    for i, n in enumerate((2, 2, 1)):
        audio = rng.randn(n * 15360).astype(np.float32) * 0.1
        got = port.push(audio, finished=i == 2)
        want = jax_agent.push(audio, finished=i == 2)
        assert port.states.target_ids == list(jax_agent.states.target_ids)
        assert (got.is_read(), getattr(got, "content", None)) == (
            want.is_read(), getattr(want, "content", None))
    assert port.states.target_ids
    assert {k[1:] for k in port._programs} == {
        (2, True, "sample"), (2, False, "sample"), (1, False, "sample")}
