"""The port's speculative greedy and sampling decoders
(``decode/speculative.py``) against the JAX package on the CPU at the
tiny decoder of ``tests/test_speculative.py`` (float32); the draft heads,
the break-even and the exit adapter are in test_torch_spec_heads.py.

Tokens, hit_eos, rounds and acceptance are compared exactly (the port's
decoders run the JAX rules on the same float32 logits; the forwards agree
to ~1e-6, far from any argmax tie these seeds meet); committed K/V within
1e-5 (float32 matmuls summed in another order).  Mirrors
``tests/test_speculative.py`` and ``tests/test_spec_sampling.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.decode import speculative as JS
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.decode import beam as TB
from infinisst_tpu_torch.decode import speculative as TS
from infinisst_tpu_torch.models import llama as TL
from infinisst_tpu_torch.streaming.state import DecoderState
from tests.test_speculative import CFG, G, NGRAM, PAD, REP, setup

torch.set_num_threads(1)

TCFG = LlamaConfig(**{f.name: getattr(CFG, f.name)
                      for f in dataclasses.fields(CFG)})
HIST = jnp.full((16,), PAD, jnp.int32)
HLEN = jnp.zeros((), jnp.int32)
KV_TOL = 1e-5  # float32 K/V, summed in another order


def t_dec(dec):
    return DecoderState(k=torch.from_numpy(np.array(dec.k)),
                        v=torch.from_numpy(np.array(dec.v)),
                        valid_len=torch.from_numpy(
                            np.array(dec.valid_len)).to(torch.int64))


def both(seed, plen=9, cap=64):
    """JAX ``setup`` (a prefilled prompt) and its port counterpart:
    (jax (params, prompt, dec, first), port (params, prompt, dec,
    first))."""
    params, prompt, dec, first = setup(seed, plen, cap)
    port = (from_jax(jax.device_get(params), device="cpu"),
            torch.from_numpy(np.array(prompt)).to(torch.int64), t_dec(dec),
            torch.from_numpy(np.array(first)))
    return (params, prompt, dec, first), port


def j_greedy(j, spec, **kw):
    params, prompt, dec, first = j
    return JS.speculative_greedy(
        params, CFG, jax.tree.map(jnp.copy, dec), first, prompt,
        jnp.asarray(len(prompt), jnp.int32), HIST, HLEN, spec,
        encoder_ngram_size=NGRAM, **kw)


def t_greedy(t, spec, **kw):
    params, prompt, dec, first = t
    dec = DecoderState(dec.k.clone(), dec.v.clone(), dec.valid_len.clone())
    return TS.speculative_greedy(
        params, TCFG, dec, first, prompt, len(prompt),
        torch.full((16,), PAD, dtype=torch.int64), 0, TS.SpecSpec(*spec),
        encoder_ngram_size=NGRAM, **kw)


def _spec(d, k=4, eos=-1, **kw):
    return JS.SpecSpec(max_new_tokens=G, eos_id=eos, pad_id=PAD,
                       draft_layers=d, draft_k=k, no_repeat_ngram_size=NGRAM,
                       repetition_penalty=REP, **kw)


def same(jr, tr):
    """Token for token, hit_eos, rounds, drafted and accepted equal."""
    n = int(jr.n_tokens)
    assert tr.tokens[: tr.n_tokens] == jr.tokens[:n].tolist()
    assert (tr.n_tokens, tr.hit_eos, tr.rounds, tr.drafted, tr.accepted) \
        == (n, bool(jr.hit_eos), int(jr.rounds), int(jr.drafted),
            int(jr.accepted))


def port_greedy(t, steps=G):
    """The port's own sequential greedy: ``beam_search`` at beam 1."""
    params, prompt, dec, first = t
    res = TB.beam_search(
        params, TCFG, dec, first, prompt, len(prompt),
        torch.full((16,), PAD, dtype=torch.int64), 0,
        TB.BeamSpec(beam=1, max_new_tokens=steps, eos_id=-1, pad_id=PAD,
                    no_repeat_ngram_size=NGRAM, repetition_penalty=REP),
        encoder_ngram_size=NGRAM)
    return res.tokens[: res.n_tokens]


@pytest.mark.parametrize("seed, d", [(0, 1), (1, 2)])
def test_speculative_greedy_matches_jax(seed, d):
    j, t = both(seed)
    jr = j_greedy(j, _spec(d))
    tr = t_greedy(t, _spec(d))
    same(jr, tr)
    assert tr.tokens[: tr.n_tokens] == port_greedy(t)
    # exactly the emitted tokens are committed
    assert int(tr.dec.valid_len[0]) == len(t[1]) + tr.n_tokens


def test_batched_speculative_greedy_matches_jax():
    """A pool of three rows, one inactive, per-row caps (one above G,
    bound to G): the JAX batched decoder's tokens, counts and cache
    lengths."""
    j, t = both(2)
    params, prompt, dec, first = j
    B = 3

    def tile(a):
        return jnp.concatenate([a] * B, axis=1 if a.ndim == 5 else 0)

    jdec = dec._replace(k=tile(dec.k), v=tile(dec.v),
                        valid_len=tile(dec.valid_len))
    active = jnp.asarray([True, False, True])
    caps = jnp.asarray([G + 7, G, 5], jnp.int32)
    spec = _spec(2)
    out_j = JS.batched_speculative_greedy(
        params, CFG, jdec, jnp.stack([first] * B), jnp.stack([prompt] * B),
        jnp.asarray([len(prompt)] * B, jnp.int32), jnp.stack([HIST] * B),
        jnp.zeros((B,), jnp.int32), spec, active, row_max_new=caps,
        encoder_ngram_size=NGRAM)
    tdec = t_dec(jdec)
    out_t = TS.batched_speculative_greedy(
        t[0], TCFG, tdec, t[3][None].repeat(B, 1), t[1][None].repeat(B, 1),
        [len(prompt)] * B, torch.full((B, 16), PAD, dtype=torch.int64),
        [0] * B, TS.SpecSpec(*spec), [True, False, True],
        row_max_new=np.array(caps), encoder_ngram_size=NGRAM)
    for i in (0, 1, 2, 4, 5, 6):  # tokens, n, hit, -, rounds, drafted, acc
        np.testing.assert_array_equal(np.asarray(out_t[i]),
                                      np.asarray(out_j[i]))
    np.testing.assert_array_equal(out_t[3].valid_len.numpy(),
                                  np.asarray(out_j[3].valid_len))
    assert int(out_t[1][0]) == G and int(out_t[1][1]) == 0


@pytest.mark.parametrize("case", ["mid", "cap"])
def test_eos_mid_stream_and_at_the_cap(case):
    """EOS inside an accepted run truncates emission and sets hit_eos; an
    EOS that would be token G + 1 (the cap ends the row first) does not
    (``tests/test_speculative.py:119``, ``:447``)."""
    seed = 3 if case == "mid" else 9
    j, t = both(seed)
    free = port_greedy(t, steps=G + 2)
    eos = free[2] if case == "mid" else free[G]
    # the boundary forms only if the eos id is not emitted before it
    assert case == "mid" or eos not in free[:G]
    spec = _spec(CFG.num_layers, eos=eos)
    jr, tr = j_greedy(j, spec), t_greedy(t, spec)
    same(jr, tr)
    assert tr.hit_eos == (case == "mid")
    assert tr.n_tokens == (2 if case == "mid" else G)


def test_committed_kv_matches_a_replay():
    """The K/V committed during the verifies equal a replay of the
    emitted tokens through the port's ``decode_step``
    (``tests/test_speculative.py:152``)."""
    _, t = both(5)
    tr = t_greedy(t, _spec(2, k=3))
    n = tr.n_tokens
    params, prompt, dec, _ = t
    replay = DecoderState(dec.k.clone(), dec.v.clone(), dec.valid_len)
    _, replay = TL.decode_step(params, TCFG, replay, TL.embed(
        params, torch.tensor([tr.tokens[:n]])))
    V = int(tr.dec.valid_len[0])
    assert V == int(replay.valid_len[0]) == len(prompt) + n
    torch.testing.assert_close(tr.dec.k[:, :, :V], replay.k[:, :, :V],
                               atol=KV_TOL, rtol=KV_TOL)
    torch.testing.assert_close(tr.dec.v[:, :, :V], replay.v[:, :, :V],
                               atol=KV_TOL, rtol=KV_TOL)


def test_near_capacity_commit_matches_jax():
    """A run that starts at valid_len = C - k - 1 and writes past the
    capacity: the clamped appends, and the cache every slot of it, equal
    the JAX decoder's, whose draft works on a copy of the cache (the
    port's draft writes in place and restores the one slot a clamped
    draft write can reach)."""
    k, plen, d = 3, 9, 1  # d = 1: every round rejects, the most rounds
    j, t = both(6, plen=plen, cap=plen + k + 1)
    assert int(j[2].valid_len[0]) == j[2].k.shape[2] - k - 1
    spec = _spec(d, k=k)
    jr, tr = j_greedy(j, spec), t_greedy(t, spec)
    same(jr, tr)
    assert int(tr.dec.valid_len[0]) == int(jr.dec.valid_len[0])
    np.testing.assert_allclose(tr.dec.k.numpy(), np.asarray(jr.dec.k),
                               atol=KV_TOL, rtol=KV_TOL)
    np.testing.assert_allclose(tr.dec.v.numpy(), np.asarray(jr.dec.v),
                               atol=KV_TOL, rtol=KV_TOL)


def test_accept_all_machinery():
    """accept_all (bench only) runs G tokens in ceil(G / (k+1)) rounds:
    the draft's sequence, equal to JAX's."""
    j, t = both(7)
    spec = _spec(1, k=3, accept_all=True)
    jr, tr = j_greedy(j, spec), t_greedy(t, spec)
    same(jr, tr)
    assert tr.n_tokens == G and tr.rounds == -(-G // 4)


# ---------------------------------------------------------------------------
# speculative sampling (tests/test_spec_sampling.py)


def _sspec(d, k=3, **kw):
    base = dict(max_new_tokens=G, eos_id=-1, pad_id=PAD, draft_layers=d,
                draft_k=k, no_repeat_ngram_size=NGRAM, repetition_penalty=REP)
    base.update(kw)
    return TS.SpecSampleSpec(**base)


def t_sample(t, spec, seed=0, **kw):
    params, prompt, dec, first = t
    dec = DecoderState(dec.k.clone(), dec.v.clone(), dec.valid_len.clone())
    return TS.speculative_sample(
        params, TCFG, dec, first, prompt, len(prompt),
        torch.full((16,), PAD, dtype=torch.int64), 0, spec,
        torch.Generator().manual_seed(seed), encoder_ngram_size=NGRAM, **kw)


@pytest.mark.parametrize("d", [1, 4])
def test_speculative_sample_topk1_is_greedy(d):
    """top_k = 1 makes every law a point mass: speculative sampling emits
    the greedy chain (the port's beam 1, held to JAX's greedy by the
    tests above), with any seed."""
    _, t = both(0)
    ref = port_greedy(t)
    prompt = t[1]
    for seed in (0, 1):
        res = t_sample(t, _sspec(d, top_k=1), seed=seed)
        assert res.tokens[: res.n_tokens] == ref
        assert int(res.dec.valid_len[0]) == len(prompt) + len(ref)


def test_speculative_sample_adversarial_draft_stays_exact():
    """A shortlist that misses every greedy token and a garbage adapter:
    q barely overlaps p, nearly every round resamples from the residual,
    and top_k = 1 still emits the greedy chain."""
    _, t = both(1)
    ref = port_greedy(t)
    bad = [i for i in range(CFG.vocab_size) if i not in set(ref)][:8]
    dh = TS.make_draft_head(t[0]["lm_head"], 8, ids=bad)
    g = torch.Generator().manual_seed(11)
    ada = {"ln": torch.ones(CFG.hidden_size),
           "w1": torch.randn((CFG.hidden_size, 16), generator=g),
           "w2": torch.randn((16, CFG.hidden_size), generator=g)}
    res = t_sample(t, _sspec(1, top_k=1), draft_head=dh, exit_adapter=ada)
    assert res.tokens[: res.n_tokens] == ref
    assert res.accepted <= 1


def test_perfect_draft_accepts_everything_and_repeats():
    """d = L: q == p, every draft accepted, G / (k+1) rounds; the same
    generator seed gives the same tokens, another seed others."""
    _, t = both(2)
    spec = _sspec(CFG.num_layers, k=3, temperature=1.1, top_p=0.95)
    res = t_sample(t, spec, seed=5)
    assert res.n_tokens == G and res.rounds == G // 4
    assert res.accepted == res.drafted == G - G // 4
    assert t_sample(t, spec, seed=5).tokens == res.tokens
    assert t_sample(t, spec, seed=6).tokens != res.tokens


def _exact_law(t, spec, pos):
    """The processed target law of emission ``pos`` (0 or 1) from
    sample_decode's processors, float64: position 1 as the mixture over
    position 0's support."""
    params, prompt, dec, first = t
    Tb = len(prompt) + G
    hist = torch.full((1, 16), PAD, dtype=torch.int64)
    zero = torch.zeros((1,), dtype=torch.int64)

    def law(logits, toks):
        buf = torch.full((1, Tb), PAD, dtype=torch.int64)
        seq = list(prompt.tolist()) + toks
        buf[0, : len(seq)] = torch.tensor(seq)
        from infinisst_tpu_torch.decode import logits as lp

        s = lp.sample_scores(logits[None], buf, torch.tensor([len(seq)]),
                             spec, hist, zero, NGRAM)
        return torch.softmax(s.double(), -1)[0]

    p0 = law(first, [])
    if pos == 0:
        return p0
    out = torch.zeros_like(p0)
    for x0 in torch.nonzero(p0).flatten().tolist():
        d = DecoderState(dec.k.clone(), dec.v.clone(), dec.valid_len.clone())
        lg, _ = TL.decode_step(params, TCFG, d, TL.embed(
            params, torch.tensor([[x0]])))
        out += p0[x0] * law(lg[0, -1], [x0])
    return out


def _chi2(counts, law, min_expected=5.0):
    """Pearson's statistic and degrees of freedom, cells of small
    expectation pooled."""
    n = counts.sum()
    exp = law.numpy() * n
    big = exp >= min_expected
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(exp[big], exp[~big].sum())
    keep = exp > 0
    obs, exp = obs[keep], exp[keep]
    return float(((obs - exp) ** 2 / exp).sum()), len(obs) - 1


def test_speculative_sample_in_distribution():
    """2000 rows of one pooled speculative sampling call (a terrible d = 1
    draft; each row an independent draw) against the exact processed
    target law at emission positions 0 and 1: Pearson's chi-square below
    its 0.999 quantile."""
    from scipy.stats import chi2

    j, t = both(3)
    params, prompt, dec, first = t
    N = 2000
    spec = _sspec(1, k=3, temperature=1.3, top_k=8, top_p=0.92,
                  max_new_tokens=2)
    bdec = DecoderState(dec.k.repeat(1, N, 1, 1, 1),
                        dec.v.repeat(1, N, 1, 1, 1),
                        dec.valid_len.repeat(N))
    toks, n, *_ = TS.batched_speculative_sample(
        params, TCFG, bdec, first[None].repeat(N, 1),
        prompt[None].repeat(N, 1), [len(prompt)] * N,
        torch.full((N, 16), PAD, dtype=torch.int64), [0] * N, spec,
        torch.Generator().manual_seed(123), [True] * N,
        encoder_ngram_size=NGRAM)
    assert bool((n == 2).all())
    for pos in (0, 1):
        counts = np.bincount(toks[:, pos].numpy(),
                             minlength=CFG.vocab_size)
        stat, dof = _chi2(counts, _exact_law(t, spec, pos))
        assert dof >= 3 and stat < chi2.ppf(0.999, dof), (pos, stat, dof)
