"""The port's logit processors and beam search against
``infinisst_tpu.decode``: each processor on the same scores and buffers,
and one chunk's ``beam_search`` over the same prefix cache, with float32
and with W8A8 weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.core.config import tiny_model_config
from infinisst_tpu.decode import beam as JB
from infinisst_tpu.decode import logits as JLP
from infinisst_tpu.models import llama as JL
from infinisst_tpu.models import quant as JQ
from infinisst_tpu.streaming.state import init_decoder_state
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.decode import beam as TB
from infinisst_tpu_torch.decode import logits as TLP
from infinisst_tpu_torch.streaming.state import DecoderState as TDS

torch.set_num_threads(1)

CFG = tiny_model_config(vocab_size=512).llama
V = CFG.vocab_size


def _scores_and_buffers(seed):
    rng = np.random.RandomState(seed)
    B, T = 3, 12
    scores = np.log(rng.dirichlet(np.ones(V), B)).astype(np.float32)
    scores[0, :5] = np.abs(scores[0, :5])  # a few positive scores
    toks = rng.randint(0, 20, (B, T)).astype(np.int32)  # many repeats
    vlen = np.asarray([12, 7, 3], np.int32)
    return scores, toks, vlen


def _t(a):
    return torch.from_numpy(np.array(a)).long() if a.dtype.kind in "iu" \
        else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_logit_processors(seed):
    s, toks, vlen = _scores_and_buffers(seed)
    valid = np.arange(toks.shape[1])[None] < vlen[:, None]
    pairs = [
        (JLP.repetition_penalty(jnp.asarray(s), jnp.asarray(toks),
                                jnp.asarray(valid), 1.2),
         TLP.repetition_penalty(_t(s), _t(toks), torch.from_numpy(valid), 1.2)),
        (JLP.no_repeat_ngram(jnp.asarray(s), jnp.asarray(toks),
                             jnp.asarray(vlen), 3),
         TLP.no_repeat_ngram(_t(s), _t(toks), _t(vlen), 3)),
        (JLP.suppress_tokens(jnp.asarray(s), jnp.arange(V) % 7 == 0),
         TLP.suppress_tokens(_t(s), torch.arange(V) % 7 == 0)),
    ]
    hist = np.random.RandomState(seed + 5).randint(0, 20, (3, 30)).astype(np.int32)
    hlen = np.asarray([30, 10, 2], np.int32)
    pairs.append((
        JLP.encoder_no_repeat_ngram(jnp.asarray(s), jnp.asarray(hist),
                                    jnp.asarray(hlen), jnp.asarray(toks),
                                    jnp.asarray(vlen), 3),
        TLP.encoder_no_repeat_ngram(_t(s), _t(hist), _t(hlen), _t(toks),
                                    _t(vlen), 3),
    ))
    for want, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_candidates_and_finalize():
    rng = np.random.RandomState(3)
    s = rng.randn(4, V).astype(np.float32)
    s[1, 7] = s[2, 9] = s.max() + 1.0  # an exact tie: the lower index wins
    bs = np.asarray([0.0, -0.5, -0.5, -1e9], np.float32)
    _, vj, bj, tj = JB.select_candidates(jnp.asarray(s), jnp.asarray(bs))
    _, vt, bt, tt = TB.select_candidates(torch.from_numpy(s),
                                         torch.from_numpy(bs))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    spec = TB.BeamSpec(beam=4, max_new_tokens=6, eos_id=1, pad_id=0)
    fin = [-1e9, -3.25, -2.5, -1e9]
    for t in (1, 4):
        want = JB.finalize_winner(spec, jnp.asarray(t), jnp.asarray(bs),
                                  jnp.asarray(fin, jnp.float32))
        got = TB.finalize_winner(spec, t, torch.from_numpy(bs), fin)
        assert (got[0], got[1], got[2]) == (int(want[0]), int(want[1]),
                                            bool(want[2]))


def _jax_params(kind):
    key = jax.random.PRNGKey(0)
    if kind == "f32":
        return JL.init_params(key, CFG)
    return JQ.init_quantized_llama(key, CFG, act_int8=True, lm_head_int8=True,
                                   embed_dtype=jnp.float32)


@pytest.mark.parametrize("kind,beam", [("f32", 2), ("f32", 4), ("w8a8", 4)])
def test_beam_search_matches_jax(kind, beam):
    """Same winner, length, steps and EOS flag; the score to 1e-5
    relative (float32 logits with sums in another order).  EOS is the
    runner-up of the first step, so finished hypotheses are exercised."""
    jp = _jax_params(kind)
    tp = from_jax(jax.device_get(jp), device="cpu")
    rng = np.random.RandomState(11)
    prompt = rng.randint(0, 500, (15,)).astype(np.int32)
    st = init_decoder_state(CFG.num_layers, 1, 48, CFG.num_kv_heads,
                            CFG.head_dim, jnp.float32)
    logits, st = JL.decode_step(jp, CFG, st, JL.embed(jp, jnp.asarray(prompt)[None]))
    first = logits[0, -1]
    eos = int(np.argsort(np.asarray(first))[-2])
    spec = dict(beam=beam, max_new_tokens=6, eos_id=eos, pad_id=504,
                no_repeat_ngram_size=3, repetition_penalty=1.2)
    hist = rng.randint(0, 500, (16,)).astype(np.int32)
    sup = np.zeros((V,), bool)
    sup[[3, 77]] = True
    want = JB.beam_search(
        jp, CFG, st, first, jnp.asarray(prompt), jnp.asarray(15, jnp.int32),
        jnp.asarray(hist), jnp.asarray(9, jnp.int32), JB.BeamSpec(**spec),
        encoder_ngram_size=3, suppress_mask=jnp.asarray(sup),
    )
    prefix = TDS(k=torch.from_numpy(np.array(st.k)),
                 v=torch.from_numpy(np.array(st.v)),
                 valid_len=torch.from_numpy(np.array(st.valid_len)).long())
    got = TB.beam_search(
        tp, CFG, prefix, torch.from_numpy(np.array(first)),
        torch.from_numpy(prompt).long(), 15, torch.from_numpy(hist).long(), 9,
        TB.BeamSpec(**spec), encoder_ngram_size=3,
        suppress_mask=torch.from_numpy(sup),
    )
    assert got.tokens == np.asarray(want.tokens).tolist()
    assert got.n_tokens == int(want.n_tokens)
    assert got.steps == int(want.steps)
    assert got.hit_eos == bool(want.hit_eos)
    np.testing.assert_allclose(got.score, float(want.score), rtol=1e-5)


def test_ids_past_the_vocabulary_match_jax():
    """A stub tokenizer over a small vocabulary gives prompt ids past it:
    the JAX gather clamps them to the last row and its scatters drop them;
    the port's ``embed`` and processors do the same."""
    from infinisst_tpu_torch.models import llama as TL

    s, toks, vlen = _scores_and_buffers(3)
    toks[:, ::3] = V + np.arange(toks[:, ::3].size).reshape(3, -1) * 97
    toks[1, 4:7] = toks[1, 0:3]  # an n-gram whose banned token is past V
    valid = np.arange(toks.shape[1])[None] < vlen[:, None]
    pairs = [
        (JLP.repetition_penalty(jnp.asarray(s), jnp.asarray(toks),
                                jnp.asarray(valid), 1.2),
         TLP.repetition_penalty(_t(s), _t(toks), torch.from_numpy(valid),
                                1.2)),
        (JLP.no_repeat_ngram(jnp.asarray(s), jnp.asarray(toks),
                             jnp.asarray(vlen), 2),
         TLP.no_repeat_ngram(_t(s), _t(toks), _t(vlen), 2)),
    ]
    emb = np.random.RandomState(4).randn(V, 8).astype(np.float32)
    pairs.append((JL.embed({"embed": jnp.asarray(emb)}, jnp.asarray(toks)),
                  TL.embed({"embed": torch.from_numpy(emb)}, _t(toks))))
    for want, got in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
