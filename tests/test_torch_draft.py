"""The port's draft-adapter distillation (``train/draft.py``) against the
JAX package on the CPU, float32.

- ``collect_targets`` / ``collect_targets_x``: the two port paths bitwise
  to each other, each within TARGET_ATOL of JAX (float32 sums in another
  order), on ``test_speculative.CFG`` with a masked row.
- ``rollout_corpus``: token-equal to JAX on a JAX-trained tiny model
  (``tools_quant_fidelity``'s CFG and corpus), converted by ``from_jax``.
- ``distill`` / ``distill_on_features`` / ``beam_selection_distill``,
  started from JAX's initial adapter (the port draws its own from a
  ``torch.Generator``; the tests hand it JAX's): the history's loss
  within HIST_RTOL and its agreement equal, the final adapter within
  ADAPTER_ATOL_LR x lr, the bound of test_torch_train_steps.py (Adam
  turns a gradient entry that is float32 noise into an update of about
  lr); ``distill_on_features`` bitwise the port's ``distill``.
- ``beam_rollout_states``: every recorded selection equal to JAX's, the
  beam scores (sums of float32 log-probs) within SCORE_RTOL.
- The refusal of quantized parameters, the ``.npz`` interchange both
  ways, and the lift: the port's rollout, distillation and speculative
  greedy on the JAX-trained model, with JAX's three assertions
  (``tests/test_draft_adapter.py::test_rollout_distill_lifts_production_
  acceptance``).  The model here trains LIFT_TRAIN_STEPS steps (JAX's test
  150) to keep the file within its time; the raw draft is as poor and the
  lift as large at either count.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.models import llama as JL
from infinisst_tpu.train import draft as JDR
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.decode.speculative import SpecSpec, speculative_greedy
from infinisst_tpu_torch.models import llama as TL
from infinisst_tpu_torch.models.quant import quantize_llama_params
from infinisst_tpu_torch.streaming.state import init_decoder_state
from infinisst_tpu_torch.train import draft as TDR
from tests.test_speculative import CFG

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # the root-level tools_* scripts
from tools_quant_fidelity import CFG as JQCFG  # noqa: E402
from tools_quant_fidelity import make_corpus, train  # noqa: E402

torch.set_num_threads(1)

TARGET_ATOL = 1e-5
HIST_RTOL = 1e-4
ADAPTER_ATOL_LR = 0.1
SCORE_RTOL = 1e-5
LIFT_TRAIN_STEPS = 25


def _tcfg(cfg) -> LlamaConfig:
    return LlamaConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})


TCFG, TQCFG = _tcfg(CFG), _tcfg(JQCFG)


def _port(params):
    return from_jax(jax.device_get(params), device="cpu")


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def trained():
    """A JAX-trained tiny model (tools_quant_fidelity's train on its wide
    corpus) and its port copy."""
    corpus = make_corpus(np.random.RandomState(0), n_seq=64, S=64)
    params = JL.init_params(jax.random.PRNGKey(0), JQCFG, jnp.float32)
    params = train(params, corpus, LIFT_TRAIN_STEPS)
    return params, _port(params)


def _jax_init(monkeypatch, rank, seed):
    """Make the port start from JAX's initial adapter of ``seed``."""
    def init(key, cfg, rank_=None, dtype=torch.float32, device="cpu"):
        a = JDR.init_exit_adapter(jax.random.PRNGKey(seed), cfg, rank_)
        return {k: torch.from_numpy(np.array(v)).to(device, dtype)
                for k, v in a.items()}
    monkeypatch.setattr(TDR, "init_exit_adapter", init)


def _close_history(got, want):
    assert [s for s, _, _ in got] == [s for s, _, _ in want]
    np.testing.assert_allclose([l for _, l, _ in got],
                               [l for _, l, _ in want], rtol=HIST_RTOL)
    assert [a for _, _, a in got] == [a for _, _, a in want]


@pytest.mark.parametrize("d", [1, 2])
def test_collect_targets(d):
    params = JL.init_params(jax.random.PRNGKey(3), CFG, jnp.float32)
    ids = np.random.RandomState(1).randint(0, CFG.vocab_size, (2, 12))
    mask = np.ones((2, 12), np.float32)
    mask[1, 9:] = 0.0
    jh, jt = JDR.collect_targets(params, CFG, jnp.asarray(ids, jnp.int32), d,
                                 jnp.asarray(mask))
    tp = _port(params)
    tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    h, t = TDR.collect_targets(tp, TCFG, tids, d, tmask)
    hx, tx = TDR.collect_targets_x(tp, TCFG, TL.embed(tp, tids), d, tmask)
    assert torch.equal(h, hx) and torch.equal(t, tx)
    assert not h.requires_grad and not t.requires_grad
    np.testing.assert_allclose(_np(h), np.asarray(jh), atol=TARGET_ATOL,
                               rtol=0)
    np.testing.assert_allclose(_np(t), np.asarray(jt), atol=TARGET_ATOL,
                               rtol=0)


def test_rollout_corpus_matches_jax(trained):
    jp, tp = trained
    prompts = make_corpus(np.random.RandomState(50), 8, 8)
    want = np.asarray(JDR.rollout_corpus(jp, JQCFG, jnp.asarray(prompts), 32))
    got = _np(TDR.rollout_corpus(tp, TQCFG, prompts, 32))
    if not np.array_equal(got, want):
        b, s = np.argwhere(got != want)[0]
        lg = np.asarray(JL.offline_forward(
            jp, JQCFG, JL.embed(jp, jnp.asarray(want[b:b + 1, :s]))))[0, -1]
        top = np.sort(lg)[-2:]
        pytest.fail(f"rollout flips at row {b} position {s}: JAX "
                    f"{want[b, s]} port {got[b, s]}, JAX's top-2 logit gap "
                    f"{top[1] - top[0]:.3e}")
    assert got.shape == (8, 40)


def test_distill_matches_jax(monkeypatch):
    params = JL.init_params(jax.random.PRNGKey(4), CFG, jnp.float32)
    ids = np.random.RandomState(2).randint(1, CFG.vocab_size, (2, 16))
    ids[1, 12:] = 0  # pad positions, masked out
    ja, jh = JDR.distill(params, CFG, 1, [jnp.asarray(ids, jnp.int32)],
                         steps=40, lr=1e-2, key=jax.random.PRNGKey(9),
                         pad_id=0, log_every=20)
    _jax_init(monkeypatch, None, 9)
    tp = _port(params)
    ta, th = TDR.distill(tp, TCFG, 1, [ids], steps=40, lr=1e-2, pad_id=0,
                         log_every=20)
    _close_history(th, jh)
    for k in ("ln", "w1", "w2"):
        np.testing.assert_allclose(_np(ta[k]), np.asarray(ja[k]),
                                   atol=ADAPTER_ATOL_LR * 1e-2, rtol=0,
                                   err_msg=k)
    # over features collected beforehand: the port's own distill, bitwise
    tids = torch.from_numpy(ids)
    mask = (tids != 0).to(torch.float32)
    feats = [(*TDR.collect_targets(tp, TCFG, tids, 1, mask), mask)]
    fa, fh = TDR.distill_on_features(tp, TCFG, feats, steps=40, lr=1e-2,
                                     log_every=20)
    assert fh == th
    for k in ("ln", "w1", "w2"):
        assert torch.equal(fa[k], ta[k]), k


def test_distill_cache_is_lru(monkeypatch):
    """One teacher pass per batch object while it stays among the
    ``max_cached_batches`` most recently used."""
    params = _port(JL.init_params(jax.random.PRNGKey(4), CFG, jnp.float32))
    calls = []
    real = TDR.collect_targets
    monkeypatch.setattr(TDR, "collect_targets",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.RandomState(3)
    batches = [rng.randint(1, CFG.vocab_size, (1, 6)) for _ in range(3)]
    TDR.distill(params, TCFG, 1, batches, steps=6, max_cached_batches=3)
    assert len(calls) == 3
    calls.clear()
    TDR.distill(params, TCFG, 1, batches, steps=6, max_cached_batches=2)
    assert len(calls) == 6


def test_beam_rollout_and_selection_distill_match_jax(trained, monkeypatch):
    jp, tp = trained
    prompt = make_corpus(np.random.RandomState(60), 1, 8)[0]
    js = JDR.beam_rollout_states(jp, JQCFG, jnp.asarray(prompt), 10, beam=4)
    ts = TDR.beam_rollout_states(tp, TQCFG, prompt, 10, beam=4)
    assert len(ts) == len(js) == 10
    for a, b in zip(ts, js):
        assert a["len"] == b["len"]
        for k in ("buf", "sel_beam", "sel_tok"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a["beam_scores"], b["beam_scores"],
                                   rtol=SCORE_RTOL)
    ja, jh = JDR.beam_selection_distill(
        jp, JQCFG, 1, js, steps=20, lr=2e-3, rank=32,
        key=jax.random.PRNGKey(2), batch=8, log_every=5)
    _jax_init(monkeypatch, 32, 2)
    ta, th = TDR.beam_selection_distill(tp, TQCFG, 1, ts, steps=20, lr=2e-3,
                                        rank=32, batch=8, log_every=5)
    _close_history(th, jh)
    for k in ("ln", "w1", "w2"):
        np.testing.assert_allclose(_np(ta[k]), np.asarray(ja[k]),
                                   atol=ADAPTER_ATOL_LR * 2e-3, rtol=0,
                                   err_msg=k)


def test_quantized_params_are_refused():
    params = TL.init_params(TQCFG, torch.Generator().manual_seed(0), "cpu")
    qp = quantize_llama_params(params, quantize_lm_head=True, act_int8=True)
    ids = [np.zeros((1, 4), np.int64)]
    with pytest.raises(ValueError, match="unquantized"):
        TDR.distill(qp, TQCFG, 1, ids, steps=1)
    with pytest.raises(ValueError, match="unquantized"):
        TDR.rollout_corpus(qp, TQCFG, ids[0], 2)
    with pytest.raises(ValueError, match="unquantized"):
        TDR.beam_selection_distill(qp, TQCFG, 1, [], steps=1)


def test_rollout_distill_lifts_production_acceptance(trained):
    """JAX's lift test through the port: distillation collapses the KL and
    lifts agreement above 0.9 from a poor raw draft; emissions stay
    exactly greedy; acceptance at least doubles and rounds drop."""
    _, tp = trained
    prompts = torch.from_numpy(make_corpus(np.random.RandomState(50), 8, 8))
    rollouts = TDR.rollout_corpus(tp, TQCFG, prompts, 32)
    adapter, hist = TDR.distill(tp, TQCFG, 1, [rollouts], steps=300, lr=2e-3,
                                key=torch.Generator().manual_seed(5),
                                log_every=150)
    assert hist[-1][1] < hist[0][1] * 0.2, hist  # KL collapsed
    assert hist[0][2] < 0.6, hist  # the raw layer-skip draft is poor here
    assert hist[-1][2] > 0.9, hist  # distilled agreement high

    spec = SpecSpec(max_new_tokens=24, eos_id=-1, pad_id=0, draft_layers=1,
                    draft_k=4, no_repeat_ngram_size=0, repetition_penalty=1.0)

    def run(exit_adapter, prompt):
        st = init_decoder_state(TQCFG.num_layers, 1, len(prompt) + 24 + 5,
                                TQCFG.num_kv_heads, TQCFG.head_dim,
                                torch.float32, "cpu")
        lg, st = TL.decode_step(tp, TQCFG, st, TL.embed(tp, prompt[None]))
        res = speculative_greedy(
            tp, TQCFG, st, lg[0, -1, :TQCFG.vocab_size], prompt, len(prompt),
            torch.zeros((8,), dtype=torch.int64), 0, spec,
            exit_adapter=exit_adapter)
        return res.accepted, res.rounds, res.tokens[:res.n_tokens]

    base_acc = base_rounds = with_acc = with_rounds = 0
    for i in range(prompts.shape[0]):
        b, rb, toks_b = run(None, prompts[i])
        w, rw, toks_w = run(adapter, prompts[i])
        assert toks_b == toks_w  # exactness: emissions never change
        base_acc, base_rounds = base_acc + b, base_rounds + rb
        with_acc, with_rounds = with_acc + w, with_rounds + rw
    assert with_acc >= 2 * max(base_acc, 1), (base_acc, with_acc)
    assert with_rounds < base_rounds, (base_rounds, with_rounds)


def test_adapter_npz_interchange(tmp_path):
    """An adapter saved by either package loads in the other, its depth
    checked."""
    ja = JDR.init_exit_adapter(jax.random.PRNGKey(1), CFG, rank=16)
    jpath = str(tmp_path / "jax.npz")
    JDR.save_adapter(jpath, ja, d=2)
    back = TDR.load_adapter(jpath, expect_d=2)
    for k in ("ln", "w1", "w2"):
        np.testing.assert_array_equal(_np(back[k]), np.asarray(ja[k]))
    with pytest.raises(ValueError, match="draft_layers=2"):
        TDR.load_adapter(jpath, expect_d=3)

    ta = TDR.init_exit_adapter(torch.Generator().manual_seed(1), TCFG, 16)
    ta["w2"] = ta["w2"] + 0.5
    tpath = str(tmp_path / "port.npz")
    TDR.save_adapter(tpath, ta, d=3)
    jback = JDR.load_adapter(tpath, expect_d=3)
    for k in ("ln", "w1", "w2"):
        np.testing.assert_array_equal(np.asarray(jback[k]), _np(ta[k]))
    with pytest.raises(ValueError, match="draft_layers=3"):
        JDR.load_adapter(tpath, expect_d=2)
