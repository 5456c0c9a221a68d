"""The port's trained-model tools against the JAX root scripts on the CPU,
at the dryrun preset (float32):

- the task helpers equal JAX's: the word ids, signatures, utterances,
  split files (TSV text and wav bytes), ``monotonic_frac``, ``ref_text``,
  the phrase map and its utterances and splits;
- parameters pickled as the JAX tools pickle them load through
  ``--load-params`` (``from_jax``) and the port's pickle loads in JAX's
  tool unchanged; a pickle naming another class is refused;
- ``alignatt_quality.train`` (the offline recipe) and
  ``trained_e2e.train_trajectory`` (the ``trajectory=4`` recipe), 3 steps
  from JAX's initial weights: each step's loss within rtol 1e-5 and the
  weights within 10 x lr x 1e-2, all but 1e-3 of their entries within
  lr x 1e-2 (``test_torch_train_steps.py``'s bounds: Adam turns float32
  noise in a gradient entry into an update of about lr);
- ``evaluate``/``mode_rows`` (the AlignAtt agent in both modes) on
  JAX-trained weights read from a JAX pickle by ``--load-params``: the
  hypotheses and the monotonic shares equal JAX's, with JAX's prefill
  probe span shifted to the block it should read (ROADMAP §3; as
  ``test_torch_alignatt.py`` does).

Both packages log a loss every 20 steps; the tests patch the trainers'
``TrainerArgs`` to log every step.
"""

import filecmp
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

import infinisst_tpu.train.trainer as JTR
import infinisst_tpu_torch.train.trainer as TTR
from infinisst_tpu.core.presets import dryrun_config as jdryrun
from infinisst_tpu.data.template import PromptBuilder as JBuilder
from infinisst_tpu.data.template import StubTokenizer as JStub
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.tools import alignatt_quality as TA
from infinisst_tpu_torch.tools import spec_trained_teacher as TS
from infinisst_tpu_torch.tools import trained_e2e as TE
from infinisst_tpu_torch.train.step import tree_leaves
from tests.test_torch_alignatt import shift_jax_probe

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # the root-level tools_* scripts
import tools_alignatt_quality as JA  # noqa: E402
import tools_spec_trained_teacher as JS  # noqa: E402
import tools_trained_e2e as JE  # noqa: E402

torch.set_num_threads(2)

LR = 1e-3
STEPS = 3
N_TRAIN = 8
N_EVAL = 2


def _log_every_step(monkeypatch):
    for mod in (JTR, TTR):
        orig = mod.TrainerArgs
        monkeypatch.setattr(mod, "TrainerArgs", lambda _o=orig, **kw: _o(
            **{**kw, "log_step": 1}))


def _jax_task():
    cfg = jdryrun()
    tok = JStub(cfg.llama.vocab_size, lo=10, hi=900)
    return cfg, tok, JBuilder(tok, cfg.tokens), JA.content_words(tok)


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    """Both packages' copy task, its data on disk and JAX's initial
    weights."""
    d = tmp_path_factory.mktemp("copy")
    cfg, tok, builder, words, train_utts, eval_utts = TA.task(N_TRAIN,
                                                              N_EVAL)
    TA.write_split(str(d), "tr", train_utts)
    TA.write_split(str(d), "dv", train_utts[:4])
    return dict(d=str(d), cfg=cfg, tok=tok, builder=builder, words=words,
                eval_utts=eval_utts, j=_jax_task(),
                j_init=jax.device_get(JA.init_params(jdryrun())))


def test_task_helpers_equal_jax(tmp_path):
    cfg, tok, _, words, train_utts, eval_utts = TA.task(6, 2)
    _, jtok, _, jwords = _jax_task()
    assert words == jwords == JA.content_words(jtok)
    assert [tok.encode(w) for w in words] == [jtok.encode(w) for w in words]
    for w in words[:4]:
        np.testing.assert_array_equal(TA.signature(tok, w),
                                      JA.signature(jtok, w))
    rng, jrng = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(6):
        k = int(jrng.randint(1, 5))
        assert int(rng.randint(1, 5)) == k
        ws, wav = TA.make_utt(tok, words, rng, k)
        jws, jwav = JA.make_utt(jtok, jwords, jrng, k)
        assert ws == jws
        np.testing.assert_array_equal(wav, jwav)
    for mod, sub in ((TA, "t"), (JA, "j")):
        os.makedirs(tmp_path / sub)
        mod.write_split(str(tmp_path / sub), "tr", train_utts)
    assert (open(tmp_path / "t" / "tr.tsv").read()
            == open(tmp_path / "j" / "tr.tsv").read().replace(
                str(tmp_path / "j"), str(tmp_path / "t")))
    for i in range(len(train_utts)):
        assert filecmp.cmp(tmp_path / "t" / f"tr_{i}.wav",
                           tmp_path / "j" / f"tr_{i}.wav", shallow=False)
    for idx in ([1, 2, 2, 5], [5, 1, 2], [3], []):
        assert TA.monotonic_frac(idx) == JA.monotonic_frac(idx)
    for ws, _ in eval_utts:
        assert TA.ref_text(tok, ws) == JA.ref_text(jtok, ws)

    # the phrase task
    assert [TS.phrase(tok, w) for w in words] == \
        [JS.phrase(jtok, w) for w in words]
    rng, jrng = np.random.RandomState(11), np.random.RandomState(11)
    utts = []
    for _ in range(3):
        k = int(jrng.randint(1, 5))
        assert int(rng.randint(1, 5)) == k
        steps, wav = TS.make_phrase_utt(tok, words, rng, k)
        jsteps, jwav = JS.make_phrase_utt(jtok, jwords, jrng, k)
        assert steps == jsteps
        np.testing.assert_array_equal(wav, jwav)
        utts.append((steps, wav))
    TS.write_phrase_split(str(tmp_path / "t"), "sv", utts)
    JS.write_phrase_split(str(tmp_path / "j"), "sv", utts)
    assert (open(tmp_path / "t" / "sv.tsv").read()
            == open(tmp_path / "j" / "sv.tsv").read().replace(
                str(tmp_path / "j"), str(tmp_path / "t")))


class _Other:
    pass


def test_params_pickles_cross_packages(task, tmp_path):
    """A JAX tool's pickle (``jax.tree.map(np.asarray, params)``) loads as
    ``from_jax`` gives it; the port's pickle is the same tree of numpy
    arrays; a pickle that names any other class is refused."""
    jp = task["j_init"]
    jpath = tmp_path / "j.pkl"
    with open(jpath, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jp), f)
    got = TA.load_params(str(jpath), "cpu")
    want = from_jax(jp, device="cpu")
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    tpath = tmp_path / "t.pkl"
    TA.save_params(got, str(tpath))
    with open(tpath, "rb") as f:
        back = pickle.load(f)
    jl, tl = jax.tree.leaves(jp), jax.tree.leaves(back)
    assert jax.tree.structure(jp) == jax.tree.structure(back)
    for a, b in zip(jl, tl):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(np.asarray(a), b)
    bad = tmp_path / "bad.pkl"
    with open(bad, "wb") as f:
        pickle.dump({"w2v2": _Other()}, f)
    with pytest.raises(pickle.UnpicklingError, match="only numpy arrays"):
        TA.load_params(str(bad), "cpu")


def _close_params(tp, jp):
    want = from_jax(jax.device_get(jp), device="cpu")
    n_far = n_all = 0
    for a, w in zip(tree_leaves(tp), tree_leaves(want)):
        d = (a.detach() - w).abs()
        assert d.max() <= 10 * LR * 1e-2, d.max()
        n_far += int((d > LR * 1e-2).sum())
        n_all += d.numel()
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


@pytest.mark.parametrize("recipe", ["offline", "trajectory"])
def test_train_matches_jax(task, monkeypatch, recipe):
    """``train`` / ``train_trajectory`` from JAX's initial weights: the
    losses of every step and the trained weights."""
    _log_every_step(monkeypatch)
    d, cfg, builder = task["d"], task["cfg"], task["builder"]
    jcfg, _, jbuilder, _ = task["j"]
    start = from_jax(task["j_init"], device="cpu")
    if recipe == "offline":
        jp, jl, _ = JA.train(d, jcfg, jbuilder, STEPS, LR)
        tp, tl, _ = TA.train(d, cfg, builder, STEPS, LR, "cpu", params=start)
    else:
        jp, jl, _ = JE.train_trajectory(d, jcfg, jbuilder, STEPS, LR)
        tp, tl, _ = TE.train_trajectory(d, cfg, builder, STEPS, LR, "cpu",
                                        params=start)
    assert len(tl) == len(jl) == STEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close_params(tp, jp)


def test_mode_rows_match_jax_on_a_jax_pickle(task, monkeypatch, tmp_path):
    """JAX's tool trains the offline model 3 steps and pickles it; the
    port's ``main --load-params`` pipeline (``load_params``) and
    ``mode_rows`` give JAX's hypotheses and monotonic shares in both
    modes, and ``evaluate``'s texts."""
    _log_every_step(monkeypatch)
    jcfg, jtok, jbuilder, _ = task["j"]
    jp, _, _ = JA.train(task["d"], jcfg, jbuilder, STEPS, LR)
    path = tmp_path / "aaq.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jp), f)
    tp = TA.load_params(str(path), "cpu")
    ev = task["eval_utts"]
    shift_jax_probe(monkeypatch)
    want = JA.mode_rows(jp, jcfg, jbuilder, ev, jtok, 2)
    got = TA.mode_rows(tp, task["cfg"], task["builder"], ev, task["tok"], 2,
                       "cpu")
    assert got["samples"] == want["samples"]
    assert got["delta"] == want["delta"]
    for mode in ("parity", "early_stop"):
        for k in ("ter_vs_ref", "mean_tokens", "attn_monotonic_frac"):
            assert got[mode][k] == want[mode][k], (mode, k)
