"""The port's trained-model end-to-end tools against the JAX root scripts
on the CPU, at the dryrun preset (float32), on a trajectory-recipe model
that JAX's ``tools_trained_e2e.train_trajectory`` trains 3 steps on the
phrase task and pickles as the JAX tools do, read back through the
port's ``--load-params`` path (``alignatt_quality.load_params``):

- ``trained_e2e.score`` through ``eval/runner.run_streaming_eval`` (the
  beam-4 InfiniSST agent): the hypotheses in ``instances.log``, BLEU and
  StreamLAAL equal JAX's (the computation-aware latency and the RTF are
  wall times and differ);
- ``spec_trained_teacher.collect_serving_features`` on the same serving
  split: the draft features and teacher logits within 1e-5 of their
  largest magnitude, the decode-position masks equal;
- ``spec_trained_teacher.measure_agent`` (speculative greedy, d = 1,
  k = 4) with the guard on and off and with an exit adapter drawn by
  numpy: every counter and the exactness against plain greedy equal
  JAX's (the agent's counters reset with ``agent.reset()``);
- ``phrase_e2e.write_phrase_eval_files`` writes JAX's files.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infinisst_tpu.train.trainer as JTR
from infinisst_tpu.core.presets import dryrun_config as jdryrun
from infinisst_tpu.data.template import PromptBuilder as JBuilder
from infinisst_tpu.data.template import StubTokenizer as JStub
from infinisst_tpu_torch.tools import alignatt_quality as TA
from infinisst_tpu_torch.tools import phrase_e2e as TP
from infinisst_tpu_torch.tools import spec_trained_teacher as TS
from infinisst_tpu_torch.tools import trained_e2e as TE

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # the root-level tools_* scripts
import tools_alignatt_quality as JA  # noqa: E402
import tools_phrase_e2e as JP  # noqa: E402
import tools_spec_trained_teacher as JS  # noqa: E402
import tools_trained_e2e as JE  # noqa: E402

torch.set_num_threads(2)

N_EVAL = 2


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """JAX's phrase model after 3 trajectory-recipe steps, its pickle read
    by the port, the held-out phrase streams and a serving split."""
    d = str(tmp_path_factory.mktemp("phrase"))
    cfg, tok, builder, words, _, _ = TA.task(0, 0)
    rng = np.random.RandomState(11)
    train_utts = [TS.make_phrase_utt(tok, words, rng, k=int(rng.randint(1, 5)))
                  for _ in range(6)]
    TS.write_phrase_split(d, "tr", train_utts)
    TS.write_phrase_split(d, "dv", train_utts[:4])
    TS.write_phrase_split(d, "sv", train_utts[:3])
    jcfg = jdryrun()
    jtok = JStub(jcfg.llama.vocab_size, lo=10, hi=900)
    jbuilder = JBuilder(jtok, jcfg.tokens)
    with pytest.MonkeyPatch.context() as mp:
        orig = JTR.TrainerArgs
        mp.setattr(JTR, "TrainerArgs",
                   lambda **kw: orig(**{**kw, "log_step": 1}))
        jp, losses, _ = JE.train_trajectory(d, jcfg, jbuilder, 3, 1e-3)
    assert len(losses) == 3
    path = os.path.join(d, "phrase.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jp), f)
    erng = np.random.RandomState(4321)
    ev = [TS.make_phrase_utt(tok, words, erng, k=4) for _ in range(N_EVAL)]
    return dict(d=d, cfg=cfg, tok=tok, builder=builder, jcfg=jcfg,
                jtok=jtok, jbuilder=jbuilder, jp=jp,
                tp=TA.load_params(path, "cpu"), ev=ev)


def test_score_matches_jax(trained):
    t = trained
    d = os.path.join(t["d"], "t")
    j = os.path.join(t["d"], "j")
    for p in (d, j):
        os.makedirs(p, exist_ok=True)
    td = TP.write_phrase_eval_files(d, t["ev"], t["tok"])
    jd = JP.write_phrase_eval_files(j, t["ev"], t["jtok"])
    assert open(os.path.join(td, "eval.target")).read() == \
        open(os.path.join(jd, "eval.target")).read()
    got = TE.score(TE.make_infinisst(t["tp"], t["cfg"], t["builder"], 4,
                                     "cpu"), td, "out")
    want = JE.score(JE.make_infinisst(t["jp"], t["jcfg"], t["jbuilder"], 4),
                    jd, "out")
    for k in ("bleu", "stream_laal", "n_instances"):
        assert got[k] == want[k], k

    def preds(p):
        with open(os.path.join(p, "out", "instances.log")) as f:
            return [line.split('"prediction": ')[1].split(', "reference"')[0]
                    for line in f]

    assert preds(td) == preds(jd)
    assert 0.0 <= got["exact_match"] <= 1.0 and got["ter"] >= 0.0


def test_serving_features_match_jax(trained):
    t = trained
    got = TS.collect_serving_features(t["tp"], t["cfg"], t["builder"],
                                      t["d"], "sv", 1)
    want = JS.collect_serving_features(t["jp"], t["jcfg"], t["jbuilder"],
                                       t["d"], "sv", 1)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g[:2], w[:2]):
            b = np.asarray(b)
            assert a.shape == b.shape
            assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
        np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))


@pytest.fixture(scope="module")
def plain_refs(trained):
    """The plain greedy agents' held-out texts, the port's and JAX's."""
    t = trained
    plain = TE.make_infinisst(t["tp"], t["cfg"], t["builder"], 1, "cpu")
    ref = [" ".join(s for s in TS.stream_utt(plain, wav, len(st)) if s)
           for st, wav in t["ev"]]
    jplain = JE.make_infinisst(t["jp"], t["jcfg"], t["jbuilder"], 1)
    jref = [" ".join(s for s in JS.stream_utt(jplain, wav, len(st)) if s)
            for st, wav in t["ev"]]
    return ref, jref


@pytest.mark.parametrize("case", ["guard", "no_guard", "adapter"])
def test_measure_agent_matches_jax(trained, plain_refs, case):
    t = trained
    adapter = jadapter = None
    if case == "adapter":
        D = t["cfg"].llama.hidden_size
        rng = np.random.RandomState(3)
        a = {"ln": (1.0 + 0.1 * rng.randn(D)).astype(np.float32),
             "w1": (rng.randn(D, D // 2) / np.sqrt(D)).astype(np.float32),
             "w2": (rng.randn(D // 2, D) * 0.05).astype(np.float32)}
        adapter = {k: torch.from_numpy(v) for k, v in a.items()}
        jadapter = {k: jnp.asarray(v) for k, v in a.items()}
    ref, jref = plain_refs
    assert ref == jref
    kw = dict(k=4, d=1, guard=case == "guard")
    got = TS.measure_agent(t["tp"], t["cfg"], t["builder"], t["ev"],
                           adapter=adapter, plain_ref=ref, device="cpu", **kw)
    want = JS.measure_agent(t["jp"], t["jcfg"], t["jbuilder"], t["ev"],
                            adapter=jadapter, plain_ref=jref, **kw)
    assert got == want
    assert got["rounds"] > 0
