"""The draft distillation's device programs (``train/draft.py``:
``Rollouts``, ``_TeacherPass``, ``_Fit``) on the CPU, where they run
uncaptured, on ``test_torch_draft.py``'s models (its JAX-trained tiny
model, ``test_speculative.CFG``) and tolerances:

- each program bitwise the eager port function it replaces (the
  functions below, as the port ran them before the programs): the
  greedy rollout's tokens, the beam rollout's records, the adapter and
  the history of ``distill``, ``distill_on_features`` and
  ``beam_selection_distill``;
- each within the tolerances of ``test_torch_draft.py`` to JAX's jitted
  function (rollout tokens equal, records equal and scores within
  SCORE_RTOL, the history's loss within HIST_RTOL and its agreement
  equal, the adapter within ADAPTER_ATOL_LR x lr);
- the static buffers keep their addresses across steps and calls and
  when a second shape (a second key) comes in;
- ``graphs.host_reads`` grows by one a log step (a distillation), by one
  a beam rollout, and not in a greedy rollout;
- the programs go with their owner's last reference (no cycle).
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.models import llama as JL
from infinisst_tpu.train import draft as JDR
from infinisst_tpu_torch.core import graphs
from infinisst_tpu_torch.decode.beam import NEG_INF, select_candidates
from infinisst_tpu_torch.models import llama as TL
from infinisst_tpu_torch.streaming.state import init_decoder_state
from infinisst_tpu_torch.train import draft as TDR
from infinisst_tpu_torch.train.step import adam, tree_leaves
from tests.test_speculative import CFG
from tests.test_torch_draft import (  # noqa: F401  (the fixture)
    ADAPTER_ATOL_LR,
    SCORE_RTOL,
    TCFG,
    TQCFG,
    _close_history,
    _jax_init,
    _np,
    _port,
    trained,
)
from tools_quant_fidelity import CFG as JQCFG
from tools_quant_fidelity import make_corpus

torch.set_num_threads(1)


# -- the eager functions the programs replace ---------------------------------

@torch.no_grad()
def eager_rollout(params, cfg, prompts, gen_len):
    prompts = torch.as_tensor(prompts).to(torch.int64)
    B, P = prompts.shape
    V = cfg.vocab_size
    st = init_decoder_state(cfg.num_layers, B, P + gen_len + 1,
                            cfg.num_kv_heads, cfg.head_dim, torch.float32,
                            "cpu")
    lg, st = TL.decode_step(params, cfg, st, TL.embed(params, prompts))
    toks = [torch.argmax(lg[:, -1, :V], -1)]
    for _ in range(gen_len - 1):
        lg, st = TL.decode_step(params, cfg, st,
                                TL.embed(params, toks[-1][:, None]))
        toks.append(torch.argmax(lg[:, -1, :V], -1))
    return torch.cat([prompts, torch.stack(toks, 1)], dim=1)


@torch.no_grad()
def eager_beam(params, cfg, prompt, gen_len, B=4):
    prompt = torch.as_tensor(prompt).to(torch.int64)
    P = int(prompt.shape[0])
    V = cfg.vocab_size
    buf = torch.zeros((B, P + gen_len), dtype=torch.int64)
    buf[:, :P] = prompt[None]
    beam_scores = torch.tensor([0.0] + [NEG_INF] * (B - 1),
                               dtype=torch.float32)
    samples, ln = [], P
    for _ in range(gen_len):
        h = TL.offline_hidden(params, cfg, TL.embed(params, buf), None)
        h_last = TL._rms_norm(h[:, ln - 1], params["final_ln"],
                              cfg.rms_norm_eps)
        logp = torch.log_softmax(
            (h_last @ params["lm_head"])[:, :V].to(torch.float32), -1)
        total, _vals, cbeam, ctok = select_candidates(logp, beam_scores)
        sel_beam, sel_tok = cbeam[:B], ctok[:B]
        samples.append({"buf": buf.numpy().astype(np.int32), "len": ln,
                        "beam_scores": beam_scores.numpy().copy(),
                        "sel_beam": sel_beam.numpy().astype(np.int32),
                        "sel_tok": sel_tok.numpy().astype(np.int32)})
        buf = buf[sel_beam]
        buf[:, ln] = sel_tok
        beam_scores = total[sel_beam, sel_tok]
        ln += 1
    return samples


def eager_fit(adapter, lr, steps, log_every, loss_at):
    leaves = tree_leaves(adapter)
    for p in leaves:
        p.requires_grad_(True)
    opt = adam(lr, len(leaves))
    state = opt.init(leaves)
    history = []
    for i in range(steps):
        loss, agree = loss_at(adapter, i)
        grads = torch.autograd.grad(loss, leaves)
        state = opt.update(leaves, grads, state)
        if log_every and (i % log_every == 0 or i == steps - 1):
            history.append((i, float(loss.detach()), float(agree)))
    return {k: v.detach() for k, v in adapter.items()}, history


def eager_selection_loss_at(params, cfg, d, samples, batch):
    bufs = torch.as_tensor(np.stack([s["buf"] for s in samples])).long()
    lens = torch.tensor([s["len"] for s in samples])
    scores = torch.as_tensor(np.stack([s["beam_scores"] for s in samples]))
    selb = torch.as_tensor(np.stack([s["sel_beam"] for s in samples])).long()
    selt = torch.as_tensor(np.stack([s["sel_tok"] for s in samples])).long()
    N, B, S = bufs.shape
    V, eps = cfg.vocab_size, cfg.rms_norm_eps
    with torch.no_grad():
        h = TL.offline_hidden(params, cfg,
                              TL.embed(params, bufs.reshape(N * B, S)), None,
                              num_layers=d)
        h_d = h.reshape(N, B, S, -1)[torch.arange(N)[:, None],
                                     torch.arange(B)[None],
                                     (lens - 1)[:, None]]
    rng = np.random.RandomState(0)

    def loss_at(adapter, i):
        sel = torch.as_tensor(np.sort(rng.choice(N, size=min(batch, N),
                                                 replace=False)))
        hh = TL.apply_exit_adapter(adapter, h_d[sel], eps)
        hh = TL._rms_norm(hh, params["final_ln"], eps)
        logp = torch.log_softmax(
            (hh @ params["lm_head"])[..., :V].to(torch.float32), -1)
        flat = (scores[sel][..., None] + logp).reshape(-1, B * V)
        idx = selb[sel] * V + selt[sel]
        ce = -torch.log_softmax(flat, -1).gather(-1, idx).mean()
        top = torch.sort(flat.detach(), dim=-1, descending=True,
                         stable=True).indices[:, :B]
        match = (torch.sort(top, -1).values
                 == torch.sort(idx, -1).values).all(-1)
        return ce, match.to(torch.float32).mean()

    return loss_at


def _adapter_equal(a, b):
    for k in ("ln", "w1", "w2"):
        assert torch.equal(a[k], b[k]), k


def _adapter_close(got, want, lr):
    for k in ("ln", "w1", "w2"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   atol=ADAPTER_ATOL_LR * lr, rtol=0,
                                   err_msg=k)


def _addrs(tensors):
    return [t.data_ptr() for t in tensors]


def _freed(refs):
    """Every weakref dead with the collector off: no cycle held them."""
    gc.disable()
    try:
        return all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.fixture
def fits(monkeypatch):
    """Records, after every step of every ``_Fit``, the addresses of its
    static tensors (leaves, moments, device scalars, each key's inputs
    and packed output), and weakrefs to its programs."""
    rec = []

    class Recording(TDR._Fit):
        def step(self, inputs):
            out = super().step(inputs)
            keys = list(self.keys.values())
            opt = self.opt
            rec[-1]["addrs"].append(_addrs(
                self.leaves + self.state["mu"] + self.state["nu"]
                + [opt.lr, opt.bc1, opt.bc2]
                + [t for k in keys for t in k.bufs + [k.packed]]))
            rec[-1]["programs"] = [weakref.ref(k.program) for k in keys]
            return out

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec.append({"addrs": [], "programs": []})

    monkeypatch.setattr(TDR, "_Fit", Recording)
    return rec


def _stable(addrs):
    """Addresses unchanged from step to step, a new key's appended."""
    for a, b in zip(addrs, addrs[1:]):
        assert b[:len(a)] == a


# -- the rollouts -------------------------------------------------------------

def test_greedy_rollout_program(trained):
    jp, tp = trained
    ro = TDR.Rollouts(tp, TQCFG)
    reads = graphs.host_reads
    calls = [(make_corpus(np.random.RandomState(50), 8, 8), 32),
             (make_corpus(np.random.RandomState(51), 3, 5), 6),
             (make_corpus(np.random.RandomState(52), 8, 8), 32)]
    addrs = []
    for prompts, g in calls:
        got = ro.greedy(prompts, g)
        assert torch.equal(got, eager_rollout(tp, TQCFG, prompts, g))
        addrs.append(_addrs([t for k in ro.keys.values() for t in (
            k.prompts, *k.state, k.out, k.col)]))
    assert graphs.host_reads == reads  # none in a greedy rollout
    assert len(ro.keys) == 2
    _stable(addrs)
    want = np.asarray(JDR.rollout_corpus(jp, JQCFG, jnp.asarray(calls[0][0]),
                                         32))
    np.testing.assert_array_equal(_np(ro.greedy(*calls[0])), want)
    # the module function: one owner a call, the same tokens
    assert torch.equal(TDR.rollout_corpus(tp, TQCFG, *calls[1]),
                       eager_rollout(tp, TQCFG, *calls[1]))
    refs = [weakref.ref(k.program) for k in ro.keys.values()]
    del ro
    assert _freed(refs)


def test_beam_rollout_and_selection_programs(trained, fits, monkeypatch):
    jp, tp = trained
    prompt = make_corpus(np.random.RandomState(60), 1, 8)[0]
    ro = TDR.Rollouts(tp, TQCFG)
    reads = graphs.host_reads
    ts = ro.beam(prompt, 10)
    assert graphs.host_reads == reads + 1  # the records, once
    ref = eager_beam(tp, TQCFG, prompt, 10)
    js = JDR.beam_rollout_states(jp, JQCFG, jnp.asarray(prompt), 10, beam=4)
    assert len(ts) == len(ref) == len(js) == 10
    for a, b, c in zip(ts, ref, js):
        assert a["len"] == b["len"] == c["len"]
        for k in ("buf", "beam_scores", "sel_beam", "sel_tok"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("buf", "sel_beam", "sel_tok"):
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)
        np.testing.assert_allclose(a["beam_scores"], c["beam_scores"],
                                   rtol=SCORE_RTOL)
    # a second key, then the first again: the same buffers
    k1 = ro.keys[("beam", 4, 8, 10)]
    first = _addrs([k1.buf, k1.scores, k1.ln, k1.rec])
    short = ro.beam(prompt[:6], 5)
    assert [s["len"] for s in short] == list(range(6, 11))
    again = ro.beam(prompt, 10)
    for a, b in zip(again, ts):
        for k in ("buf", "beam_scores", "sel_beam", "sel_tok"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert _addrs([k1.buf, k1.scores, k1.ln, k1.rec]) == first
    refs = [weakref.ref(k.program) for k in ro.keys.values()]
    del ro, k1
    assert _freed(refs)

    # the listwise selection distillation, on the port's records
    _jax_init(monkeypatch, 32, 2)
    reads = graphs.host_reads
    ta, th = TDR.beam_selection_distill(tp, TQCFG, 1, ts, steps=20, lr=2e-3,
                                        rank=32, batch=8, log_every=5)
    assert graphs.host_reads == reads + len(th) == reads + 5
    _stable(fits[-1]["addrs"])
    assert len(fits[-1]["addrs"]) == 20
    assert _freed(fits[-1]["programs"])
    init = TDR.init_exit_adapter(None, TQCFG, 32)
    ea, eh = eager_fit(init, 2e-3, 20, 5,
                       eager_selection_loss_at(tp, TQCFG, 1, ts, 8))
    assert th == eh
    _adapter_equal(ta, ea)
    ja, jh = JDR.beam_selection_distill(
        jp, JQCFG, 1, ts, steps=20, lr=2e-3, rank=32,
        key=jax.random.PRNGKey(2), batch=8, log_every=5)
    _close_history(th, jh)
    _adapter_close(ta, ja, 2e-3)


# -- distill and distill_on_features ------------------------------------------

def test_distill_programs(fits, monkeypatch):
    params = JL.init_params(jax.random.PRNGKey(4), CFG, jnp.float32)
    rng = np.random.RandomState(2)
    ids_a = rng.randint(1, CFG.vocab_size, (2, 16))
    ids_a[1, 12:] = 0  # pad positions, masked out
    ids_b = rng.randint(1, CFG.vocab_size, (3, 10))  # a second key
    steps, lr, log = 12, 1e-2, 3
    ja, jh = JDR.distill(params, CFG, 1, [jnp.asarray(ids_a, jnp.int32),
                                          jnp.asarray(ids_b, jnp.int32)],
                         steps=steps, lr=lr, key=jax.random.PRNGKey(9),
                         pad_id=0, log_every=log)
    _jax_init(monkeypatch, None, 9)
    tp = _port(params)
    reads = graphs.host_reads
    timings = {}
    ta, th = TDR.distill(tp, TCFG, 1, [ids_a, ids_b], steps=steps, lr=lr,
                         pad_id=0, log_every=log, timings=timings)
    assert graphs.host_reads == reads + len(th) == reads + 5
    assert len(timings["teacher_ms"]) == 2
    assert len(timings["step_ms"]) == steps
    addrs = fits[-1]["addrs"]
    assert len(addrs) == steps and len(addrs[1]) > len(addrs[0])
    _stable(addrs)
    assert _freed(fits[-1]["programs"])
    _close_history(th, jh)
    _adapter_close(ta, ja, lr)

    # the eager function: the teacher pass per batch, the same steps
    feats = []
    for ids in (ids_a, ids_b):
        t = torch.from_numpy(ids)
        mask = (t != 0).to(torch.float32)
        feats.append((*TDR.collect_targets(tp, TCFG, t, 1, mask), mask))
    init = TDR.init_exit_adapter(None, TCFG)
    ea, eh = eager_fit(init, lr, steps, log, lambda a, i: TDR._loss(
        a, tp, TCFG, *feats[i % 2]))
    assert th == eh
    _adapter_equal(ta, ea)

    # over the same features collected beforehand: distill's result
    reads = graphs.host_reads
    fa, fh = TDR.distill_on_features(tp, TCFG, feats, steps=steps, lr=lr,
                                     log_every=log)
    assert graphs.host_reads == reads + len(fh)
    assert fh == th
    _adapter_equal(fa, ta)
    _stable(fits[-1]["addrs"])
    assert _freed(fits[-1]["programs"])


def test_uncaptured_is_the_same_program():
    """``captured=False`` runs the same pieces: on the CPU, where nothing
    is captured, the same results."""
    params = _port(JL.init_params(jax.random.PRNGKey(4), CFG, jnp.float32))
    ids = np.random.RandomState(3).randint(1, CFG.vocab_size, (2, 8))
    kw = dict(steps=4, lr=1e-2, log_every=2,
              key=torch.Generator().manual_seed(1))
    a, ha = TDR.distill(params, TCFG, 1, [ids], **kw)
    kw["key"] = torch.Generator().manual_seed(1)
    b, hb = TDR.distill(params, TCFG, 1, [ids], captured=False, **kw)
    assert ha == hb
    _adapter_equal(a, b)
    prompts = ids[:, :4]
    for g in (5, 1):  # at gen_len 1 a key has no step piece
        want = eager_rollout(params, TCFG, prompts, g)
        assert torch.equal(TDR.rollout_corpus(params, TCFG, prompts, g), want)
        assert torch.equal(TDR.rollout_corpus(params, TCFG, prompts, g,
                                              captured=False), want)
