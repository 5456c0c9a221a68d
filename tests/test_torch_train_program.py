"""The train step as device programs (``train.step.TrainProgram``) on the
CPU, where its pieces run uncaptured, on ``test_torch_train.py``'s
weights and padded batch (the dryrun preset, its conv extractor
narrowed, float32, remat on):

- 4 steps over two keys, (m = 1, the four-row batch) and (m = 2, its
  first two rows), alternating, in three cases: stage 1 with encoder
  dropout 0.1, stage 2 with ``grad_acc_steps`` 2, stage 0 with
  ``cpo_beta`` 0.5.  Every step's loss and grad norm, and the parameters
  and every moment (mu, nu, the accumulated mean) after each step,
  bitwise those of the eager ``make_train_step``; the static buffers
  (the state, each key's batch, rows and outputs, the optimizer's device
  scalars) keep their addresses; the device ``lr``, ``bc1``, ``bc2`` are
  the host schedule's float32 values; the program is freed with its
  last reference (no cycle keeps its graphs alive).  The stage 2 case (no dropout,
  whose masks are not JAX's draws) is also held to JAX's jitted
  ``make_train_step`` of both keys at ``test_torch_train_steps.py``'s
  tolerances (the eager step of every case is held to JAX there);
- ``Trainer.fit`` reads the device only at its log steps
  (``graphs.host_reads``), one packed pair each, and ``evaluate`` once a
  batch; a state with other tensors is written into the static one.
"""

import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from infinisst_tpu.train import step as JT
from infinisst_tpu_torch.core import graphs
from infinisst_tpu_torch.train import step as TT
from tests.test_torch_train import BLOCK, CACHE, CFG, JCFG, make_setup
from tests.test_torch_train import port_params

torch.set_num_threads(1)

LR = 1e-3
CASES = {  # freeze, grad_acc_steps, cpo_beta, schedule, encoder dropout
    "stage1_dropout": ("stage1", 1, 0.0, "cosine", 0.1),
    "stage2_acc2": ("stage2", 2, 0.0, "constant", 0.0),
    "stage0_cpo": ("stage0", 1, 0.5, "cosine", 0.0),
}
# the keys, step by step: (m, rows of the batch)
KEYS = [(1, 4), (2, 2), (1, 4), (2, 2)]
JAX_CASES = ("stage2_acc2",)  # JAX compiles a step per key: ~6 s each


def _freeze(mod, name):
    return {"stage0": mod.FreezeConfig(), "stage1": mod.FreezeConfig.stage1(),
            "stage2": mod.FreezeConfig.stage2()}[name]


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def _opt_tensors(state):
    return [x for x in TT.tree_leaves(state.opt_state)
            if isinstance(x, torch.Tensor)]


def _port_run(npp, tb, case, program):
    """4 steps over KEYS: per step (loss, norm) and clones of the
    parameters and moments; the program's buffers' addresses before and
    after; the device scalars against the host schedule."""
    fz, acc, cpo, sched, rate = case
    freeze = _freeze(TT, fz)
    params = port_params(npp)
    tx = TT.make_optimizer(TT.OptimConfig(
        learning_rate=LR, warmup_steps=2, total_steps=6, scheduler=sched),
        params, freeze)
    inner = tx
    if acc > 1:
        tx = TT.MultiSteps(tx, acc)
    state = TT.init_train_state(params, tx)
    kw = dict(cpo_beta=cpo, freeze=freeze, remat=True, encoder_dropout=rate,
              dropout_seed=7)
    if program:
        prog = TT.TrainProgram(CFG, tx, BLOCK, CACHE, "cpu", **kw)
    else:
        steps = {m: TT.make_train_step(CFG, tx, BLOCK, CACHE, multiplier=m,
                                       **kw) for m in (1, 2)}
    out, addrs = [], []
    for i, (m, rows) in enumerate(KEYS):
        batch = TT.Batch(*(x[:rows] for x in tb))
        count = (state.opt_state["inner"] if acc > 1
                 else state.opt_state)["count"]
        if program:
            state, met = prog(state, batch, m)
            loss, gnorm = graphs.read(met["packed"])
            bufs = [state.params, state.opt_state, inner.lr, inner.bc1,
                    inner.bc2, tx.div if acc > 1 else None] + [
                        [*k.batch, k.packed] for k in prog.keys.values()]
            addrs.append([x.data_ptr() for x in TT.tree_leaves(bufs)
                          if isinstance(x, torch.Tensor)])
        else:
            state, met = steps[m](state, batch)
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        applied = acc == 1 or i % acc == acc - 1
        if applied:  # the scalars this update read
            sch = TT.make_schedule(inner.cfg)
            assert inner.lr.item() == np.float32(-sch(count))
            assert inner.bc1.item() == np.float32(1 - 0.9 ** (count + 1))
            assert inner.bc2.item() == np.float32(1 - 0.999 ** (count + 1))
        out.append(((loss, gnorm),
                    [p.clone() for p in TT.tree_leaves(state.params)],
                    [t.clone() for t in _opt_tensors(state)]))
    if program:
        assert len(prog.keys) == 2
        # the first key's buffers, then both keys'
        assert addrs[1][:len(addrs[0])] == addrs[0]
        assert all(a == addrs[1] for a in addrs[1:])
        # no reference cycle: the programs (on a card, their graphs and
        # the communicators those hold) go with their last reference
        gc.disable()
        try:
            refs = [weakref.ref(k.program) for k in prog.keys.values()]
            del prog
            assert all(r() is None for r in refs)
        finally:
            gc.enable()
    assert state.step == 4
    return out, freeze


def _jax_run(jp, jb, case):
    fz, acc, cpo, sched, _ = case
    freeze = _freeze(JT, fz)
    jtx = JT.make_optimizer(JT.OptimConfig(
        learning_rate=LR, warmup_steps=2, total_steps=6, scheduler=sched),
        jp, freeze)
    if acc > 1:
        import optax

        jtx = optax.MultiSteps(jtx, acc)
    js = JT.init_train_state(jp, jtx)
    jsteps = {m: jax.jit(JT.make_train_step(JCFG, jtx, BLOCK, CACHE,
                                            multiplier=m, cpo_beta=cpo,
                                            freeze=freeze, remat=True))
              for m in (1, 2)}
    metrics = []
    for m, rows in KEYS:
        js, jm = jsteps[m](js, JT.Batch(*(x[:rows] for x in jb)))
        metrics.append((float(jm["loss"]), float(jm["grad_norm"])))
    return metrics, [np.asarray(x) for x in
                     jax.tree.leaves(jax.device_get(js.params))]


@pytest.mark.parametrize("case", list(CASES))
def test_program_matches_eager_step_and_jax(setup, case):
    jp, npp, jb, tb = setup
    got, freeze = _port_run(npp, tb, CASES[case], program=True)
    want, _ = _port_run(npp, tb, CASES[case], program=False)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], f"step {i}: {g[0]} against {w[0]}"
        for what, a, b in (("params", g[1], w[1]), ("moments", g[2], w[2])):
            assert len(a) == len(b)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (i, what)
    if case not in JAX_CASES:
        return
    jmetrics, jparams = _jax_run(jp, jb, CASES[case])
    for i, ((l, g), (jl, jg)) in enumerate(zip([x[0] for x in got],
                                               jmetrics)):
        np.testing.assert_allclose(l, jl, rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(g, jg, rtol=1e-5, err_msg=f"step {i}")
    mask = TT.tree_leaves(TT.trainable_mask(port_params(npp), freeze))
    n_far = n_all = 0
    for m, a, w, b in zip(mask, got[-1][1], jparams,
                          TT.tree_leaves(port_params(npp))):
        if not m:
            assert torch.equal(a, b)  # frozen: bitwise
            continue
        d = np.abs(a.numpy() - w)
        assert d.max() <= 10 * LR * 1e-2, d.max()
        n_far += int((d > LR * 1e-2).sum())
        n_all += d.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


def test_fit_reads_only_at_log_steps(tmp_path, setup):
    """``fit`` over 4 steps at log_step 2 makes 2 host reads (each a
    packed [loss, norm]), and an evaluation one a batch; the trainer's
    state keeps its tensors; a state with other tensors is written into
    them."""
    from infinisst_tpu_torch.train.trainer import Trainer
    from tests.test_torch_trainer import _args, _builder, _make_data

    _make_data(tmp_path, n=8)
    t = Trainer(_args(tmp_path, max_steps=4, log_step=2, eval_step=0,
                      save_step=0), CFG, _builder(), port_params(setup[1]),
                device="cpu")
    ptrs = [x.data_ptr() for x in TT.tree_leaves(t.state.params)]
    reads = graphs.host_reads
    assert t.fit() == 4
    assert graphs.host_reads - reads == 2
    assert [x.data_ptr() for x in TT.tree_leaves(t.state.params)] == ptrs
    prog = t._program
    assert prog.keys and all(k[0] in (1, 2) for k in prog.keys)
    _, sampler, _ = t._make_loader("dv", 300, shuffle=False)
    n_batches = len(list(sampler))
    reads = graphs.host_reads
    assert np.isfinite(t.evaluate(4))
    assert graphs.host_reads - reads == n_batches
    # a state on other tensors: written into the static buffers
    other = t.state._replace(params=TT.tree_map(torch.clone, t.state.params))
    first = TT.tree_leaves(other.params)[0]
    first.add_(1.0)
    bound = prog._bind(other)
    assert TT.tree_leaves(bound.params)[0].data_ptr() == ptrs[0]
    assert torch.equal(TT.tree_leaves(t.state.params)[0], first)
