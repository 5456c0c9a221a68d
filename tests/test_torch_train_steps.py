"""Four ``make_train_step`` steps of the port against the JAX package's,
on the batch and weights of ``test_torch_train.py`` (the dryrun preset,
its conv extractor narrowed, float32): stage 1, stage 2 with
``grad_acc_steps=2`` and stage 0 with ``cpo_beta=0.5``, warmup 2 over
cosine and constant schedules, remat on.  Loss and grad norm per step
rtol 1e-5; frozen leaves bitwise; every trainable leaf moved; the
parameters after step 4 within 10 x lr x 1e-2 and all but 1e-3 of their
entries within lr x 1e-2 (Adam turns a gradient entry that is float32
rounding noise into an update of about lr: the few entries that differ).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from infinisst_tpu.train import step as JT
from infinisst_tpu_torch.train import step as TT
from tests.test_torch_train import (
    BLOCK,
    CACHE,
    CFG,
    JCFG,
    _paths,
    make_setup,
    port_params,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(tree))]


STEP_CASES = {
    "stage1": (JT.FreezeConfig.stage1(), 1, 0.0, "cosine"),
    "stage2_acc2": (JT.FreezeConfig.stage2(), 2, 0.0, "constant"),
    "stage0_cpo": (JT.FreezeConfig(), 1, 0.5, "cosine"),
}
LR = 1e-3


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(setup, case):
    jp, npp, jb, tb = setup
    freeze, acc, cpo, sched = STEP_CASES[case]
    kw = dict(learning_rate=LR, warmup_steps=2, total_steps=6,
              scheduler=sched)
    jtx = JT.make_optimizer(JT.OptimConfig(**kw), jp, freeze)
    tfreeze = TT.FreezeConfig(**freeze.__dict__)
    tp = port_params(npp)
    ttx = TT.make_optimizer(TT.OptimConfig(**kw), tp, tfreeze)
    if acc > 1:
        jtx, ttx = optax.MultiSteps(jtx, acc), TT.MultiSteps(ttx, acc)
    js, ts = JT.init_train_state(jp, jtx), TT.init_train_state(tp, ttx)
    jstep = jax.jit(JT.make_train_step(JCFG, jtx, BLOCK, CACHE,
                                       cpo_beta=cpo, freeze=freeze,
                                       remat=True))
    tstep = TT.make_train_step(CFG, ttx, BLOCK, CACHE, cpo_beta=cpo,
                               freeze=tfreeze, remat=True)
    before = [p.clone() for p in TT.tree_leaves(tp)]
    for i in range(4):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
    assert ts.step == 4
    mask = TT.tree_leaves(TT.trainable_mask(ts.params, tfreeze))
    after = TT.tree_leaves(ts.params)
    paths = _paths(js.params)
    n_far = n_all = 0
    for path, m, b, a, w in zip(paths, mask, before, after,
                                _jax_leaves(js.params)):
        if not m:
            assert torch.equal(a, b), path  # frozen: bitwise
            continue
        assert not torch.equal(a, b), path
        d = np.abs(a.numpy() - w)
        assert d.max() <= 10 * LR * 1e-2, (path, d.max())
        n_far += int((d > LR * 1e-2).sum())
        n_all += d.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)
    assert all(mask) == (case == "stage0_cpo")
