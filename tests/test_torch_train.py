"""The port's training path against the JAX package, on the CPU at the
dryrun preset with its conv extractor narrowed to 128 channels (strides
and kernels as they are), in float32, weights carried across by
``convert/from_jax``:

- ``speech_llm.offline_forward`` logits and ``lm_loss`` (plain and CPO) on
  a trajectory-4 batch with ragged patch masks and frame lengths, three
  rows padded to four by ``pad_to_buckets`` (a dummy row with no attended
  key): rtol 1e-5 (atol 1e-5 of the largest logit);
- the gradient of the loss with respect to every leaf, against
  ``jax.grad``: rtol 1e-4 and atol 1e-6, or 1e-5 of the leaf's largest
  gradient where that exceeds 1 (the extractor's conv and
  LayerNorm biases reach 1e11: the frames of the 399-sample zero offset
  are the same in every channel, so each LayerNorm scales their gradient
  by 1/sqrt(1e-5), and there the largest gradient's float32 rounding
  sets the floor);
- ``offline_hidden(num_layers=1)``, ``waco_loss`` and ``waco_step_fn``;
- (the train steps are held in ``test_torch_train_steps.py``)
- the learning rate against optax's schedule at every count, and the
  optimizer (with and without MultiSteps) against optax's chain on the
  same gradients;
- remat and dropout: gradients with ``remat`` bitwise those without, with
  dropout on; the keep fraction, the 1 / (1 - p) scale, and the masks of
  a (seed, step) pair.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dataclasses

from infinisst_tpu.core import config as JC
from infinisst_tpu.core.presets import dryrun_config as jdryrun
from infinisst_tpu.data.collators import COLLATORS as JCOLLATORS
from infinisst_tpu.data.dataset import SpeechToTextItem as JItem
from infinisst_tpu.data.template import PromptBuilder as JBuilder
from infinisst_tpu.data.template import StubTokenizer as JStub
from infinisst_tpu.models import adapter as JA
from infinisst_tpu.models import llama as JL
from infinisst_tpu.models import speech_llm as JS
from infinisst_tpu.models import wav2vec2 as JW
from infinisst_tpu.train import objective as JO
from infinisst_tpu.train import step as JT
from infinisst_tpu.train import waco as JWACO
from infinisst_tpu.train.trainer import pad_to_buckets as jpad
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core import config as TC
from infinisst_tpu_torch.core.presets import dryrun_config
from infinisst_tpu_torch.models import llama as TL
from infinisst_tpu_torch.models import speech_llm as TS
from infinisst_tpu_torch.models import wav2vec2 as TW
from infinisst_tpu_torch.train import objective as TO
from infinisst_tpu_torch.train import step as TT
from infinisst_tpu_torch.train import waco as TWACO

torch.set_num_threads(1)

CONV = [(128, 10, 5)] + [(128, 3, 2)] * 4 + [(128, 2, 2)] * 2


def _narrow(cfg, conv_cfg):
    return cfg.replace(w2v2=dataclasses.replace(cfg.w2v2,
                                                conv_layers=conv_cfg(CONV)))


JCFG = _narrow(jdryrun(), JC.conv_cfg)
CFG = _narrow(dryrun_config(), TC.conv_cfg)
BLOCK, CACHE = 48, 96
KEYS = ("speech", "frame_lengths", "input_ids", "labels", "attention_mask",
        "patch_mask")


def jax_params():
    k = jax.random.PRNGKey(0)
    return {
        "w2v2": JW.init_params(jax.random.fold_in(k, 0), JCFG.w2v2),
        "adapter": JA.init_params(jax.random.fold_in(k, 1), JCFG.adapter),
        "llama": JL.init_params(jax.random.fold_in(k, 2), JCFG.llama),
    }


def make_setup():
    """JAX params, their numpy copy, and one padded batch on both sides:
    rows of 1920, 960 - 20 and 960 - 40 ms (ragged frame lengths and
    patch counts), padded to four."""
    jp = jax_params()
    npp = jax.device_get(jp)
    builder = JBuilder(JStub(JCFG.llama.vocab_size, lo=10, hi=900),
                       JCFG.tokens)
    items = []
    for i in range(3):
        units = 2 if i == 0 else 1
        src = (np.random.RandomState(i).randn(15360 * units - 320 * i) * 0.1
               ).astype(np.float32)
        traj = [f"seg{i} word{j}" for j in range(units)]
        items.append(JItem(id=f"u{i}", index=i, source=src,
                           target=" ".join(traj), src_text="x",
                           trajectory=traj))
    raw = JCOLLATORS[4](builder, JCFG, block_size=BLOCK, max_multiplier=1,
                        seed=0)(items)
    b = jpad(raw, raw["multiplier"], JCFG.tokens.pad)
    assert b["input_ids"].shape[0] == 4 and b["frame_lengths"][3] == 0
    assert len(set(b["patch_mask"].sum(1)[:3].tolist())) > 1
    jb = JT.Batch(**{k: jnp.asarray(b[k]) for k in KEYS})
    tb = TT.Batch(**{k: torch.from_numpy(b[k]) for k in KEYS})
    return jp, npp, jb, tb


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def port_params(npp):
    return from_jax(npp, device="cpu")


def jax_logits(p, b, **kw):
    return JS.offline_forward(p, JCFG, b.speech, b.input_ids, b.patch_mask,
                              BLOCK, CACHE, frame_lengths=b.frame_lengths,
                              attention_mask=b.attention_mask, **kw)


def port_logits(p, b, **kw):
    return TS.offline_forward(p, CFG, b.speech, b.input_ids, b.patch_mask,
                              BLOCK, CACHE, frame_lengths=b.frame_lengths,
                              attention_mask=b.attention_mask, **kw)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_offline_forward_and_loss_match_jax(setup):
    jp, npp, jb, tb = setup
    want = np.asarray(jax.jit(jax_logits)(jp, jb))
    with torch.no_grad():
        got = port_logits(port_params(npp), tb)
    assert np.isfinite(got.numpy()).all()  # the dummy row too
    _close(got.numpy(), want, 1e-5)
    for beta in (0.0, 0.5):
        j = float(JO.lm_loss(jnp.asarray(want), jb.labels, beta))
        t = float(TO.lm_loss(torch.tensor(want), tb.labels, beta))
        np.testing.assert_allclose(t, j, rtol=1e-5)


def _grad_tol(a):
    scale = float(np.abs(a).max())
    return 1e-6 if scale <= 1 else 1e-5 * scale


def _paths(tree):
    return [jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_leaves_with_path(tree)]


def test_gradients_match_jax(setup):
    jp, npp, jb, tb = setup

    def loss(p):
        return JO.lm_loss(jax_logits(p, jb), jb.labels)

    jg = jax.device_get(jax.jit(jax.grad(loss))(jp))
    tp = port_params(npp)
    leaves = TT.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    got = torch.autograd.grad(TO.lm_loss(port_logits(tp, tb), tb.labels),
                              leaves)
    want = jax.tree.leaves(jg)
    assert len(want) == len(got)
    for path, w, g in zip(_paths(jg), want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=_grad_tol(w), err_msg=path)


def test_offline_hidden_matches_jax(setup):
    jp, npp, jb, _ = setup
    rng = np.random.RandomState(3)
    x = rng.randn(3, 20, JCFG.llama.hidden_size).astype(np.float32)
    am = np.ones((3, 20), np.int32)
    am[2, 11:] = 0
    am[1] = 0  # a row with no attended key stays finite
    want = np.asarray(JL.offline_hidden(jp["llama"], JCFG.llama,
                                        jnp.asarray(x), jnp.asarray(am),
                                        num_layers=1))
    with torch.no_grad():
        got = TL.offline_hidden(port_params(npp)["llama"], CFG.llama,
                                torch.from_numpy(x), torch.from_numpy(am),
                                num_layers=1).numpy()
    assert np.isfinite(got).all()
    _close(got, want, 1e-5)


def test_waco_matches_jax(setup):
    jp, npp, jb, tb = setup
    rng = np.random.RandomState(4)
    s = rng.randn(6, 16).astype(np.float32)
    t = rng.randn(6, 16).astype(np.float32)
    np.testing.assert_allclose(
        float(TO.waco_loss(torch.from_numpy(s), torch.from_numpy(t))),
        float(JO.waco_loss(jnp.asarray(s), jnp.asarray(t))), rtol=1e-5)

    # spans over the first three rows' speech tokens and text ids
    B = 3
    sp = np.zeros((B, 4, 2), np.int32)
    tp_ = np.zeros((B, 4, 2), np.int32)
    mask = np.zeros((B, 4), bool)
    for b in range(B):
        for w in range(3 - b):
            sp[b, w] = (w * 3, w * 3 + 2)
            tp_[b, w] = (w * 2, w * 2 + 1)
            mask[b, w] = True
    text = np.asarray(jb.input_ids)[:B, :12]
    embed = np.asarray(npp["llama"]["embed"])
    jbatch = JWACO.WacoBatch(jb.speech[:B], jb.frame_lengths[:B],
                             jnp.asarray(text), jnp.asarray(sp),
                             jnp.asarray(tp_), jnp.asarray(mask))
    jfn = JWACO.waco_step_fn(JCFG, BLOCK, CACHE)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, e: jfn(p, e, jbatch)))(
        jp, jnp.asarray(embed))
    tbatch = TWACO.WacoBatch(tb.speech[:B], tb.frame_lengths[:B],
                             torch.from_numpy(text), torch.from_numpy(sp),
                             torch.from_numpy(tp_), torch.from_numpy(mask))
    tparams = port_params(npp)
    adapter = TT.tree_leaves(tparams["adapter"])
    for p in adapter:
        p.requires_grad_(True)
    tl = TWACO.waco_step_fn(CFG, BLOCK, CACHE)(
        tparams, torch.from_numpy(embed), tbatch)
    tg = torch.autograd.grad(tl, adapter)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for w, g in zip(jax.tree.leaves(jg["adapter"]), tg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=_grad_tol(w))


def test_collate_waco_matches_jax():
    items = [JItem(id="a", index=0, source=np.zeros(4, np.float32),
                   target="", src_text="",
                   speech_word=[(0.0, 0.31), (0.31, 0.5), (0.5, 0.52)],
                   text_word=[(0, 1), (2, 2), (3, 5)]),
             JItem(id="b", index=1, source=np.zeros(4, np.float32),
                   target="", src_text="")]
    for got, want in zip(TWACO.collate_waco(items, CFG, max_spans=2),
                         JWACO.collate_waco(items, JCFG, max_spans=2)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sched", ["cosine", "constant"])
def test_schedule_matches_optax(sched):
    kw = dict(learning_rate=3e-4, warmup_steps=5, total_steps=40,
              scheduler=sched, min_lr_ratio=0.1)
    want = JT.make_schedule(JT.OptimConfig(**kw))
    got = TT.make_schedule(TT.OptimConfig(**kw))
    for count in range(50):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(count))
    assert got(0) == 0.0


@pytest.mark.parametrize("acc", [1, 3])
def test_optimizer_matches_optax(acc):
    """AdamW (and MultiSteps) against optax's chain on the same gradients
    for 6 steps: gradients above and below the clip norm, entries near
    eps (where an epsilon in the clip, as torch's clip_grad_norm_ adds,
    would show), a frozen leaf; rtol 1e-6."""
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=9,
              clip_norm=1e-7, weight_decay=0.01)
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(5, 3).astype(np.float32),
          "b": rng.randn(4).astype(np.float32)}
    labels = {"a": "train", "b": "freeze"}
    inner = optax.chain(optax.clip_by_global_norm(kw["clip_norm"]),
                        optax.adamw(JT.make_schedule(JT.OptimConfig(**kw)),
                                    weight_decay=kw["weight_decay"]))
    jtx = optax.multi_transform({"train": inner,
                                 "freeze": optax.set_to_zero()}, labels)
    ttx = TT.AdamW(TT.OptimConfig(**kw), [True, False])
    if acc > 1:
        jtx, ttx = optax.MultiSteps(jtx, acc), TT.MultiSteps(ttx, acc)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = [torch.from_numpy(p0["a"].copy()), torch.from_numpy(p0["b"].copy())]
    jst, tst = jtx.init(jp), ttx.init(tp)
    for i in range(6):
        scale = 1e-8 * (0.5 if i % 2 else 40.0)  # norm below / above 1e-7
        g = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
             for k, v in p0.items()}
        upd, jst = jtx.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        tst = ttx.update(tp, [torch.from_numpy(g["a"]), None], tst)
        np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp["a"]),
                                   rtol=1e-6, atol=1e-9, err_msg=str(i))
    assert np.array_equal(tp[1].numpy(), p0["b"])


def _encoder_grads(tp, tb, remat, seed=7, step=3, rate=0.3):
    leaves = TT.tree_leaves(tp["w2v2"])
    for p in leaves:
        p.requires_grad_(True)
    gen = TW.dropout_generator(seed, step, "cpu")
    out = TW.forward(tp["w2v2"], CFG.w2v2, tb.speech, BLOCK, CACHE,
                     tb.frame_lengths, remat=remat, dropout_gen=gen,
                     dropout_rate=rate)
    loss = (out * torch.linspace(-1, 1, out.shape[-1])).sum()
    return [g.clone() for g in torch.autograd.grad(loss, leaves)]


def test_remat_is_bitwise_with_dropout(setup):
    _, npp, _, tb = setup
    tp = port_params(npp)
    a = _encoder_grads(tp, tb, remat=False)
    b = _encoder_grads(tp, tb, remat=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # and the masks are really on: another step gives other gradients
    c = _encoder_grads(tp, tb, remat=True, step=4)
    assert not all(torch.equal(x, y) for x, y in zip(b, c))


def test_dropout_masks():
    rate, shape = 0.1, (4, 96, 128)
    m = TW._keep_mask(TW.dropout_generator(1, 2, "cpu"), shape, rate, "cpu")
    n = m.numel()
    frac = m.float().mean().item()
    assert abs(frac - (1 - rate)) <= 3 * np.sqrt(rate * (1 - rate) / n)
    same = TW._keep_mask(TW.dropout_generator(1, 2, "cpu"), shape, rate,
                         "cpu")
    other = TW._keep_mask(TW.dropout_generator(1, 3, "cpu"), shape, rate,
                          "cpu")
    assert torch.equal(m, same) and not torch.equal(m, other)
    x = torch.full(shape, 2.0)
    y = TW._drop(x, m, rate)
    assert torch.equal(y[m], torch.full((int(m.sum()),), 2.0 / (1 - rate)))
    assert (y[~m] == 0).all()
