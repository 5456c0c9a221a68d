"""The port's trainer, checkpoints and training CLI on the CPU at the
dryrun preset (float32): ``fit`` for 3 steps then resume to 5 (as
``tests/test_trainer.py::test_fit_and_resume``), ``max_to_keep``,
``_prefetch`` against the sequential loop and its worker's stop, stage 0
moving every component, ``evaluate`` against JAX's ``eval_step_fn``
(rtol 1e-5), ``export_torch_bin`` against JAX's key by key (bitwise), the
NaN of a target id past the vocabulary (as JAX's gather fills it),
``train.main`` for 2 steps, and the refusals (a mesh without a process
group of its size; CUDA without a card)."""

import csv
import json
import math
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.core.presets import dryrun_config as jdryrun
from infinisst_tpu.data.collators import COLLATORS as JCOLLATORS
from infinisst_tpu.data.dataset import SpeechToTextDataset as JDataset
from infinisst_tpu.data.sampler import SpeechSampler as JSampler
from infinisst_tpu.data.template import PromptBuilder as JBuilder
from infinisst_tpu.data.template import StubTokenizer as JStub
from infinisst_tpu.train import checkpoint as JCK
from infinisst_tpu.train import objective as JO
from infinisst_tpu.train import step as JT
from infinisst_tpu.train.trainer import pad_to_buckets as jpad
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core.presets import dryrun_config
from infinisst_tpu_torch.data.audio import write_wav
from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
from infinisst_tpu_torch.train import checkpoint as ckpt
from infinisst_tpu_torch.train import main as train_main
from infinisst_tpu_torch.train import objective as TO
from infinisst_tpu_torch.train import step as TT
from infinisst_tpu_torch.train.trainer import Trainer, TrainerArgs

torch.set_num_threads(1)

CFG = dryrun_config()
JCFG = jdryrun()


def _make_data(tmp_path, n=6, text=True):
    rng = np.random.RandomState(0)
    rows = []
    for i in range(n):
        n_units = int(rng.randint(1, 3))
        wav = (rng.randn(n_units * 15360) * 0.1).astype(np.float32)
        path = str(tmp_path / f"u{i}.wav")
        write_wav(path, wav)
        traj = [f"seg{i} tok{j}" if text else "" for j in range(n_units)]
        rows.append({
            "id": f"u{i}", "audio": path, "n_frames": str(len(wav)),
            "src_text": "src words", "tgt_text": " ".join(traj) or "x",
            "trajectory": repr(traj),
        })
    for split in ("tr", "dv"):
        with open(tmp_path / f"{split}.tsv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t",
                               quotechar=None, doublequote=False,
                               lineterminator="\n", quoting=csv.QUOTE_NONE)
            w.writeheader()
            w.writerows(rows)


def _builder():
    return PromptBuilder(StubTokenizer(CFG.llama.vocab_size, lo=10, hi=900),
                         CFG.tokens)


def _args(tmp_path, **kw):
    base = dict(
        data_path=str(tmp_path), data_split_train="tr",
        data_split_eval="dv", trajectory=4, trajectory_max_multiplier=2,
        stage=2, train_bsz=300, eval_bsz=300, bsz_sent=2,
        learning_rate=1e-3, warmup_steps=1, max_steps=3, grad_acc_steps=1,
        save_dir=str(tmp_path / "run"), max_cache_size=96,
    )
    base.update(kw)
    return TrainerArgs(**base)


@pytest.fixture(scope="module")
def npp():
    return jax.device_get(jax_params_dryrun())


def jax_params_dryrun():
    k = jax.random.PRNGKey(0)
    from infinisst_tpu.models import adapter as A
    from infinisst_tpu.models import llama as L
    from infinisst_tpu.models import wav2vec2 as W

    return {
        "w2v2": W.init_params(jax.random.fold_in(k, 0), JCFG.w2v2),
        "adapter": A.init_params(jax.random.fold_in(k, 1), JCFG.adapter),
        "llama": L.init_params(jax.random.fold_in(k, 2), JCFG.llama),
    }


def _trainer(tmp_path, npp, **kw):
    return Trainer(_args(tmp_path, **kw), CFG, _builder(),
                   from_jax(npp, device="cpu"), device="cpu")


def test_fit_and_resume(tmp_path, npp):
    _make_data(tmp_path)
    t = _trainer(tmp_path, npp, log_step=1, eval_step=2, save_step=3)
    assert t.fit() == 3
    lines = [json.loads(x) for x in
             open(tmp_path / "run" / "metrics.jsonl").read().splitlines()]
    assert any("train_loss" in x for x in lines)
    assert any("eval_loss" in x for x in lines)
    assert all(math.isfinite(x.get("train_loss", 0.0)) for x in lines)
    assert ckpt.latest_step(str(tmp_path / "run" / "ckpt")) == 3

    # resume continues from step 3; the restored state is the saved one
    t2 = _trainer(tmp_path, npp, max_steps=5, log_step=1, eval_step=0,
                  save_step=0)
    saved = t.state
    restored = ckpt.restore(str(tmp_path / "run" / "ckpt"), t2.state)
    assert restored.step == 3
    for a, b in zip(TT.tree_leaves(saved.params),
                    TT.tree_leaves(restored.params)):
        assert torch.equal(a, b)
    assert t2.fit() == 5
    assert ckpt.latest_step(str(tmp_path / "run" / "ckpt")) == 5


def test_max_to_keep(tmp_path, npp):
    t = _trainer(tmp_path, npp)
    d = str(tmp_path / "ck")
    for s in (1, 2, 3):
        ckpt.save(d, t.state._replace(step=s), s)
    assert sorted(os.listdir(d)) == ["2", "3"]
    assert ckpt.latest_step(d) == 3
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), t.state)


def test_prefetch_matches_sequential(tmp_path, npp):
    _make_data(tmp_path)
    t = _trainer(tmp_path, npp)
    ds, sampler, collator = t._make_loader("tr", 300, shuffle=True)
    sampler.set_epoch(0)
    seq = []
    for idx_batch in sampler:
        raw = collator([ds[i] for i in idx_batch])
        m = raw.get("multiplier", 1)
        seq.append((m, t._to_batch(raw, m)))
    assert len(seq) > 1

    ds, sampler, collator = t._make_loader("tr", 300, shuffle=True)
    sampler.set_epoch(0)
    pre = list(t._prefetch(sampler, ds, collator))
    assert len(pre) == len(seq)
    for (m_a, b_a), (m_b, b_b) in zip(pre, seq):
        assert m_a == m_b
        for x, y in zip(b_a, b_b):
            assert torch.equal(x, y)

    # early abandonment (fit's max_steps break) stops the worker
    n0 = threading.active_count()
    sampler.set_epoch(0)
    gen = t._prefetch(sampler, ds, collator)
    next(gen)
    gen.close()
    assert threading.active_count() <= n0


def test_stage0_trains_everything(tmp_path, npp):
    _make_data(tmp_path, n=2)
    t = _trainer(tmp_path, npp, trajectory=1, stage=0, max_steps=2,
                 log_step=1, eval_step=0, save_step=0)
    assert not any([t.freeze.w2v2, t.freeze.adapter, t.freeze.llm,
                    t.freeze.llm_embed, t.freeze.llm_head])
    before = {c: [p.clone() for p in TT.tree_leaves(t.state.params[c])]
              for c in ("w2v2", "adapter", "llama")}
    t.fit()
    for comp, leaves in before.items():
        after = TT.tree_leaves(t.state.params[comp])
        assert any(not torch.equal(a, b) for a, b in zip(after, leaves)), comp


def test_evaluate_matches_jax(tmp_path, npp):
    """Trainer.evaluate's mean loss over the dev split equals the mean of
    JAX's eval_step_fn over the same collated, padded batches."""
    _make_data(tmp_path)
    t = _trainer(tmp_path, npp, eval_step=1)
    got = t.evaluate(0)

    jbuilder = JBuilder(JStub(JCFG.llama.vocab_size, lo=10, hi=900),
                        JCFG.tokens)
    ds = JDataset.from_tsv(str(tmp_path), "dv")
    sampler = JSampler(ds, shuffle=False, batch_size=300, batch_size_sent=2,
                       min_ms=320, multiplier=1,
                       tokenizer=jbuilder.tokenizer.encode)
    coll = JCOLLATORS[4](jbuilder, JCFG, block_size=48, max_multiplier=2,
                         seed=t.args.seed)
    jp = jax_params_dryrun()
    losses = []
    for idx in sampler:
        raw = coll([ds[i] for i in idx])
        m = raw["multiplier"]
        b = jpad(raw, m, JCFG.tokens.pad)
        batch = JT.Batch(**{k: jnp.asarray(b[k]) for k in (
            "speech", "frame_lengths", "input_ids", "labels",
            "attention_mask", "patch_mask")})
        losses.append(float(JT.eval_step_fn(JCFG, 48, 96, m)(jp, batch)))
    np.testing.assert_allclose(got, float(np.mean(losses)), rtol=1e-5)
    lines = open(tmp_path / "run" / "metrics.jsonl").read()
    assert "eval_loss" in lines


def test_export_torch_bin_matches_jax(tmp_path, npp):
    want = JCK.export_torch_bin(npp, JCFG, str(tmp_path / "j.bin"))
    got = ckpt.export_torch_bin(from_jax(npp, device="cpu"), CFG,
                                str(tmp_path / "t.bin"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    back = torch.load(str(tmp_path / "t.bin"), weights_only=True)
    assert all(torch.equal(back[k], want[k]) for k in want)


def test_label_past_vocab_is_nan_as_in_jax():
    logits = np.random.RandomState(0).randn(1, 4, 8).astype(np.float32)
    labels = np.array([[-100, 3, 9, -100]], np.int32)
    j = float(JO.lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    t = float(TO.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert math.isnan(j) and math.isnan(t)


def test_main_runs_two_steps(tmp_path):
    """The CLI at the dryrun preset on the CPU.  The trajectories carry no
    text: the CLI's stub tokenizer's ids lie past the dryrun vocabulary,
    which makes the loss NaN (as in JAX), so only the eot is a target."""
    _make_data(tmp_path, n=4, text=False)
    final = train_main.main([
        "--device", "cpu", "--model_preset", "dryrun",
        "--data_path", str(tmp_path), "--data_split_train", "tr",
        "--data_split_eval", "dv", "--max_steps", "2", "--log_step", "1",
        "--eval_step", "0", "--save_step", "0", "--grad_acc_steps", "1",
        "--train_bsz", "300", "--max_cache_size", "96",
        "--save_dir", str(tmp_path / "run"), "--remat", "false",
    ])
    assert final == 2
    lines = [json.loads(x) for x in
             open(tmp_path / "run" / "metrics.jsonl").read().splitlines()]
    assert [x["step"] for x in lines] == [1, 2]
    assert all(math.isfinite(x["train_loss"]) for x in lines)
    assert ckpt.latest_step(str(tmp_path / "run" / "ckpt")) == 2


def test_trainer_refuses_a_mesh(tmp_path, npp):
    """A mesh of more than one rank needs a process group of its size
    (torchrun's, or the caller's): without one the Trainer raises; it
    never trains on one process instead."""
    with pytest.raises(ValueError, match="process group of world size 2"):
        _trainer(tmp_path, npp, n_data=2)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")


def test_cuda_without_a_card_raises(tmp_path, npp, no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_args(tmp_path), CFG, _builder(), from_jax(npp, "cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main.main(["--model_preset", "dryrun",
                         "--data_path", str(tmp_path)])


def _recording_step(trainer, ids):
    """Replace the trainer's step functions by one that records each
    batch's input ids and advances the step count, so that ``fit``'s
    loop, its epochs, its save and its resume run without training."""
    def step(state, batch):
        ids.append(np.asarray(batch.input_ids).copy())
        return (state._replace(step=state.step + 1),
                {"loss": 0.0, "grad_norm": 0.0, "packed": torch.zeros(2)})

    trainer._get_step_fn = lambda m: step


def test_resumed_fit_restarts_its_epoch_as_jax(tmp_path, npp):
    """A resumed ``fit`` runs ``range(max_epochs)`` from epoch 0 again
    (the JAX package's ``fit``, ``trainer.py:338-339``): past one epoch,
    then resumed, the port's batches and logged epochs equal JAX's, and
    the resumed run's first epoch is 0."""
    from infinisst_tpu.train.trainer import Trainer as JTrainer
    from infinisst_tpu.train.trainer import TrainerArgs as JArgs

    _make_data(tmp_path)
    probe = _trainer(tmp_path, npp)
    ds, sampler, _ = probe._make_loader("tr", 300, shuffle=True)
    sampler.set_epoch(0)
    per_epoch = len(list(sampler))
    first, total = per_epoch + 1, per_epoch + 3
    got = {}
    for side in ("jax", "port"):
        run = tmp_path / f"run_{side}"
        ids, epochs = [], []
        for max_steps in (first, total):
            kw = dict(max_steps=max_steps, log_step=1, eval_step=0,
                      save_step=0, save_dir=str(run))
            if side == "jax":
                a = _args(tmp_path, **kw)
                t = JTrainer(JArgs(**a.__dict__), JCFG, JBuilder(
                    JStub(JCFG.llama.vocab_size, lo=10, hi=900),
                    JCFG.tokens), npp)
            else:
                t = _trainer(tmp_path, npp, **kw)
            _recording_step(t, ids)
            assert t.fit() == max_steps
        with open(run / "metrics.jsonl") as f:
            epochs = [json.loads(x)["epoch"] for x in f.read().splitlines()]
        got[side] = (ids, epochs)
    (jids, jep), (pids, pep) = got["jax"], got["port"]
    assert len(pids) == len(jids) == total
    for a, b in zip(pids, jids):
        np.testing.assert_array_equal(a, b)
    assert pep == jep
    assert pep[:first] == [0] * per_epoch + [1]
    assert pep[first:] == [0, 0]  # the resumed fit starts at epoch 0
    # so the resumed run's batches are epoch 0's first ones again
    np.testing.assert_array_equal(pids[first], pids[0])
