"""Training driver; port of ``infinisst_tpu/train/trainer.py``.

- the two-stage recipe via FreezeConfig (stage 0 trains everything, 1 the
  encoder and adapter, 2 the adapter and LLM; ref: model/model.py:106-145);
- the token-budget SpeechSampler and the collator chosen by --trajectory
  0..4 (ref: model/model.py:33-39, :149-226);
- one step function per latency multiplier (the multi-latency collator
  samples m per batch), shapes rounded up to buckets (``pad_to_buckets``);
- gradient accumulation as optax.MultiSteps (ref grad_acc, main.py:185);
- metrics to JSONL (+ wandb when WANDB_PROJECT is set and it imports);
- checkpoints with auto-resume (ref: main.py:199-203);
- a (data, model) mesh (``parallel/mesh.py``) when a process group is
  initialised (``torchrun``, or one the caller made) or ``n_data *
  n_model > 1``: the parameters are split over 'model', every rank builds
  the same whole batch from the same seeded sampler and the sharded step
  keeps its rows, ``zero`` splits the gradients and the optimizer state
  over 'data' (ZeRO-2); rank 0 alone writes the metrics and the
  checkpoints, which hold whole leaves (gathered first) and are cut to
  this rank's slices on restore, so a checkpoint crosses world sizes.

The batches are read, collated and padded in a worker thread
(``_prefetch``), into pinned host memory on a card; the consuming thread
copies each to the card (``non_blocking``) just before its step, on the
step's own stream, so an upload never races the step that reads it.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from infinisst_tpu_torch.core.config import ModelConfig
from infinisst_tpu_torch.core.device import resolve_device
from infinisst_tpu_torch.data.collators import COLLATORS
from infinisst_tpu_torch.data.dataset import SpeechToTextDataset
from infinisst_tpu_torch.data.sampler import SpeechSampler
from infinisst_tpu_torch.data.template import IGNORE_INDEX, PromptBuilder
from infinisst_tpu_torch.parallel.collectives import tensor_parallel
from infinisst_tpu_torch.train import checkpoint as ckpt
from infinisst_tpu_torch.train import step as tstep

BATCH_KEYS = ("speech", "frame_lengths", "input_ids", "labels",
              "attention_mask", "patch_mask")


@dataclass
class TrainerArgs:
    """Mirrors the reference arg dataclasses (train/main.py:31-123)."""

    data_path: str = ""
    data_split_train: str = "train"
    data_split_eval: str = "dev"
    source_lang: str = "English"
    target_lang: str = "German"
    trajectory: int = 4
    trajectory_max_multiplier: int = 4
    trajectory_prob_aug: float = 0.0
    trajectory_perturb: tuple = (0.3, 0.3, 0.4)

    stage: int = 1
    train_bsz: int = 1800  # token budget per batch
    eval_bsz: int = 1800
    bsz_sent: int = 2
    learning_rate: float = 2e-4
    warmup_steps: int = 1000
    scheduler: str = "cosine"
    max_epochs: int = 6
    grad_acc_steps: int = 4
    clip_norm: float = 1.0
    cpo_beta: float = 0.0
    seed: int = 998244353

    block_size: int = 48
    max_cache_size: int = 576

    save_dir: str = "runs/stage1"
    log_step: int = 5
    eval_step: int = 200
    save_step: int = 1000
    max_steps: Optional[int] = None
    debug_mode: bool = False  # fast_dev_run equivalent

    remat: bool = True  # gradient checkpointing (activation memory)
    encoder_dropout: float = 0.1  # fairseq w2v2 training dropout

    # mesh
    n_data: int = 1
    n_model: int = 1
    zero: bool = True


class MetricsLogger:
    """JSONL metrics + optional wandb (ref: WandbLogger, main.py:165-168)."""

    def __init__(self, save_dir: str, run_name: str = "run"):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, "metrics.jsonl")
        self.wandb = None
        if os.environ.get("WANDB_PROJECT"):
            try:  # pragma: no cover - env dependent
                import wandb

                self.wandb = wandb
                wandb.init(
                    project=os.environ["WANDB_PROJECT"],
                    entity=os.environ.get("WANDB_ENTITY"),
                    name=run_name,
                )
            except Exception:
                self.wandb = None

    def log(self, metrics: Dict, step: int):
        rec = {"step": step, "time": time.time(), **metrics}
        # the run dir may vanish mid-fit (a tool sharing the workdir):
        # losing a metrics line beats aborting a long run
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.wandb is not None:  # pragma: no cover
            self.wandb.log(metrics, step=step)


def pad_to_buckets(batch: Dict, m: int, pad_id: int,
                   row_multiple: int = 1) -> Dict:
    """Round (B, S, T) up to bucket sizes (B to a power of two, then to a
    multiple of ``row_multiple``, the mesh's n_data; S to 128, the
    samples past the offset to 960 ms x m units).  Dummy rows and columns
    are fully masked."""
    B, S = batch["input_ids"].shape
    T = batch["speech"].shape[1]

    def round_up(x, mult):
        return ((x + mult - 1) // mult) * mult

    nB = max(1, 1 << (B - 1).bit_length())  # next pow2
    nB = round_up(nB, row_multiple)
    nS = round_up(S, 128)
    unit = 15360 * m
    nT = round_up(max(T - 399, 1), unit) + 399

    out = {}
    ids = np.full((nB, nS), pad_id, np.int32)
    ids[:B, :S] = batch["input_ids"]
    out["input_ids"] = ids
    lab = np.full((nB, nS), IGNORE_INDEX, np.int32)
    lab[:B, :S] = batch["labels"]
    out["labels"] = lab
    am = np.zeros((nB, nS), np.int32)
    am[:B, :S] = batch["attention_mask"]
    out["attention_mask"] = am
    pm = np.zeros((nB, nS), bool)
    pm[:B, :S] = batch["patch_mask"]
    out["patch_mask"] = pm
    sp = np.zeros((nB, nT), np.float32)
    sp[:B, :T] = batch["speech"]
    out["speech"] = sp
    fl = np.zeros((nB,), np.int32)
    fl[:B] = batch["frame_lengths"]
    out["frame_lengths"] = fl
    return out


class Trainer:
    def __init__(
        self,
        args: TrainerArgs,
        model_cfg: ModelConfig,
        builder: PromptBuilder,
        params,
        device="cuda",
    ):
        import torch.distributed as dist

        from infinisst_tpu_torch.parallel import mesh as pmesh

        self.args = args
        self.cfg = model_cfg
        self.builder = builder
        self.device = resolve_device(device)
        params = tstep.tree_map(lambda t: t.to(self.device), params)
        # stage 0 = full fine-tune (nothing frozen), for from-scratch
        # proxies; the reference's staged recipes assume a pretrained LLM
        freeze = {
            0: tstep.FreezeConfig(),
            1: tstep.FreezeConfig.stage1(),
        }.get(args.stage, tstep.FreezeConfig.stage2())
        self.freeze = freeze
        self.mesh, self.plan = None, None
        if dist.is_initialized() or args.n_data * args.n_model > 1:
            zero = args.zero and args.n_data > 1
            self.mesh = pmesh.make_mesh(args.n_data, args.n_model,
                                        self.device)
            params, layouts = pmesh.shard_params(
                params, self.mesh, pmesh.model_param_specs(model_cfg, zero),
                cfg=model_cfg)
            self.plan = tstep.MeshPlan(
                self.mesh, layouts, zero,
                tstep.tree_leaves(tstep.trainable_mask(params, freeze)))
        self.rank0 = self.mesh is None or dist.get_rank() == 0
        opt_cfg = tstep.OptimConfig(
            learning_rate=args.learning_rate,
            warmup_steps=args.warmup_steps,
            scheduler=args.scheduler,
            clip_norm=args.clip_norm,
            total_steps=args.max_steps or 100_000,
        )
        self._schedule = tstep.make_schedule(opt_cfg)
        base_tx = tstep.make_optimizer(opt_cfg, params, freeze)
        self.tx = (tstep.MultiSteps(base_tx, args.grad_acc_steps)
                   if args.grad_acc_steps > 1 else base_tx)
        self._train_idx = [i for i, m in enumerate(self.tx.mask) if m]
        self.state = tstep.init_train_state(params, self.tx, self.plan)
        self.logger = MetricsLogger(args.save_dir) if self.rank0 else None

        self._step_fns: Dict[int, callable] = {}
        self._eval_fns: Dict[int, callable] = {}

    # -- data ---------------------------------------------------------------
    def _make_loader(self, split: str, budget: int, shuffle: bool):
        ds = SpeechToTextDataset.from_tsv(self.args.data_path, split)
        sampler = SpeechSampler(
            ds,
            shuffle=shuffle,
            batch_size=budget,
            batch_size_sent=self.args.bsz_sent,
            min_ms=320,
            multiplier=max(1, self.args.grad_acc_steps),
            tokenizer=self.builder.tokenizer.encode,
        )
        coll_cls = COLLATORS[self.args.trajectory]
        kw = {}
        if self.args.trajectory == 3:
            kw = dict(perturb=self.args.trajectory_perturb, seed=self.args.seed)
        elif self.args.trajectory == 4:
            kw = dict(
                max_multiplier=self.args.trajectory_max_multiplier,
                prob_aug=self.args.trajectory_prob_aug,
                seed=self.args.seed,
            )
        collator = coll_cls(
            self.builder, self.cfg, block_size=self.args.block_size, **kw
        )
        return ds, sampler, collator

    def _get_step_fn(self, m: int):
        if m not in self._step_fns:
            self._step_fns[m] = tstep.make_train_step(
                self.cfg,
                self.tx,
                self.args.block_size,
                self.args.max_cache_size,
                multiplier=m,
                cpo_beta=self.args.cpo_beta,
                freeze=self.freeze,
                remat=self.args.remat,
                encoder_dropout=(
                    self.args.encoder_dropout if self.args.stage == 1 else 0.0
                ),
                dropout_seed=self.args.seed,
                plan=self.plan,
            )
        return self._step_fns[m]

    def _host_batch(self, raw: Dict, m: int) -> Dict[str, torch.Tensor]:
        """The padded batch as host tensors, pinned when the card will
        read them."""
        padded = pad_to_buckets(raw, m, self.cfg.tokens.pad,
                                row_multiple=self.args.n_data)
        out = {k: torch.from_numpy(padded[k]) for k in BATCH_KEYS}
        if self.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _upload(self, host: Dict[str, torch.Tensor]) -> tstep.Batch:
        return tstep.Batch(**{k: v.to(self.device, non_blocking=True)
                              for k, v in host.items()})

    def _to_batch(self, raw: Dict, m: int) -> tstep.Batch:
        return self._upload(self._host_batch(raw, m))

    # -- loops --------------------------------------------------------------
    def _prefetch(self, sampler, ds, collator, depth: int = 2):
        """Depth-bounded background batch preparation: TSV/audio reads,
        collate and bucket-pad run in a worker thread while the card runs
        the current step (the reference DataLoader's worker prefetch, ref
        train/main.py num_workers).  The bounded queue caps host staging
        at ``depth`` batches; each batch is uploaded here, in the
        consuming thread.  Exceptions propagate at the consuming step;
        abandoning the generator stops the worker."""
        import queue as _queue
        import threading

        q: _queue.Queue = _queue.Queue(maxsize=depth)
        DONE, ERR = object(), object()
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded-wait put, so an abandoned consumer (max_steps /
            # debug break) releases the worker instead of leaking it
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def produce():
            try:
                for idx_batch in sampler:
                    samples = [ds[i] for i in idx_batch]
                    raw = collator(samples)
                    m = raw.get("multiplier", 1)
                    if not _put((m, self._host_batch(raw, m))):
                        return
                _put(DONE)
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                _put((ERR, e))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is DONE:
                    return
                if isinstance(item, tuple) and item[0] is ERR:
                    raise item[1]
                m, host = item
                yield m, self._upload(host)
        finally:
            stop.set()
            t.join(timeout=5.0)

    def _save(self, step: int):
        """Write the whole state (gathered over the mesh; rank 0 writes)."""
        state = self.state
        if self.plan is not None:
            import torch.distributed as dist

            state = self.plan.whole_state(state, self._train_idx)
        if self.rank0:
            ckpt.save(os.path.join(self.args.save_dir, "ckpt"), state, step)
        if self.plan is not None:
            dist.barrier()

    def _log(self, metrics: Dict, step: int):
        if self.logger is not None:
            self.logger.log(metrics, step)

    def fit(self):
        args = self.args
        ds, sampler, collator = self._make_loader(
            args.data_split_train, args.train_bsz, shuffle=True
        )
        step = self.state.step
        # auto-resume (ref: main.py:199-203), into the fresh state's
        # tensors, so the card holds one copy
        ckpt_dir = os.path.join(args.save_dir, "ckpt")
        if ckpt.latest_step(ckpt_dir) is not None:
            shard = None
            if self.plan is not None:
                def shard(saved):
                    return self.plan.local_state(saved, self._train_idx)
            self.state = ckpt.restore(ckpt_dir, self.state, shard=shard)
            step = self.state.step
            print(f"resumed from step {step}")

        t0 = time.time()
        for epoch in range(args.max_epochs):
            sampler.set_epoch(epoch)
            for m, batch in self._prefetch(sampler, ds, collator):
                self.state, metrics = self._get_step_fn(m)(self.state, batch)
                step += 1
                if step % args.log_step == 0:
                    loss = float(metrics["loss"])
                    self._log(
                        {
                            "train_loss": loss,
                            f"train_loss_m{m}": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "lr": float(self._schedule(step)),
                            "epoch": epoch,
                            "sec_per_step": (time.time() - t0) / max(step, 1),
                        },
                        step,
                    )
                if args.eval_step and step % args.eval_step == 0:
                    self.evaluate(step)
                if args.save_step and step % args.save_step == 0:
                    self._save(step)
                if args.max_steps and step >= args.max_steps:
                    break
                if args.debug_mode:
                    break
            if (args.max_steps and step >= args.max_steps) or args.debug_mode:
                break
        self._save(step)
        return step

    def evaluate(self, step: int):
        args = self.args
        try:
            ds, sampler, collator = self._make_loader(
                args.data_split_eval, args.eval_bsz, shuffle=False
            )
        except FileNotFoundError:
            return None
        losses = []
        for idx_batch in sampler:
            samples = [ds[i] for i in idx_batch]
            raw = collator(samples)
            m = raw.get("multiplier", 1)
            if m not in self._eval_fns:
                self._eval_fns[m] = tstep.eval_step_fn(
                    self.cfg, args.block_size, args.max_cache_size, m
                )
            batch = self._to_batch(raw, m)
            # every rank evaluates the whole batch (its model slice)
            with tensor_parallel(self.mesh):
                losses.append(float(self._eval_fns[m](self.state.params,
                                                      batch)))
            if args.debug_mode:
                break
        if losses:
            self._log({"eval_loss": float(np.mean(losses))}, step)
        return float(np.mean(losses)) if losses else None
