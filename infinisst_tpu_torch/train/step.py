"""The training step; port of ``infinisst_tpu/train/step.py`` on one card.

The optimizer keeps optax's arithmetic (the JAX step's
``multi_transform({'train': chain(clip_by_global_norm, adamw(schedule)),
'freeze': set_to_zero()})``, under ``MultiSteps`` when gradients are
accumulated):

- the clip is over the trainable leaves' global norm, ``g / norm *
  max_norm`` when ``norm >= max_norm``, with no epsilon (unlike
  ``torch.nn.utils.clip_grad_norm_``), selected on the device;
- AdamW: bias-corrected moments, ``eps`` outside the square root, the
  weight decay added to the update before the learning rate scales it;
- the schedule's count is the number of updates already applied, so the
  first update uses ``schedule(0)`` (0 under a warmup);
- frozen leaves never change and carry no optimizer state;
- ``MultiSteps`` keeps the running mean ``acc + (g - acc) / (k + 1)`` of
  the gradients and applies the update on every k-th mini-step.

Freeze flags reproduce the two-stage recipe (ref: model/model.py:106-138):
stage 1 freezes the LLM (body, embedding, head) and trains the encoder and
adapter; stage 2 freezes the w2v2 body.  Only the leaves the step trains
get ``requires_grad``, so no gradient buffer is made for a frozen leaf
(stage 1's frozen 8B LLM); gradients still flow through it to the speech
embeddings.  Parameters and optimizer state are updated in place (where
the JAX step donates them); the counts are host ints and the metrics stay
on the device, so a step makes the host wait for nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from infinisst_tpu_torch.core.config import ModelConfig
from infinisst_tpu_torch.models import speech_llm
from infinisst_tpu_torch.models.wav2vec2 import dropout_generator
from infinisst_tpu_torch.train.objective import lm_loss


# -- parameter trees (nested dicts and lists of tensors) ----------------------

def tree_leaves(tree) -> List[Any]:
    """The leaves in JAX's order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


@dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 2e-4
    warmup_steps: int = 1000
    total_steps: int = 100_000
    scheduler: str = "cosine"  # 'cosine' | 'constant'
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_norm: float = 1.0
    min_lr_ratio: float = 0.0


@dataclass(frozen=True)
class FreezeConfig:
    """ref: train/main.py:60-76 (llm_freeze etc.), model/model.py:106-138."""

    w2v2: bool = False
    adapter: bool = False
    llm: bool = False
    llm_embed: bool = False
    llm_head: bool = False

    @staticmethod
    def stage1() -> "FreezeConfig":
        return FreezeConfig(llm=True, llm_embed=True, llm_head=True)

    @staticmethod
    def stage2() -> "FreezeConfig":
        return FreezeConfig(w2v2=True)


def trainable_mask(params: Dict[str, Any], freeze: FreezeConfig):
    """Tree of bools: True = trainable."""
    llama = params["llama"]
    return {
        "w2v2": tree_map(lambda _: not freeze.w2v2, params["w2v2"]),
        "adapter": tree_map(lambda _: not freeze.adapter, params["adapter"]),
        "llama": {
            "embed": not freeze.llm_embed,
            "layers": tree_map(lambda _: not freeze.llm, llama["layers"]),
            "final_ln": not freeze.llm,
            "lm_head": not freeze.llm_head,
        },
    }


def make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup, max(total,
    warmup + 1), peak * min_lr_ratio)``, or the join of
    ``linear_schedule(0, peak, warmup)`` and ``constant_schedule(peak)``;
    count -> learning rate."""
    peak, warmup = cfg.learning_rate, cfg.warmup_steps

    def linear(count):
        if warmup <= 0:
            return 0.0
        frac = 1 - min(max(count, 0), warmup) / warmup
        return (0.0 - peak) * frac + peak

    if cfg.scheduler == "cosine":
        decay = max(cfg.total_steps, warmup + 1) - warmup
        alpha = 0.0 if peak == 0.0 else peak * cfg.min_lr_ratio / peak

        def after(count):
            c = min(count, decay)
            cosine = 0.5 * (1 + math.cos(math.pi * c / decay))
            return peak * ((1 - alpha) * cosine + alpha)
    else:
        def after(count):
            return peak

    def schedule(count: int) -> float:
        return linear(count) if count < warmup else after(count - warmup)

    return schedule


def global_norm(xs) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares, in the leaves'
    dtype, on the device."""
    return torch.sqrt(sum(torch.sum(x * x) for x in xs))


class AdamW:
    """optax ``multi_transform`` of ``chain(clip_by_global_norm(clip_norm),
    adamw(schedule, b1, b2, eps, weight_decay))`` over the leaves ``mask``
    marks trainable and ``set_to_zero`` over the rest, on flat leaf lists
    (``tree_leaves`` order).  State: {'count', 'mu', 'nu'} with one moment
    per trainable leaf, in its dtype."""

    def __init__(self, cfg: OptimConfig, mask: List[bool]):
        self.cfg = cfg
        self.mask = list(mask)
        self.schedule = make_schedule(cfg)

    def init(self, leaves) -> Dict[str, Any]:
        train = [p for p, m in zip(leaves, self.mask) if m]
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in train],
                "nu": [torch.zeros_like(p) for p in train]}

    @torch.no_grad()
    def update(self, leaves, grads, state) -> Dict[str, Any]:
        """Apply one update in place: ``grads`` aligned with ``leaves``,
        None where no gradient was taken (a zero gradient)."""
        c = self.cfg
        train = [(p, torch.zeros_like(p) if g is None else g)
                 for p, g, m in zip(leaves, grads, self.mask) if m]
        if not train:
            return state
        norm = global_norm([g for _, g in train])
        keep = norm < c.clip_norm
        count = state["count"] + 1
        bc1, bc2 = 1 - c.b1 ** count, 1 - c.b2 ** count
        lr = -self.schedule(state["count"])
        for (p, g), mu, nu in zip(train, state["mu"], state["nu"]):
            g = torch.where(keep, g, (g / norm.to(g.dtype)) * c.clip_norm)
            mu.copy_((1 - c.b1) * g + c.b1 * mu)
            nu.copy_((1 - c.b2) * (g * g) + c.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + c.eps)
            u = u + c.weight_decay * p
            p.add_(lr * u)
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}


def adam(lr: float, n_leaves: int) -> AdamW:
    """optax.adam(lr) over ``n_leaves`` leaves, all trained: b1 0.9, b2
    0.999, eps 1e-8 after the square root, a constant rate, no clip, no
    decay."""
    return AdamW(OptimConfig(learning_rate=lr, warmup_steps=0,
                             scheduler="constant", clip_norm=math.inf),
                 [True] * n_leaves)


class MultiSteps:
    """optax.MultiSteps(inner, every_k) with the gradient mean: the running
    mean of the mini-steps' gradients goes to ``inner`` on every k-th one;
    the others leave the parameters as they are."""

    def __init__(self, inner: AdamW, every_k: int):
        self.inner = inner
        self.k = every_k
        self.mask = inner.mask

    def init(self, leaves) -> Dict[str, Any]:
        return {"mini_step": 0, "gradient_step": 0,
                "acc": [torch.zeros_like(p) for p, m in zip(leaves, self.mask)
                        if m],
                "inner": self.inner.init(leaves)}

    @torch.no_grad()
    def update(self, leaves, grads, state) -> Dict[str, Any]:
        n = state["mini_step"]
        acc = state["acc"]
        grads_t = [g for g, m in zip(grads, self.mask) if m]
        for a, g in zip(acc, grads_t):
            if g is not None:
                a.copy_(a + (g - a) / (n + 1))
            else:
                a.copy_(a + (0 - a) / (n + 1))
        if n < self.k - 1:
            return {**state, "mini_step": n + 1}
        it = iter(acc)
        full = [next(it) if m else None for m in self.mask]
        inner = self.inner.update(leaves, full, state["inner"])
        for a in acc:
            a.zero_()
        return {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                "acc": acc, "inner": inner}


def make_optimizer(cfg: OptimConfig, params, freeze: FreezeConfig) -> AdamW:
    return AdamW(cfg, tree_leaves(trainable_mask(params, freeze)))


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def init_train_state(params, tx) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(tree_leaves(params)),
                      step=0)


class Batch(NamedTuple):
    """One training batch (collated on the host; see data/collators.py).
    The latency multiplier is fixed per step function (the multi-latency
    collator samples m per batch) and is passed to make_train_step."""

    speech: torch.Tensor  # (B, T) raw samples incl. 399-sample offset
    frame_lengths: torch.Tensor  # (B,) valid encoder frames
    input_ids: torch.Tensor  # (B, S)
    labels: torch.Tensor  # (B, S)
    attention_mask: torch.Tensor  # (B, S)
    patch_mask: torch.Tensor  # (B, S) bool, ids == sp_patch


def _forward(cfg, params, batch: Batch, block_frames, max_cache_frames,
             remat=False, dropout_gen=None, dropout_rate=0.0):
    return speech_llm.offline_forward(
        params, cfg, batch.speech, batch.input_ids, batch.patch_mask,
        block_frames, max_cache_frames, frame_lengths=batch.frame_lengths,
        attention_mask=batch.attention_mask, remat=remat,
        dropout_gen=dropout_gen, dropout_rate=dropout_rate,
    )


def make_train_step(
    cfg: ModelConfig,
    tx,
    block_frames: int,
    max_cache_frames: int,
    multiplier: int = 1,
    cpo_beta: float = 0.0,
    freeze: Optional[FreezeConfig] = None,
    remat: bool = False,
    encoder_dropout: float = 0.0,
    dropout_seed: int = 0,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), metrics the
    loss and the global norm of the gradients taken (before the clip), as
    device tensors.  With ``freeze`` the gradients are taken only with
    respect to its trainable leaves; without, with respect to every leaf
    (``tx`` still moves only its own).  ``remat`` checkpoints the encoder
    and decoder layers; ``encoder_dropout`` > 0 applies the encoder's
    training dropout with masks drawn from (``dropout_seed``, step)."""

    def train_step(state: TrainState, batch: Batch):
        leaves = tree_leaves(state.params)
        take = (tree_leaves(trainable_mask(state.params, freeze))
                if freeze is not None else [True] * len(leaves))
        gen = None
        if encoder_dropout > 0:
            gen = dropout_generator(dropout_seed, state.step,
                                    batch.speech.device)
        try:
            with torch.enable_grad():
                for p, t in zip(leaves, take):
                    p.requires_grad_(t)
                logits = _forward(cfg, state.params, batch,
                                  block_frames * multiplier,
                                  max_cache_frames, remat, gen,
                                  encoder_dropout)
                loss = lm_loss(logits, batch.labels, cpo_beta)
                del logits
                wrt = [p for p, t in zip(leaves, take) if t]
                got = torch.autograd.grad(loss, wrt)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        it = iter(got)
        grads = [next(it) if t else None for t in take]
        gnorm = global_norm(got).detach()
        opt_state = tx.update(leaves, grads, state.opt_state)
        return (TrainState(state.params, opt_state, state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return train_step


def eval_step_fn(
    cfg: ModelConfig, block_frames: int, max_cache_frames: int,
    multiplier: int = 1,
) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch: Batch):
        logits = _forward(cfg, params, batch, block_frames * multiplier,
                          max_cache_frames)
        return lm_loss(logits, batch.labels)

    return eval_step
