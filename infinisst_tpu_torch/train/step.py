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

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from infinisst_tpu_torch.core.config import ModelConfig
from infinisst_tpu_torch.models import speech_llm
from infinisst_tpu_torch.models.wav2vec2 import dropout_generator
from infinisst_tpu_torch.parallel.collectives import tensor_parallel
from infinisst_tpu_torch.train.objective import IGNORE_INDEX, lm_loss


# -- parameter trees (nested dicts and lists of tensors) ----------------------

def tree_leaves(tree) -> List[Any]:
    """The leaves in JAX's order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree`` with its leaves replaced by ``leaves``, given in
    ``tree_leaves`` order (dict keys sorted)."""
    it = iter(leaves)

    def rec(t):
        if isinstance(t, dict):
            new = {k: rec(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(rec(v) for v in t)
        return next(it)

    return rec(tree)


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
    per trainable leaf, in its dtype.  ``norm_fn`` maps the trainable
    gradients to their global norm (``global_norm``; the sharded step
    sums each leaf's squares once over the mesh)."""

    def __init__(self, cfg: OptimConfig, mask: List[bool],
                 norm_fn: Callable = global_norm):
        self.cfg = cfg
        self.mask = list(mask)
        self.schedule = make_schedule(cfg)
        self.norm_fn = norm_fn

    def init(self, leaves) -> Dict[str, Any]:
        train = [p for p, m in zip(leaves, self.mask) if m]
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in train],
                "nu": [torch.zeros_like(p) for p in train]}

    @torch.no_grad()
    def update(self, leaves, grads, state) -> Dict[str, Any]:
        """Apply one update in place: ``grads`` aligned with ``leaves``,
        None where no gradient was taken (a zero gradient).  A list's
        entries are released as they are used, so that the gradients of
        the leaves already updated are freed before the next leaf's
        temporaries are made: per leaf, two of its size (the clipped
        gradient and one scratch), each step of optax's arithmetic
        written in place in the same order (the same roundings)."""
        c = self.cfg
        grads = grads if isinstance(grads, list) else list(grads)
        idx = [i for i, m in enumerate(self.mask) if m]
        if not idx:
            return state
        for i in idx:
            if grads[i] is None:
                grads[i] = torch.zeros_like(leaves[i])
        norm = self.norm_fn([grads[i] for i in idx])
        keep = norm < c.clip_norm
        count = state["count"] + 1
        bc1, bc2 = 1 - c.b1 ** count, 1 - c.b2 ** count
        lr = -self.schedule(state["count"])
        for i, mu, nu in zip(idx, state["mu"], state["nu"]):
            p, g = leaves[i], grads[i]
            grads[i] = None
            # g = g if norm < clip else g / norm * clip
            gc = torch.div(g, norm.to(g.dtype))
            gc.mul_(c.clip_norm)
            torch.where(keep, g, gc, out=gc)
            del g
            # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
            a = gc * (1 - c.b1)
            mu.mul_(c.b1).add_(a)
            torch.mul(gc, gc, out=a)
            a.mul_(1 - c.b2)
            nu.mul_(c.b2).add_(a)
            # u = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd p;  p += lr u
            torch.div(nu, bc2, out=gc)
            gc.sqrt_()
            gc.add_(c.eps)
            torch.div(mu, bc1, out=a)
            a.div_(gc)
            torch.mul(p, c.weight_decay, out=gc)
            a.add_(gc)
            a.mul_(lr)
            p.add_(a)
            del gc, a
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
    """The state at step 0 (on a mesh: of this rank's leaves, so the
    optimizer state of a leaf split by ``shard_params`` is its shard's)."""
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
             remat=False, dropout_gen=None, dropout_rate=0.0,
             dropout_rows=None):
    return speech_llm.offline_forward(
        params, cfg, batch.speech, batch.input_ids, batch.patch_mask,
        block_frames, max_cache_frames, frame_lengths=batch.frame_lengths,
        attention_mask=batch.attention_mask, remat=remat,
        dropout_gen=dropout_gen, dropout_rate=dropout_rate,
        dropout_rows=dropout_rows,
    )


# -- the sharded step (a (data, model) mesh, parallel/mesh.py) ----------------

def data_rows(B: int, n_data: int, r_data: int, pairs: bool) -> List[int]:
    """The rows of a batch of B that data rank ``r_data`` of ``n_data``
    takes: a contiguous block, or with ``pairs`` (CPO's [winners;
    losers]) the r-th block of each half, so that every pair stays on
    one rank."""
    if pairs:
        half = B // 2
        if half % n_data:
            raise ValueError(f"a CPO batch of {B} rows ({half} pairs) does "
                             f"not split over n_data={n_data}")
        k = half // n_data
        return (list(range(r_data * k, (r_data + 1) * k))
                + list(range(half + r_data * k, half + (r_data + 1) * k)))
    if B % n_data:
        raise ValueError(f"a batch of {B} rows does not split over "
                         f"n_data={n_data}")
    k = B // n_data
    return list(range(r_data * k, (r_data + 1) * k))


class MeshPlan:
    """How the sharded step treats each leaf (``tree_leaves`` order) on a
    (data, model) ``DeviceMesh``, from the layouts ``mesh.shard_params``
    returns:

    - ``model_dims[i]``: the dim of leaf i split over 'model' (its
      gradient and optimizer state are split there too), or None;
    - ``zero_dims[i]``: the dim of leaf i split over 'data' (FSDP, the
      JAX package's ``zero``: the parameter itself, frozen or trained),
      or None.  A split leaf is gathered where a forward uses it, and
      the gather's backward reduce-scatters its gradient, which so
      arrives summed over 'data' and shard-shaped: no whole gradient is
      held, the optimizer updates the shard, and nothing is gathered
      after the update.  The gradient of a leaf not split over 'data'
      is all-reduced over it.

    The global norm counts each leaf's squares once: a model-split or
    data-split piece on its own rank, a replicated one on rank 0 of the
    axes it is replicated over, summed over the whole mesh."""

    def __init__(self, mesh, layout_tree):
        from infinisst_tpu_torch.parallel import mesh as pmesh

        sizes = pmesh.mesh_shape(mesh)
        self.mesh = mesh
        self.n_data, self.n_model = sizes["data"], sizes["model"]
        self.world = self.n_data * self.n_model
        self.r_data = mesh.get_local_rank("data")
        self.r_model = mesh.get_local_rank("model")
        self.layouts = layout_tree
        lays = pmesh.layout_leaves(layout_tree)
        self.model_dims = [
            lt.model_dim if self.n_model > 1 else None for lt in lays]
        self.zero_dims = [
            lt.data_dim if self.n_data > 1 else None for lt in lays]

    def _group(self, axis):
        return self.mesh.get_group(axis)

    def _view(self, t, dim, n, r):
        k = t.shape[dim] // n
        return t.narrow(dim, r * k, k)

    def sync_grad(self, i: int, g: torch.Tensor) -> torch.Tensor:
        """Leaf i's gradient summed over 'data': a split leaf's arrives
        summed (its gather's reduce-scatter), a whole one's is
        all-reduced."""
        import torch.distributed as dist

        if self.n_data == 1 or self.zero_dims[i] is not None:
            return g
        g = g.contiguous()
        dist.all_reduce(g, group=self._group("data"))
        return g

    def _owned(self, i: int) -> bool:
        return ((self.model_dims[i] is not None or self.r_model == 0)
                and (self.zero_dims[i] is not None or self.r_data == 0))

    def norm_fn(self, indices: List[int]) -> Callable:
        """The global norm of the gradients of leaves ``indices`` (their
        order), each leaf's squares counted once over the mesh."""
        import torch.distributed as dist

        def norm(xs):
            sq = sum(torch.sum(x * x) for i, x in zip(indices, xs)
                     if self._owned(i))
            if self.world > 1:
                # the leaves' promoted dtype on every rank, also on one
                # that owns none of them
                dt = functools.reduce(torch.promote_types,
                                      (x.dtype for x in xs))
                sq = torch.as_tensor(sq, dtype=dt,
                                     device=xs[0].device).clone()
                dist.all_reduce(sq)
            return torch.sqrt(sq)

        return norm

    def loss_sum(self, loss: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        if self.n_data == 1:
            return loss
        loss = loss.clone()
        dist.all_reduce(loss, group=self._group("data"))
        return loss

    # -- whole states, for checkpoints ---------------------------------
    def _moment_map(self, fn, opt_state, train_idx):
        """``fn(tensor, leaf index)`` over the per-leaf tensors of an
        AdamW or MultiSteps state (mu, nu, acc lists, aligned with the
        trainable leaves ``train_idx``); the counts pass through."""
        out = {}
        for k, v in opt_state.items():
            if k in ("mu", "nu", "acc"):
                out[k] = [fn(t, i) for t, i in zip(v, train_idx)]
            elif isinstance(v, dict):
                out[k] = self._moment_map(fn, v, train_idx)
            else:
                out[k] = v
        return out

    def whole_state(self, state: TrainState, train_idx) -> TrainState:
        """Every leaf and moment gathered whole (a collective)."""
        from infinisst_tpu_torch.parallel.mesh import (
            gather_dim,
            gather_params,
        )

        def whole(t, i):
            if self.zero_dims[i] is not None:
                t = gather_dim(t, self.zero_dims[i], self._group("data"))
            if self.model_dims[i] is not None:
                t = gather_dim(t, self.model_dims[i], self._group("model"))
            return t

        params = gather_params(state.params, self.mesh, self.layouts)
        return TrainState(params, self._moment_map(whole, state.opt_state,
                                                   train_idx), state.step)

    def local_state(self, saved: Dict[str, Any], train_idx) -> Dict:
        """A whole saved state ({'params', 'opt_state', 'step'}) cut to
        this rank's slices (the inverse of ``whole_state``)."""
        def local(t, i):
            if self.model_dims[i] is not None:
                t = self._view(t, self.model_dims[i], self.n_model,
                               self.r_model)
            if self.zero_dims[i] is not None:
                t = self._view(t, self.zero_dims[i], self.n_data,
                               self.r_data)
            return t

        leaves = tree_leaves(saved["params"])
        params = tree_unflatten(saved["params"], [
            local(t, i) for i, t in enumerate(leaves)])
        return {"params": params,
                "opt_state": self._moment_map(local, saved["opt_state"],
                                              train_idx),
                "step": saved["step"]}


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
    plan: Optional[MeshPlan] = None,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), metrics the
    loss and the global norm of the gradients taken (before the clip), as
    device tensors.  With ``freeze`` the gradients are taken only with
    respect to its trainable leaves; without, with respect to every leaf
    (``tx`` still moves only its own).  ``remat`` checkpoints the encoder
    and decoder layers; ``encoder_dropout`` > 0 applies the encoder's
    training dropout with masks drawn from (``dropout_seed``, step).

    With a mesh ``plan`` (``MeshPlan``; the state from
    ``init_train_state`` on this rank's parameters) the step is the
    sharded one, run by every rank on the same whole batch: the rank
    keeps its rows (``data_rows``), draws the whole batch's dropout
    masks and keeps its rows', divides its loss by the whole batch's
    target count (and CPO pairs), sums the gradients over 'data' (a
    leaf split over 'data' by its gather's reduce-scatter in the
    backward), clips by the mesh-wide norm and updates its shards; the
    forwards run under ``tensor_parallel``.  It computes what the
    one-card step computes (to the order of float32 sums; at world size
    1 the same operations)."""
    if plan is not None:
        inner = tx.inner if isinstance(tx, MultiSteps) else tx
        inner.norm_fn = plan.norm_fn(
            [i for i, m in enumerate(inner.mask) if m])

    def train_step(state: TrainState, batch: Batch):
        leaves = tree_leaves(state.params)
        take = (tree_leaves(trainable_mask(state.params, freeze))
                if freeze is not None else [True] * len(leaves))
        idx = [i for i, t in enumerate(take) if t]
        dev = batch.speech.device
        local, totals, drows = batch, {}, None
        if plan is not None and plan.n_data > 1:
            B = batch.input_ids.shape[0]
            rows = torch.tensor(
                data_rows(B, plan.n_data, plan.r_data, cpo_beta > 0),
                dtype=torch.int64, device=dev)
            local = Batch(*(x.index_select(0, rows) for x in batch))
            tgt = batch.labels[:, 1:] != IGNORE_INDEX
            totals = (dict(total_count=tgt[:B // 2].sum(),
                           total_pairs=B // 2) if cpo_beta > 0
                      else dict(total_count=tgt.sum()))
            drows = (B, rows)
        gen = None
        if encoder_dropout > 0:
            gen = dropout_generator(dropout_seed, state.step, dev)
        try:
            with torch.enable_grad(), tensor_parallel(
                    None if plan is None else plan.mesh):
                for p, t in zip(leaves, take):
                    p.requires_grad_(t)
                logits = _forward(cfg, state.params, local,
                                  block_frames * multiplier,
                                  max_cache_frames, remat, gen,
                                  encoder_dropout, drows)
                loss = lm_loss(logits, local.labels, cpo_beta, **totals)
                del logits
                wrt = [p for p, t in zip(leaves, take) if t]
                got = torch.autograd.grad(loss, wrt)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        it = iter(got)
        grads = [next(it) if t else None for t in take]
        del got, it  # the optimizer releases each gradient once it is used
        norm = global_norm
        if plan is not None:
            grads = [None if g is None else plan.sync_grad(i, g)
                     for i, g in enumerate(grads)]
            norm = plan.norm_fn(idx)
        gnorm = norm([grads[i] for i in idx]).detach()
        opt_state = tx.update(leaves, grads, state.opt_state)
        loss = loss.detach()
        if plan is not None:
            loss = plan.loss_sum(loss)
        return (TrainState(state.params, opt_state, state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

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
