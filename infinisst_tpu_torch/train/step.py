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

from infinisst_tpu_torch.core import graphs
from infinisst_tpu_torch.core.config import ModelConfig
from infinisst_tpu_torch.models import speech_llm
from infinisst_tpu_torch.models.wav2vec2 import (
    dropout_generator,
    dropout_seed_of,
)
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
    sums each leaf's squares once over the mesh).

    An update is three parts, so that a captured graph can hold the
    tensor work: ``prepare`` (the host writes the pass's scalars into
    0-dim float32 tensors on the device: ``lr`` = -schedule(count),
    ``bc1``/``bc2`` = 1 - b1/b2 ** (count + 1), computed in float64 and
    rounded once), ``apply`` (the tensor work, reading only those
    tensors) and ``advance`` (the host's count).  ``update`` runs all
    three."""

    def __init__(self, cfg: OptimConfig, mask: List[bool],
                 norm_fn: Callable = global_norm):
        self.cfg = cfg
        self.mask = list(mask)
        self.idx = [i for i, m in enumerate(self.mask) if m]
        self.schedule = make_schedule(cfg)
        self.norm_fn = norm_fn
        self.lr = self.bc1 = self.bc2 = None  # made on first ``prepare``

    def init(self, leaves) -> Dict[str, Any]:
        train = [p for p, m in zip(leaves, self.mask) if m]
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in train],
                "nu": [torch.zeros_like(p) for p in train]}

    def make_scalars(self, device):
        if self.lr is None:
            self.lr, self.bc1, self.bc2 = (
                torch.zeros((), dtype=torch.float32, device=device)
                for _ in range(3))

    def prepare(self, state, device):
        """Write the scalars of the update from ``state`` (fills: no
        upload, no synchronisation)."""
        if not self.idx:
            return
        c = self.cfg
        self.make_scalars(device)
        count = state["count"] + 1
        self.lr.fill_(-self.schedule(state["count"]))
        self.bc1.fill_(1 - c.b1 ** count)
        self.bc2.fill_(1 - c.b2 ** count)

    @torch.no_grad()
    def apply(self, leaves, grads, state):
        """The update's tensor work, in place: ``grads`` aligned with
        ``leaves``, None where no gradient was taken (a zero gradient).  A
        list's entries are released as they are used, so that the
        gradients of the leaves already updated are freed before the next
        leaf's temporaries are made: per leaf, two of its size (the
        clipped gradient and one scratch), each step of optax's arithmetic
        written in place in the same order (the same roundings)."""
        c = self.cfg
        grads = grads if isinstance(grads, list) else list(grads)
        if not self.idx:
            return
        for i in self.idx:
            if grads[i] is None:
                grads[i] = torch.zeros_like(leaves[i])
        norm = self.norm_fn([grads[i] for i in self.idx])
        keep = norm < c.clip_norm
        for i, mu, nu in zip(self.idx, state["mu"], state["nu"]):
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
            torch.div(nu, self.bc2, out=gc)
            gc.sqrt_()
            gc.add_(c.eps)
            torch.div(mu, self.bc1, out=a)
            a.div_(gc)
            torch.mul(p, c.weight_decay, out=gc)
            a.add_(gc)
            a.mul_(self.lr)
            p.add_(a)
            del gc, a

    def advance(self, state) -> Dict[str, Any]:
        """The state after an update (the host's count)."""
        if not self.idx:
            return state
        return {"count": state["count"] + 1, "mu": state["mu"],
                "nu": state["nu"]}

    def update(self, leaves, grads, state) -> Dict[str, Any]:
        """Apply one update in place (``prepare``, ``apply``,
        ``advance``)."""
        if self.idx:
            self.prepare(state, leaves[self.idx[0]].device)
        self.apply(leaves, grads, state)
        return self.advance(state)


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
    the others leave the parameters as they are.

    The host decides from its own count (``applies``) whether a mini-step
    applies the update, as optax's ``lax.cond`` does on the device:
    ``accumulate`` (the running mean, divided by the device scalar ``div``
    = n + 1 that ``prepare`` writes) and, on the k-th, ``apply`` (the
    inner update of the mean, then the mean zeroed) are the tensor
    work."""

    def __init__(self, inner: AdamW, every_k: int):
        self.inner = inner
        self.k = every_k
        self.mask = inner.mask
        self.div = None  # made on first ``prepare``

    def init(self, leaves) -> Dict[str, Any]:
        return {"mini_step": 0, "gradient_step": 0,
                "acc": [torch.zeros_like(p) for p, m in zip(leaves, self.mask)
                        if m],
                "inner": self.inner.init(leaves)}

    def applies(self, state) -> bool:
        return state["mini_step"] >= self.k - 1

    def prepare(self, state, device):
        if self.div is None:
            self.div = torch.zeros((), dtype=torch.float32, device=device)
            self.inner.make_scalars(device)
        self.div.fill_(state["mini_step"] + 1)
        if self.applies(state):
            self.inner.prepare(state["inner"], device)

    @torch.no_grad()
    def accumulate(self, grads, state):
        acc = state["acc"]
        grads_t = [g for g, m in zip(grads, self.mask) if m]
        for a, g in zip(acc, grads_t):
            if g is not None:
                a.copy_(a + (g - a) / self.div)
            else:
                a.copy_(a + (0 - a) / self.div)

    @torch.no_grad()
    def apply(self, leaves, state):
        it = iter(state["acc"])
        full = [next(it) if m else None for m in self.mask]
        self.inner.apply(leaves, full, state["inner"])
        for a in state["acc"]:
            a.zero_()

    def advance(self, state) -> Dict[str, Any]:
        if not self.applies(state):
            return {**state, "mini_step": state["mini_step"] + 1}
        return {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                "acc": state["acc"],
                "inner": self.inner.advance(state["inner"])}

    def update(self, leaves, grads, state) -> Dict[str, Any]:
        self.prepare(state, leaves[0].device)
        self.accumulate(grads, state)
        if self.applies(state):
            self.apply(leaves, state)
        return self.advance(state)


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
            owned = [torch.sum(x * x) for i, x in zip(indices, xs)
                     if self._owned(i)]
            if self.world == 1:
                return torch.sqrt(sum(owned))
            # the leaves' promoted dtype on every rank; a rank that owns
            # none of them makes its zero on the device (no upload)
            dt = functools.reduce(torch.promote_types,
                                  (x.dtype for x in xs))
            sq = (sum(owned).to(dt).clone() if owned else
                  torch.zeros((), dtype=dt, device=xs[0].device))
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


class _StepCore:
    """One step's device work, which ``make_train_step`` and
    ``TrainProgram`` both run (one implementation of a step): the forward
    (with remat), ``autograd.grad``, the gradients' sync over the mesh and
    their global norm, then the optimizer's tensor work (``tx.apply``; a
    ``MultiSteps`` accumulates, and applies where told).  It reads no
    host value of the state: the caller writes the optimizer's scalars
    first (``tx.prepare``) and advances its counts after."""

    def __init__(self, cfg, tx, block_frames, max_cache_frames, multiplier,
                 cpo_beta, freeze, remat, encoder_dropout, plan):
        self.cfg, self.tx, self.plan = cfg, tx, plan
        self.block_frames = block_frames * multiplier
        self.max_cache_frames = max_cache_frames
        self.cpo_beta, self.freeze, self.remat = cpo_beta, freeze, remat
        self.rate = encoder_dropout
        if plan is not None:
            inner = tx.inner if isinstance(tx, MultiSteps) else tx
            inner.norm_fn = plan.norm_fn(inner.idx)

    def rows(self, B: int, device) -> Optional[torch.Tensor]:
        """The rows of a batch of B this data rank keeps (an index tensor:
        an upload), or None off a data-split mesh."""
        plan = self.plan
        if plan is None or plan.n_data == 1:
            return None
        return torch.tensor(
            data_rows(B, plan.n_data, plan.r_data, self.cpo_beta > 0),
            dtype=torch.int64, device=device)

    def __call__(self, params, opt_state, batch: Batch, gen, rows,
                 apply: bool):
        """Returns (loss, grad norm) on the device; the parameters and the
        optimizer state's tensors are updated in place."""
        plan, tx = self.plan, self.tx
        leaves = tree_leaves(params)
        take = (tree_leaves(trainable_mask(params, self.freeze))
                if self.freeze is not None else [True] * len(leaves))
        idx = [i for i, t in enumerate(take) if t]
        local, totals, drows = batch, {}, None
        if rows is not None:
            B = batch.input_ids.shape[0]
            local = Batch(*(x.index_select(0, rows) for x in batch))
            tgt = batch.labels[:, 1:] != IGNORE_INDEX
            totals = (dict(total_count=tgt[:B // 2].sum(),
                           total_pairs=B // 2) if self.cpo_beta > 0
                      else dict(total_count=tgt.sum()))
            drows = (B, rows)
        try:
            with torch.enable_grad(), tensor_parallel(
                    None if plan is None else plan.mesh):
                for p, t in zip(leaves, take):
                    p.requires_grad_(t)
                logits = _forward(self.cfg, params, local, self.block_frames,
                                  self.max_cache_frames, self.remat, gen,
                                  self.rate, drows)
                loss = lm_loss(logits, local.labels, self.cpo_beta, **totals)
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
        if isinstance(tx, MultiSteps):
            tx.accumulate(grads, opt_state)
            del grads
            if apply:
                tx.apply(leaves, opt_state)
        else:
            tx.apply(leaves, grads, opt_state)
        loss = loss.detach()
        if plan is not None:
            loss = plan.loss_sum(loss)
        return loss, gnorm


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
    1 the same operations).

    The step runs eagerly; ``TrainProgram`` runs the same work as
    captured device programs."""
    core = _StepCore(cfg, tx, block_frames, max_cache_frames, multiplier,
                     cpo_beta, freeze, remat, encoder_dropout, plan)

    def train_step(state: TrainState, batch: Batch):
        dev = batch.speech.device
        gen = None
        if encoder_dropout > 0:
            gen = dropout_generator(dropout_seed, state.step, dev)
        tx.prepare(state.opt_state, dev)
        apply = not isinstance(tx, MultiSteps) or tx.applies(state.opt_state)
        loss, gnorm = core(state.params, state.opt_state, batch, gen,
                           core.rows(batch.input_ids.shape[0], dev), apply)
        return (TrainState(state.params, tx.advance(state.opt_state),
                           state.step + 1),
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


# -- the step as device programs ----------------------------------------------

def with_counts(like, saved):
    """``like`` with the host ints (the optimizer's counts) of ``saved``,
    a state of the same structure; ``like``'s tensors."""
    if isinstance(like, dict):
        return {k: with_counts(v, saved[k]) for k, v in like.items()}
    if isinstance(like, list):
        return [with_counts(v, s) for v, s in zip(like, saved)]
    return like if isinstance(like, torch.Tensor) else saved


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class _Key:
    """The static buffers of one key of a ``TrainProgram``: the batch
    (filled from the caller's with non-blocking copies, from pinned host
    memory on a card), the data rank's rows, the dropout generator, the
    outputs, and the key's ``DeviceProgram``."""

    def __init__(self, batch: Batch, device, rows=None, generator=None):
        self.batch = Batch(*(torch.empty(x.shape, dtype=x.dtype,
                                         device=device) for x in batch))
        self.rows, self.generator = rows, generator
        self.program: Optional[graphs.DeviceProgram] = None

    def load(self, batch: Batch):
        for d, s in zip(self.batch, batch):
            d.copy_(s, non_blocking=True)


class TrainProgram:
    """``make_train_step``'s step and ``eval_step_fn``'s as device programs
    (``core/graphs.py``), the counterpart of the JAX trainer's
    ``jax.jit(train_step, donate_argnums=(0,))`` and jitted eval step:

    - the state is static: the first call's parameters and optimizer
      tensors are the buffers the graphs hold; they are updated in place,
      and a state with other tensors is written into them
      (``graphs.put``), never rebound.  The host keeps the counts;
    - one ``DeviceProgram`` per key, as ``jax.jit`` retraces per shape:
      (m, the padded batch's shapes) for the step, the same with "eval"
      for the eval step; one ``GraphPool`` for them all.  A key holds its
      static batch, its data rows (built once), a packed [loss, grad
      norm] (float32; the eval step's loss alone) and, with encoder
      dropout, one generator, registered with the graph and reseeded
      each step from ``dropout_seed_of(seed, step)``, so that a step
      draws ``dropout_generator``'s masks;
    - the step's piece is the whole step (``_StepCore``): forward with
      remat, the gradients, the sync and norm, the clip and the update.
      Under ``MultiSteps`` it accumulates, and on the k-th mini-step a
      second program (one for all keys) applies the update: the host
      takes optax's ``lax.cond`` from its own count;
    - the host writes the optimizer's scalars before a pass and never
      reads a value: the caller reads the packed outputs through
      ``graphs.read``.  They are overwritten by the key's next pass.

    With ``captured`` on a card each program is captured as CUDA graphs
    at its first pass (its warm-up, which is that step itself, run inside
    the graphs' pool: a later key's warm-up reuses the blocks the keys
    captured before keep their temporaries in, instead of needing a
    step's activations and gradients beside them); otherwise, and on the
    CPU, the same pieces run as they are.  A failed capture or replay
    raises."""

    def __init__(self, cfg: ModelConfig, tx, block_frames: int,
                 max_cache_frames: int, device, cpo_beta: float = 0.0,
                 freeze: Optional[FreezeConfig] = None, remat: bool = False,
                 encoder_dropout: float = 0.0, dropout_seed: int = 0,
                 plan: Optional[MeshPlan] = None, captured: bool = True):
        self.cfg, self.tx, self.plan = cfg, tx, plan
        self.block_frames, self.max_cache_frames = (block_frames,
                                                    max_cache_frames)
        self.device = torch.device(device)
        self.cpo_beta, self.freeze, self.remat = cpo_beta, freeze, remat
        self.encoder_dropout, self.dropout_seed = encoder_dropout, dropout_seed
        self.pool = (graphs.GraphPool(self.device, warm_inside=True)
                     if captured and self.device.type == "cuda" else None)
        self.keys: Dict[tuple, _Key] = {}
        self._cores: Dict[int, _StepCore] = {}
        self._params = self._opt = None  # the static state (first call's)
        self._apply: Optional[graphs.DeviceProgram] = None

    # -- the static state ----------------------------------------------
    def _bind_params(self, params):
        if self._params is None:
            self._params = params
        else:
            graphs.put(_tensors(self._params), _tensors(params))
        return self._params

    def _bind(self, state: TrainState) -> TrainState:
        params = self._bind_params(state.params)
        if self._opt is None:
            self._opt = state.opt_state
        else:
            graphs.put(_tensors(self._opt), _tensors(state.opt_state))
        return TrainState(params, with_counts(self._opt, state.opt_state),
                          state.step)

    # -- the programs ----------------------------------------------------
    def _core(self, m: int) -> _StepCore:
        if m not in self._cores:
            self._cores[m] = _StepCore(
                self.cfg, self.tx, self.block_frames, self.max_cache_frames,
                m, self.cpo_beta, self.freeze, self.remat,
                self.encoder_dropout, self.plan)
        return self._cores[m]

    def _step_key(self, batch: Batch, m: int) -> _Key:
        key = (m,) + tuple(batch.speech.shape) + tuple(batch.input_ids.shape)
        if key in self.keys:
            return self.keys[key]
        core = self._core(m)
        gen = (torch.Generator(device=self.device)
               if self.encoder_dropout > 0 else None)
        k = _Key(batch, self.device,
                 core.rows(batch.input_ids.shape[0], self.device), gen)
        k.packed = torch.zeros((2,), dtype=torch.float32, device=self.device)
        k.metrics = {"loss": k.packed[0], "grad_norm": k.packed[1],
                     "packed": k.packed}
        params, opt = self._params, self._opt
        apply = not isinstance(self.tx, MultiSteps)
        # the piece holds the key's tensors, not the key: a cycle through
        # the key would keep the graphs, and the process group's
        # communicators they hold, alive until a collection
        batch_, rows, packed = k.batch, k.rows, k.packed

        def step():
            loss, gnorm = core(params, opt, batch_, gen, rows, apply)
            packed[0].copy_(loss)
            packed[1].copy_(gnorm)

        k.program = graphs.DeviceProgram(
            {"step": step}, self.pool,
            {"step": [gen]} if gen is not None else None)
        self.keys[key] = k
        return k

    def _apply_program(self) -> graphs.DeviceProgram:
        if self._apply is None:
            tx, leaves, opt = self.tx, tree_leaves(self._params), self._opt
            self._apply = graphs.DeviceProgram(
                {"apply": lambda: tx.apply(leaves, opt)}, self.pool)
        return self._apply

    # -- passes ----------------------------------------------------------
    def __call__(self, state: TrainState, batch: Batch,
                 multiplier: int = 1):
        """One train step: (the state after it, metrics).  ``batch`` may
        lie on the host (pinned on a card) or on the device.  The metrics
        are the key's static outputs: "loss", "grad_norm" and "packed"
        (the two, for one ``graphs.read``)."""
        state = self._bind(state)
        tx = self.tx
        k = self._step_key(batch, multiplier)
        applies = isinstance(tx, MultiSteps) and tx.applies(state.opt_state)
        tx.prepare(state.opt_state, self.device)
        if k.generator is not None:
            k.generator.manual_seed(dropout_seed_of(self.dropout_seed,
                                                    state.step))
        with k.program.step():
            k.load(batch)
            k.program.run("step")
        if applies:
            prog = self._apply_program()
            with prog.step():
                prog.run("apply")
        return (TrainState(state.params, tx.advance(state.opt_state),
                           state.step + 1), k.metrics)

    def evaluate(self, params, batch: Batch,
                 multiplier: int = 1) -> torch.Tensor:
        """``eval_step_fn``'s loss of ``batch`` (the key's static 0-dim
        output: read it through ``graphs.read``)."""
        params = self._bind_params(params)
        key = ("eval", multiplier) + tuple(batch.speech.shape) + tuple(
            batch.input_ids.shape)
        k = self.keys.get(key)
        if k is None:
            k = _Key(batch, self.device)
            k.loss = torch.zeros((), dtype=torch.float32, device=self.device)
            fn = eval_step_fn(self.cfg, self.block_frames,
                              self.max_cache_frames, multiplier)
            mesh = None if self.plan is None else self.plan.mesh
            batch_, loss = k.batch, k.loss  # not the key (``_step_key``)

            def evaluate():
                with tensor_parallel(mesh):
                    loss.copy_(fn(params, batch_))

            k.program = graphs.DeviceProgram({"eval": evaluate}, self.pool)
            self.keys[key] = k
        with k.program.step():
            k.load(batch)
            k.program.run("eval")
        return k.loss
