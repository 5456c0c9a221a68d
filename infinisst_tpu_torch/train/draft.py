"""The early-exit draft adapter of the speculative decoders and its
distillation; port of ``infinisst_tpu/train/draft.py``.

The adapter h -> h + w2 silu(w1 rmsnorm(h)) runs on the draft's hidden
state before ``final_ln`` (``models/llama.apply_exit_adapter``), on the
draft path only: the verify forward never sees it, so any adapter leaves
the speculative decoders exact and moves only their acceptance.  The
``.npz`` format is the JAX package's (arrays ``ln``, ``w1``, ``w2`` and
the draft depth ``draft_layers``), so an adapter distilled in either
package loads in the other.

Distillation (adapter only, the backbone frozen), as in JAX:
``rollout_corpus`` decodes the target model's own greedy continuations
(the contexts the draft is queried at), ``collect_targets`` runs one
teacher pass that keeps the layer-d hidden and the full model's logits,
and ``distill`` fits the adapter by Adam on KL(teacher || draft) through
``final_ln`` and the lm_head; ``distill_on_features`` does the same over
features collected beforehand (``collect_targets_x`` over spliced
embeddings).  ``beam_rollout_states`` and ``beam_selection_distill`` fit
an adapter for speculative beam search to the target's whole top-B
selection.  The optimizer is optax's ``adam`` in optax's order
(``train/step.adam``).  The draws differ from
JAX's: ``init_exit_adapter`` takes a ``torch.Generator``.

JAX jits each loop's body; here each is a set of device programs
(``core/graphs.py``), captured as CUDA graphs on a card, one per shape
as ``jax.jit`` retraces per shape, on state allocated with the program
and written in place:

- the rollouts (``Rollouts``: JAX's ``_rollout`` and ``step_logp``): a
  greedy key's prefill and one-token step, a beam key's whole step (the
  forward, the selection, the reorder); the positions that move are
  device tensors advanced in place;
- the teacher pass (``_TeacherPass``: JAX's ``teacher_fn``), its outputs
  copied into the caller's cache;
- one Adam step (``_Fit``: JAX's ``step_fn``s): the loss,
  ``autograd.grad`` over the adapter's three leaves and the update, on
  the leaves, the moments and the optimizer's device scalars (which the
  host fills before a step); [loss, agreement] packed for one host read
  at the log steps.

The host reads a device value only where the history or the caller needs
it: a log step's pair, a beam rollout's records once at its end.  Every
entry point takes ``captured`` (default True): False, and the CPU, run
the same pieces as they are.  A failed capture or replay raises.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import OrderedDict
from types import SimpleNamespace
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from infinisst_tpu_torch.core import graphs
from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.decode.beam import NEG_INF, select_candidates
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.models.quant import is_quantized
from infinisst_tpu_torch.streaming.state import init_decoder_state
from infinisst_tpu_torch.train.step import adam, tree_leaves

Adapter = dict


def init_exit_adapter(generator: torch.Generator, cfg: LlamaConfig,
                      rank: Optional[int] = None, dtype=torch.float32,
                      device="cpu") -> Adapter:
    """A fresh adapter: ``w2`` zero, so it is the identity; ``w1`` normal
    / sqrt(D) from ``generator`` (on ``device``).  ``rank`` defaults to
    hidden_size / 2."""
    D = cfg.hidden_size
    r = rank or D // 2
    w1 = torch.randn((D, r), generator=generator, device=device,
                     dtype=torch.float32) / math.sqrt(D)
    return {
        "ln": torch.ones((D,), dtype=dtype, device=device),
        "w1": w1.to(dtype),
        "w2": torch.zeros((r, D), dtype=dtype, device=device),
    }


def draft_logits(params, cfg: LlamaConfig, adapter: Optional[Adapter],
                 h_d: torch.Tensor) -> torch.Tensor:
    """The draft's head over a layer-d hidden: adapter, final_ln,
    lm_head (the tail of ``llama.decode_step`` on a draft)."""
    h = h_d
    if adapter is not None:
        h = llama_mod.apply_exit_adapter(adapter, h, cfg.rms_norm_eps)
    h = llama_mod._rms_norm(h, params["final_ln"], cfg.rms_norm_eps)
    return h @ params["lm_head"]


def collect_targets(params, cfg: LlamaConfig, ids: torch.Tensor, d: int,
                    attention_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The teacher pass over token ids (B, S): (h_d (B, S, D), teacher
    logits (B, S, V)), both detached."""
    x = llama_mod.embed(params, ids)
    return collect_targets_x(params, cfg, x, d, attention_mask)


@torch.no_grad()
def collect_targets_x(params, cfg: LlamaConfig, x: torch.Tensor, d: int,
                      attention_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``collect_targets`` over input embeddings (B, S, D), e.g. the
    speech-spliced sequences of ``speech_llm.offline_spliced_embeddings``.
    The first d layers run once: the rest of the stack continues from
    their hidden state."""
    h_d = llama_mod.offline_hidden(params, cfg, x, attention_mask,
                                   num_layers=d)
    rest = {k: v[d:] for k, v in params["layers"].items()}
    h_L = llama_mod._offline_scan(rest, cfg, h_d, attention_mask,
                                  remat=False)
    h_L = llama_mod._rms_norm(h_L, params["final_ln"], cfg.rms_norm_eps)
    return h_d, h_L @ params["lm_head"]


def _refuse_quantized(params, what: str):
    if is_quantized(params["lm_head"]):
        raise ValueError(what)


def _pool(device: torch.device, captured: bool):
    """The graphs' pool of one owner's programs: None (run as they are)
    uncaptured or off a card."""
    return (graphs.GraphPool(device)
            if captured and device.type == "cuda" else None)


# -- the rollouts -------------------------------------------------------------

class Rollouts:
    """The target model's rollouts as device programs: ``greedy`` (JAX's
    jitted ``_rollout``) and ``beam`` (``beam_rollout_states``' jitted
    ``step_logp`` with the selection and the buffer update around it).

    One ``DeviceProgram`` per key, as JAX's jit keys on the model and the
    shapes: (B, P, gen_len) for ``greedy``, ("beam", beam, P, gen_len)
    for ``beam``, all in one graph pool, on this object's parameters.  A
    key's state (its decoder cache or beam buffer, its output) is made
    with the key and written in place, never rebound; the positions that
    move (the column the next token goes to, the beam prefix's length)
    are 0-dim device tensors advanced in place: a Python int in a piece
    would be baked into its graph.  A pass is one step, so a key's first
    step (with the greedy prefill) is its warm-up and every later step a
    replay; the host reads nothing between steps.

    Keep one object across calls (a tool's batches of one shape) to
    replay a key's graphs in every call; the programs, their pool and the
    parameters go with the object's last reference."""

    def __init__(self, params, cfg: LlamaConfig, captured: bool = True):
        _refuse_quantized(params, "rollout_corpus needs unquantized params")
        self.params, self.cfg = params, cfg
        self.device = params["lm_head"].device
        self.pool = _pool(self.device, captured)
        self.keys: Dict[tuple, SimpleNamespace] = {}

    @torch.no_grad()
    def greedy(self, prompts, gen_len: int) -> torch.Tensor:
        """Greedy continuations: (B, P) prompts -> (B, P + gen_len) int64
        token ids on the parameters' device (a copy of the key's output).
        One prefill, then cached one-token steps (JAX's scan runs one
        more, whose token it drops)."""
        prompts = torch.as_tensor(prompts, device=self.device).to(
            torch.int64)
        if gen_len <= 0:
            return prompts
        k = self._greedy_key(*prompts.shape, gen_len)
        prog = k.program
        with prog.step():
            k.prompts.copy_(prompts)
            prog.run("prefill")
            if gen_len > 1:
                prog.run("step")
        for _ in range(gen_len - 2):
            with prog.step():
                prog.run("step")
        return k.out.clone()

    def _greedy_key(self, B: int, P: int, gen_len: int) -> SimpleNamespace:
        key = (B, P, gen_len)
        if key in self.keys:
            return self.keys[key]
        params, cfg, dev = self.params, self.cfg, self.device
        V = cfg.vocab_size
        i64 = dict(dtype=torch.int64, device=dev)
        st = init_decoder_state(cfg.num_layers, B, P + gen_len + 1,
                                cfg.num_kv_heads, cfg.head_dim,
                                params["lm_head"].dtype, dev)
        prompts = torch.zeros((B, P), **i64)
        out = torch.zeros((B, P + gen_len), **i64)
        col = torch.zeros((), **i64)  # where the next token goes

        def decode(ids):
            """One ``decode_step`` (its valid_len written back in place);
            the argmax at the last position."""
            lg, new = llama_mod.decode_step(params, cfg, st,
                                            llama_mod.embed(params, ids))
            st.valid_len.copy_(new.valid_len)
            return torch.argmax(lg[:, -1, :V], -1)

        def prefill():
            for t in st:
                t.zero_()
            out[:, :P].copy_(prompts)
            out[:, P].copy_(decode(prompts))
            col.fill_(P + 1)

        def step():
            at = col.view(1, 1).expand(B, 1)
            nxt = decode(out.gather(1, at - 1))
            out.scatter_(1, at, nxt[:, None])
            col.add_(1)

        pieces = {"prefill": prefill}
        if gen_len > 1:  # a piece that never runs would run in the warm-up
            pieces["step"] = step
        k = SimpleNamespace(prompts=prompts, state=st, out=out, col=col,
                            program=graphs.DeviceProgram(pieces, self.pool))
        self.keys[key] = k
        return k

    @torch.no_grad()
    def beam(self, prompt, gen_len: int, beam: int = 4) -> list:
        """Beam search from ``prompt`` (P,) recording each step's selection
        state (no EOS, no logits processors): per-step dicts of numpy
        arrays, as JAX's ``beam_rollout_states``.  Each step runs the
        whole (beam, P + gen_len) buffer through the training forward
        (causal: the padded tail never reaches position len - 1).  The
        records are read once, at the end."""
        prompt = torch.as_tensor(prompt, device=self.device).to(torch.int64)
        P = int(prompt.shape[0])
        if gen_len <= 0:
            return []
        k = self._beam_key(beam, P, gen_len)
        k.buf.zero_()
        k.buf[:, :P].copy_(prompt[None].expand(beam, P))
        k.scores.fill_(NEG_INF)
        k.scores[:1].fill_(0.0)
        k.ln.fill_(P)
        for _ in range(gen_len):
            with k.program.step():
                k.program.run("step")
        S = P + gen_len
        rec = np.asarray(graphs.read(k.rec), dtype=np.int64)
        return [{
            "buf": rec[t, :, :S].astype(np.int32),
            "len": P + t,
            "beam_scores": rec[t, :, S + 2].astype(np.int32).view(np.float32),
            "sel_beam": rec[t, :, S].astype(np.int32),
            "sel_tok": rec[t, :, S + 1].astype(np.int32),
        } for t in range(gen_len)]

    def _beam_key(self, B: int, P: int, gen_len: int) -> SimpleNamespace:
        key = ("beam", B, P, gen_len)
        if key in self.keys:
            return self.keys[key]
        params, cfg, dev = self.params, self.cfg, self.device
        V, eps, S = cfg.vocab_size, cfg.rms_norm_eps, P + gen_len
        i64 = dict(dtype=torch.int64, device=dev)
        buf = torch.zeros((B, S), **i64)
        scores = torch.zeros((B,), dtype=torch.float32, device=dev)
        ln = torch.zeros((), **i64)  # the prefix's length
        # a step's record: [buf | sel_beam | sel_tok | beam_scores' bits]
        rec = torch.zeros((gen_len, B, S + 3), **i64)

        def step():
            h = llama_mod.offline_hidden(params, cfg,
                                         llama_mod.embed(params, buf), None)
            h_last = llama_mod._rms_norm(
                h.index_select(1, ln.view(1) - 1)[:, 0], params["final_ln"],
                eps)
            logp = torch.log_softmax(
                (h_last @ params["lm_head"])[:, :V].to(torch.float32), -1)
            total, _vals, cbeam, ctok = select_candidates(logp, scores)
            sel_beam, sel_tok = cbeam[:B], ctok[:B]  # no EOS: the first B
            bits = scores.view(torch.int32).to(torch.int64)
            row = torch.cat([buf, sel_beam[:, None], sel_tok[:, None],
                             bits[:, None]], dim=1)
            rec.index_copy_(0, ln.view(1) - P, row[None])
            nxt = buf.index_select(0, sel_beam)
            nxt.scatter_(1, ln.view(1, 1).expand(B, 1), sel_tok[:, None])
            buf.copy_(nxt)
            scores.copy_(total[sel_beam, sel_tok])
            ln.add_(1)

        k = SimpleNamespace(buf=buf, scores=scores, ln=ln, rec=rec,
                            program=graphs.DeviceProgram({"step": step},
                                                         self.pool))
        self.keys[key] = k
        return k


def rollout_corpus(params, cfg: LlamaConfig, prompts, gen_len: int,
                   captured: bool = True) -> torch.Tensor:
    """Greedy continuations from the TARGET model: (B, P) prompts ->
    (B, P + gen_len) int64 token ids on the parameters' device, the
    distillation corpus that matches the draft's deployment distribution
    (``Rollouts.greedy``; a caller with many batches of one shape keeps
    one ``Rollouts``)."""
    return Rollouts(params, cfg, captured).greedy(prompts, gen_len)


def beam_rollout_states(params, cfg: LlamaConfig, prompt, gen_len: int,
                        beam: int = 4, captured: bool = True) -> list:
    """Beam rollout from the TARGET model recording each step's selection
    state, the corpus of ``beam_selection_distill`` (``Rollouts.beam``).
    Returns per-step dicts of numpy arrays, as JAX's: ``buf`` (B, P +
    gen_len) int32, ``len``, ``beam_scores`` (B,) float32, ``sel_beam`` /
    ``sel_tok`` (B,) int32, the teacher's selection from that state."""
    return Rollouts(params, cfg, captured).beam(prompt, gen_len, beam)


# -- the fits -----------------------------------------------------------------

def _loss(adapter, params, cfg, h_d, teacher, mask):
    lg = draft_logits(params, cfg, adapter, h_d).to(torch.float32)
    t = teacher.to(torch.float32)
    p_t = torch.softmax(t, dim=-1)
    kl = torch.sum(
        p_t * (torch.log_softmax(t, -1) - torch.log_softmax(lg, -1)), -1)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (kl * mask).sum() / denom
    agree = ((torch.argmax(lg, -1) == torch.argmax(t, -1)) * mask).sum() \
        / denom
    return loss, agree


class _Fit:
    """Adam on an adapter as device programs (JAX's jitted ``step_fn``s):
    one ``DeviceProgram`` per shape of the step's inputs, each step one
    piece: ``loss_fn(adapter, *inputs)`` -> (loss, agreement),
    ``autograd.grad`` over the adapter's three leaves, then ``adam``'s
    update in place.  Static: the leaves, the moments, the optimizer's
    device scalars (filled by the host, ``AdamW.prepare``), a key's
    input buffers (a step copies its inputs in, device to device or from
    pinned host memory) and its packed [loss, agreement] (float32),
    which the key's next step overwrites.  The host keeps the count."""

    def __init__(self, adapter: Adapter, lr: float, loss_fn: Callable,
                 pool, device: torch.device):
        self.adapter = adapter
        self.leaves = tree_leaves(adapter)  # ln, w1, w2
        for p in self.leaves:
            p.requires_grad_(True)
        self.opt = adam(lr, len(self.leaves))
        self.state = self.opt.init(self.leaves)
        self.loss_fn, self.pool, self.device = loss_fn, pool, device
        self.keys: Dict[tuple, SimpleNamespace] = {}

    def _key(self, inputs) -> SimpleNamespace:
        key = tuple((tuple(x.shape), x.dtype) for x in inputs)
        if key in self.keys:
            return self.keys[key]
        dev = self.device
        bufs = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                for x in inputs]
        packed = torch.zeros((2,), dtype=torch.float32, device=dev)
        # the piece holds these, not this object: no cycle keeps the
        # graphs alive past the fit's last reference
        adapter, leaves, opt, state = (self.adapter, self.leaves, self.opt,
                                       self.state)
        loss_fn = self.loss_fn

        def step():
            with torch.enable_grad():
                loss, agree = loss_fn(adapter, *bufs)
                grads = list(torch.autograd.grad(loss, leaves))
            opt.apply(leaves, grads, state)
            packed[0].copy_(loss.detach())
            packed[1].copy_(agree)

        k = SimpleNamespace(bufs=bufs, packed=packed,
                            program=graphs.DeviceProgram({"step": step},
                                                         self.pool))
        self.keys[key] = k
        return k

    def step(self, inputs) -> torch.Tensor:
        """One Adam step on ``inputs``; returns the key's packed [loss,
        agreement] (read it through ``graphs.read``)."""
        k = self._key(inputs)
        self.opt.prepare(self.state, self.device)
        with k.program.step():
            for d, s in zip(k.bufs, inputs):
                d.copy_(s, non_blocking=True)
            k.program.run("step")
        self.state = self.opt.advance(self.state)
        return k.packed

    def result(self) -> Adapter:
        return {k: v.detach() for k, v in self.adapter.items()}


class _Spans:
    """Time by span name: CUDA events on a card (read once, at the end),
    the host's clock on the CPU, where the work is synchronous."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: Dict[str, list] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            yield
            b.record()
        else:
            a = time.perf_counter()
            yield
            b = time.perf_counter()
        self.marks.setdefault(name, []).append((a, b))

    def ms(self) -> Dict[str, List[float]]:
        if self.cuda:
            torch.cuda.synchronize()
        return {name: [a.elapsed_time(b) if self.cuda else (b - a) * 1e3
                       for a, b in marks]
                for name, marks in self.marks.items()}


def _run_fit(fit: _Fit, steps: int, log_every: int,
             inputs_at: Callable[[int], tuple],
             spans: Optional[_Spans] = None) -> Tuple[Adapter, list]:
    """``steps`` steps of ``fit`` on ``inputs_at(i)``; history entries
    (step, loss, agreement) every ``log_every`` steps and at the last,
    the only host reads."""
    history = []
    for i in range(steps):
        inputs = inputs_at(i)
        with spans("step") if spans else contextlib.nullcontext():
            packed = fit.step(inputs)
        if log_every and (i % log_every == 0 or i == steps - 1):
            history.append((i, *graphs.read(packed)))
    return fit.result(), history


def _init(cfg, rank, key, dev) -> Adapter:
    key = torch.Generator(device=dev).manual_seed(0) if key is None else key
    return init_exit_adapter(key, cfg, rank, torch.float32, device=dev)


class _TeacherPass:
    """``collect_targets`` as device programs (JAX's jitted
    ``teacher_fn``), one per (B, S): static ids and mask in, static h_d
    and teacher logits out.  A call returns copies of (h_d, teacher,
    mask): the key's next pass overwrites its outputs."""

    def __init__(self, params, cfg: LlamaConfig, d: int, pool):
        self.params, self.cfg, self.d, self.pool = params, cfg, d, pool
        self.keys: Dict[tuple, SimpleNamespace] = {}

    def __call__(self, ids: torch.Tensor, mask: torch.Tensor):
        k = self._key(*ids.shape)
        with k.program.step():
            k.ids.copy_(ids)
            k.mask.copy_(mask)
            k.program.run("teacher")
        return k.h_d.clone(), k.teacher.clone(), k.mask.clone()

    def _key(self, B: int, S: int) -> SimpleNamespace:
        if (B, S) in self.keys:
            return self.keys[(B, S)]
        params, cfg, d = self.params, self.cfg, self.d
        head = params["lm_head"]
        dev = head.device
        ids = torch.zeros((B, S), dtype=torch.int64, device=dev)
        mask = torch.zeros((B, S), dtype=torch.float32, device=dev)
        h_d = torch.empty((B, S, cfg.hidden_size),
                          dtype=params["embed"].dtype, device=dev)
        teacher = torch.empty((B, S, head.shape[-1]), dtype=head.dtype,
                              device=dev)

        def teacher_pass():
            h, t = collect_targets(params, cfg, ids, d, mask)
            h_d.copy_(h)
            teacher.copy_(t)

        k = SimpleNamespace(ids=ids, mask=mask, h_d=h_d, teacher=teacher,
                            program=graphs.DeviceProgram(
                                {"teacher": teacher_pass}, self.pool))
        self.keys[(B, S)] = k
        return k


def distill(
    params,
    cfg: LlamaConfig,
    d: int,
    batches: Iterable,  # (B, S) token ids
    *,
    steps: int,
    lr: float = 1e-3,
    rank: Optional[int] = None,
    key: Optional[torch.Generator] = None,
    pad_id: int = -1,
    log_every: int = 0,
    max_cached_batches: int = 4,
    captured: bool = True,
    timings: Optional[dict] = None,
) -> Tuple[Adapter, list]:
    """Distill an exit adapter at draft depth ``d``: ``batches`` is cycled
    for ``steps`` Adam updates, positions equal to ``pad_id`` masked out
    of the loss.  The teacher features of each batch object are cached
    (one teacher pass each), least recently used first out beyond
    ``max_cached_batches``: an entry holds (B, S, V) float32 teacher
    logits.  ``key`` draws the initial adapter (default: seed 0 on the
    parameters' device).  The teacher passes and the steps are device
    programs in one graph pool (the module note).  ``timings``, a dict,
    receives each teacher pass's and each step's milliseconds under
    "teacher_ms" and "step_ms" (device time on a card).  Returns
    (adapter, history) with history entries (step, kl, top1_agreement)."""
    _refuse_quantized(
        params,
        "distill() needs unquantized (bf16/f32) params: the int8 "
        "activation rounding has zero gradient.  Distill on the "
        "float checkpoint; the adapter then rides the quantized "
        "draft path unchanged.")
    dev = params["lm_head"].device
    pool = _pool(dev, captured)
    fit = _Fit(_init(cfg, rank, key, dev), lr,
               lambda a, *f: _loss(a, params, cfg, *f), pool, dev)
    teacher = _TeacherPass(params, cfg, d, pool)
    spans = _Spans(dev) if timings is not None else None
    cache: OrderedDict = OrderedDict()
    batch_list = list(batches)

    def inputs_at(i):
        ids = batch_list[i % len(batch_list)]
        bid = id(ids)
        if bid in cache:
            cache.move_to_end(bid)
        else:
            ids = torch.as_tensor(ids, device=dev).to(torch.int64)
            mask = (ids != pad_id).to(torch.float32)
            with spans("teacher") if spans else contextlib.nullcontext():
                cache[bid] = teacher(ids, mask)
            while len(cache) > max(1, max_cached_batches):
                cache.popitem(last=False)
        return cache[bid]

    out = _run_fit(fit, steps, log_every, inputs_at, spans)
    if spans is not None:
        timings.update({f"{k}_ms": v for k, v in spans.ms().items()})
    return out


def distill_on_features(
    params,
    cfg: LlamaConfig,
    feats,  # list of (h_d (B,S,D), teacher (B,S,V), mask (B,S)) triples
    *,
    steps: int,
    lr: float = 1e-3,
    rank: Optional[int] = None,
    key: Optional[torch.Generator] = None,
    log_every: int = 0,
    captured: bool = True,
) -> Tuple[Adapter, list]:
    """``distill`` over features collected beforehand (``collect_targets_x``
    over the serving context, ``mask`` restricted to the positions the
    draft is queried at); the draft depth is in ``h_d``.  Returns
    (adapter, history) as ``distill``."""
    dev = params["lm_head"].device
    fit = _Fit(_init(cfg, rank, key, dev), lr,
               lambda a, *f: _loss(a, params, cfg, *f),
               _pool(dev, captured), dev)
    return _run_fit(fit, steps, log_every, lambda i: feats[i % len(feats)])


def beam_selection_distill(
    params,
    cfg: LlamaConfig,
    d: int,
    samples: list,  # beam_rollout_states output (equal-shape steps)
    *,
    steps: int,
    lr: float = 2e-3,
    rank: Optional[int] = None,
    key: Optional[torch.Generator] = None,
    batch: int = 32,
    log_every: int = 0,
    captured: bool = True,
) -> Tuple[Adapter, list]:
    """Listwise selection distillation for the speculative beam draft: the
    cross-entropy of the teacher's selected (beam, token) pairs under the
    softmax over B x V of (beam score + draft log-prob), on batches of
    ``batch`` recorded states drawn by ``np.random.RandomState(0)`` (as
    JAX, so both packages take the same batches; a step's indices are
    its one upload, from pinned memory on a card, and the gathers run in
    its program).  The agreement is the exact whole-selection match, the
    draft's top B by a stable sort, so a tie goes to the lower index as
    in ``lax.top_k``.  Returns (adapter, history) with entries (step, ce,
    selection_agree)."""
    _refuse_quantized(params,
                      "beam_selection_distill needs unquantized params")
    dev = params["lm_head"].device
    i64 = dict(dtype=torch.int64, device=dev)
    bufs = torch.as_tensor(np.stack([s["buf"] for s in samples])).to(**i64)
    lens = torch.tensor([s["len"] for s in samples], **i64)
    scores = torch.as_tensor(
        np.stack([s["beam_scores"] for s in samples])).to(dev)
    selb = torch.as_tensor(np.stack([s["sel_beam"] for s in samples])
                           ).to(**i64)
    selt = torch.as_tensor(np.stack([s["sel_tok"] for s in samples])
                           ).to(**i64)
    N, B, S = bufs.shape
    V = cfg.vocab_size
    eps = cfg.rms_norm_eps
    # the teacher's layer-d hiddens at len - 1 (JAX's jitted ``feats``):
    # run once a call, eagerly, as a capture would replay nothing
    with torch.no_grad():
        x = llama_mod.embed(params, bufs.reshape(N * B, S))
        h = llama_mod.offline_hidden(params, cfg, x, None, num_layers=d)
        h_d = h.reshape(N, B, S, -1)[
            torch.arange(N, device=dev)[:, None],
            torch.arange(B, device=dev)[None], (lens - 1)[:, None]]

    def loss(adapter, sel):
        hh = llama_mod.apply_exit_adapter(adapter, h_d.index_select(0, sel),
                                          eps)
        hh = llama_mod._rms_norm(hh, params["final_ln"], eps)
        logp = torch.log_softmax(
            (hh @ params["lm_head"])[..., :V].to(torch.float32), -1)
        flat = (scores.index_select(0, sel)[..., None] + logp).reshape(
            -1, B * V)
        idx = selb.index_select(0, sel) * V + selt.index_select(0, sel)
        ce = -torch.log_softmax(flat, -1).gather(-1, idx).mean()
        top = torch.sort(flat.detach(), dim=-1, descending=True,
                         stable=True).indices[:, :B]
        match = (torch.sort(top, -1).values
                 == torch.sort(idx, -1).values).all(-1)
        return ce, match.to(torch.float32).mean()

    rng = np.random.RandomState(0)

    def inputs_at(i):
        sel = torch.from_numpy(
            np.sort(rng.choice(N, size=min(batch, N), replace=False)))
        return (sel.pin_memory() if dev.type == "cuda" else sel,)

    fit = _Fit(_init(cfg, rank, key, dev), lr, loss, _pool(dev, captured),
               dev)
    return _run_fit(fit, steps, log_every, inputs_at)


def save_adapter(path: str, adapter: Adapter, d: int) -> None:
    """An ``.npz`` with the draft depth in it (``load_adapter`` checks
    it)."""
    np.savez(
        path,
        **{k: adapter[k].detach().to("cpu", torch.float32).numpy()
           for k in ("ln", "w1", "w2")},
        draft_layers=np.int32(d),
    )


def load_adapter(path: str, expect_d: Optional[int] = None, dtype=None,
                 device="cpu") -> Adapter:
    """Load an adapter ``.npz``; refuse one distilled for another draft
    depth than ``expect_d``."""
    z = np.load(path)
    d = int(z["draft_layers"])
    if expect_d is not None and d != expect_d:
        raise ValueError(
            f"adapter {path} was distilled for draft_layers={d}, but the "
            f"decoder is configured with draft_layers={expect_d}"
        )
    out = {k: torch.as_tensor(np.asarray(z[k]), device=device)
           for k in ("ln", "w1", "w2")}
    if dtype is not None:
        out = {k: v.to(dtype) for k, v in out.items()}
    return out
