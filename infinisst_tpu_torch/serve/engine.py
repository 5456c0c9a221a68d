"""Batched multi-client streaming engine; port of
``infinisst_tpu/serve/engine.py``.

A fixed pool of stream slots shares one batched step per tick:

- every slot with a full pending chunk is encoded and prefilled in one
  call over all pool rows (a slot that sits the tick out is a row with no
  real frames and an empty prompt);
- decode is batched greedy (beam 1) or batched beam search (beam > 1,
  the device loop of ``decode/beam.py``): per-token forwards run at
  pool * beam rows, so one weight stream serves every slot and beam, and
  the winners are committed by copying their K/V, computed inside the
  beam loop, into the cache;
- or, with ``speculative``, pooled speculative greedy (greedy-exact, beam
  1) or, with ``do_sample`` too, speculative sampling (exact in
  distribution per row; pooled sampling exists only so): one draft stream
  and one verify stream a round for every slot
  (``decode/speculative.py``), the emitted tokens' K/V committed in the
  verify.  The pool-wide acceptance guard drops a greedy pool whose
  tokens per verify round stay below the break-even to the plain
  batched greedy (token-exact), a sampling pool to the d = L self-draft
  (no draft head or adapter), as the JAX engine does.  A sampled tick
  draws from a generator seeded from (``sample_seed``, tick index);
- each slot's cache is trimmed as the single-stream agent trims it, with
  one gather over the whole pool, deferred to the next tick's step.

Latency multipliers are per slot (``multipliers=(1, 2, 4)`` declares the
allowed set): chunk cadence, encoder block, window shift, patch count and
generation cap are per-row inputs of one step at the m_max-padded
geometry.  A slot at m ticks every m x 960 ms and sits the other ticks
out with a zero shift (its window, ring and cache pass through
untouched); ``update_multiplier`` switches a live slot from its next
chunk on.  The language pair is per slot (the prompts are padded to one
width).

As in the JAX engine, the trim decided after a tick is applied at the
start of the next tick's step, on every row (the identity on the rows it
leaves alone).

The tick is JAX's one ``jax.jit`` step with its donated state, as a
device program (``core/graphs.DeviceProgram``): the windows, the encoder
ring and the decoder cache are static buffers allocated once and
written in place, never rebound; the tick's host arrays reach the card
in one copy into static buffers (``_upload``); the pieces follow JAX's
step (``_beam_program``: A the trim, window roll, encoder, splice,
prefill and the beam loop's start, B ``beam_select``, C
``beam_forward``, F the winners' K/V committed by one scatter and the
packed result; ``_greedy_program``: A, S one step of the greedy scan,
D its forward, F; ``_spec_program``, keyed "spec", "spec_sample" and
"spec_sample_self": A, R one whole speculative round of every row, F),
and the host reads the pool-wide ``done`` (beam), "some row can still
emit" (greedy) or "some row is live" (a speculative round) once a step
or round and the packed result once: steps + 1 or rounds + 2 reads a
tick.  The row geometry (frames, patches,
``max_new``) is operands, so one program serves every mix of
multipliers.  On CUDA each piece is captured as a CUDA graph at its
program's first tick; on the CPU the same pieces run uncaptured.  The
prologue writes the state only at its end, so a tick whose encoder or
prefill raises leaves the state and the pending trim as they were, and
the next tick is the one an engine that never saw the failed chunk
would run (the JAX engine, which donates its buffers, cleared the trim
first).  A tick that raises after the prologue's writes (in the beam
loop, its capture, a collective) leaves the state a tick ahead of the
slot table with no copy to go back to: the engine then refuses every
later tick rather than run on a cache the host misreads.  A sampling
tick's program owns a generator, registered with R's graph and reseeded
from (``sample_seed``, tick index) before the tick.

The server pushes audio from its event loop while a tick runs in its
worker thread (which also opens and closes slots), so one lock
serialises ``tick`` and every method that changes a slot (in the JAX
engine a push during a tick could lose the samples it appended, and a
close during a tick had its reset undone when the tick took its state).

``spec_warm_fallback`` is accepted and does nothing: the JAX engine
compiles its fallback step ahead in a thread; here the fallback's
program is captured at its first tick, as every program is.

On a mesh whose 'data' axis is above 1 (built and ticked inside
``parallel.collectives.tensor_parallel(mesh)``), one pool is split over
'data', as the JAX engine's batch sharding splits it: every rank runs
the same host program (the same ``open_stream``, ``push_audio`` and
``tick`` calls, the same slot table), but holds the device state of
its own block of rows, [r B / d, (r + 1) B / d): windows, encoder ring,
decoder cache, and its part of a pending trim.  The decoders take every
loop decision over the whole pool (``collectives.any_over_data``), the
sampler draws the whole pool's numbers and keeps its rows
(``collectives.pool_rand``), and after each step the per-row results
(tokens, counts, the guard's statistics) are gathered over 'data'
before the host reads them, so every rank's slot table stays the same
and the pool-wide guard trips on the tick the one-rank pool's does.
The parameters may be split over 'data' too (FSDP, ``shard_params``
with a ``zero`` spec tree): every forward then gathers them.
"""

from __future__ import annotations

import functools
import sys
import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from infinisst_tpu_torch.core.config import (
    CONV_LEFT_CONTEXT,
    SAMPLES_PER_FRAME,
    ModelConfig,
    StreamConfig,
)
from infinisst_tpu_torch.core import graphs
from infinisst_tpu_torch.core.device import resolve_device
from infinisst_tpu_torch.core.graphs import put as _put
from infinisst_tpu_torch.data.template import PromptBuilder
from infinisst_tpu_torch.decode import beam as beam_mod
from infinisst_tpu_torch.decode import logits as lp
from infinisst_tpu_torch.decode import speculative as spec_mod
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.models import speech_llm
from infinisst_tpu_torch.models import wav2vec2 as w2v2_mod
from infinisst_tpu_torch.parallel import collectives as par
from infinisst_tpu_torch.streaming.state import (
    init_decoder_state,
    init_encoder_state,
)

def _locked(fn):
    @functools.wraps(fn)
    def inner(self, *args, **kw):
        with self._lock:
            return fn(self, *args, **kw)

    return inner


@dataclass
class StreamSlot:
    active: bool = False
    client_id: Optional[str] = None
    lang_pair: tuple = ("English", "German")
    m: int = 1  # latency multiplier (chunk cadence = m x 960 ms)
    pending: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float32)
    )
    first_chunk: bool = True
    finished_input: bool = False
    done: bool = False
    target_ids: List[int] = field(default_factory=list)
    cache_len: int = 0
    cache_checkpoints: List[int] = field(default_factory=list)
    system_prompt_size: int = 0


class ServingEngine:
    def __init__(
        self,
        params,
        cfg: ModelConfig,
        stream_cfg: StreamConfig,
        builders: Dict[tuple, PromptBuilder],  # (src, tgt) -> builder
        pool_size: int = 8,
        multiplier: int = 1,
        max_new_tokens: Optional[int] = None,
        dtype=torch.bfloat16,
        beam: int = 1,
        suppress_tokens=None,  # ids to ban (--suppress-non-language)
        multipliers: Optional[tuple] = None,  # allowed per-slot multipliers
        device="cuda",
        speculative: bool = False,  # pooled speculative greedy (beam 1)
        spec_draft_layers: int = 8,
        spec_k: int = 4,
        spec_accept_all: bool = False,  # bench only: the ceiling
        spec_head_vocab: int = 0,  # a shortlist draft head (0: full)
        spec_head_ids=None,  # its ids (None: the id prefix)
        spec_adapter: Optional[dict] = None,  # an exit adapter, draft only
        spec_lowrank_rank: int = 0,  # low-rank draft head by SVD
        spec_lowrank_head: Optional[dict] = None,  # or given {'a', 'b'}
        do_sample: bool = False,  # pooled speculative sampling
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        epsilon_cutoff: float = 0.0,
        sample_seed: int = 0,
        spec_guard: bool = True,  # the pool-wide acceptance guard
        spec_guard_decay: float = 0.7,
        spec_guard_patience: int = 3,
        spec_guard_margin: float = 1.0,
        spec_warm_fallback: bool = True,  # accepted, nothing to warm
    ):
        self.n_data, self.r_data = par.data_size(), par.data_rank()
        if pool_size % self.n_data:
            raise ValueError(
                f"a pool of {pool_size} rows does not split over "
                f"{self.n_data} 'data' ranks: each rank holds pool_size / "
                "n_data of them, as the JAX engine's batch sharding needs "
                "an even split")
        self._B = pool_size // self.n_data  # the rows this rank holds
        self._rows = slice(self.r_data * self._B,
                           (self.r_data + 1) * self._B)
        if do_sample and not speculative:
            raise ValueError(
                "pooled sampling is implemented as speculative sampling: "
                "pass speculative=True (the rejection scheme makes it "
                "exact in distribution at any draft quality)")
        if do_sample and spec_accept_all:
            raise ValueError("--spec-accept-all is a greedy bench mode; it "
                             "has no sampling counterpart")
        if speculative and beam != 1:
            raise ValueError("speculative serving is greedy-exact; it "
                             "requires beam=1")
        self.device = resolve_device(device)
        if speculative:
            params = spec_mod.with_draft_params(
                params, cfg, dtype, self.device, head_vocab=spec_head_vocab,
                head_ids=spec_head_ids, lowrank_rank=spec_lowrank_rank,
                lowrank_head=spec_lowrank_head, adapter=spec_adapter)
        self._lock = threading.RLock()
        self.params = params
        self.cfg = cfg
        self.stream = stream_cfg
        self.builders = builders
        self.pool = pool_size
        self.m = multiplier  # default multiplier for new slots
        # the default is always allowed: a client that opens without
        # asking for a multiplier gets self.m
        self.multipliers = tuple(
            sorted(set(multipliers or ()) | {multiplier})
        )
        m_max = max(self.multipliers)
        self.m_max = m_max
        self.max_new = max_new_tokens or stream_cfg.max_new_tokens(m_max)
        self.beam = beam
        self.speculative = speculative
        self.spec_draft_layers = spec_draft_layers
        self.spec_k = spec_k
        self.spec_accept_all = spec_accept_all
        self.spec_stats = {"rounds": 0, "drafted": 0, "accepted": 0,
                           "emitted": 0}
        self.spec_guard_decay = spec_guard_decay
        self.spec_guard_patience = spec_guard_patience
        self.spec_guard_margin = spec_guard_margin
        self._spec_breakeven = None
        if speculative and spec_guard and not spec_accept_all:
            self._spec_breakeven = spec_mod.breakeven_tokens_per_round(
                params["llama"], cfg.llama.num_layers, spec_draft_layers,
                spec_k, draft_head=params.get("spec_draft_head"),
                exit_adapter=params.get("spec_adapter"))
        self._spec_tpr_ema = None
        self._spec_below = 0
        self._spec_fallback = False
        self.do_sample = do_sample
        self.sample = dict(temperature=temperature, top_k=top_k,
                           top_p=top_p, epsilon_cutoff=epsilon_cutoff)
        self.sample_seed = sample_seed
        self._tick_counter = 0
        self._step_stats = None  # a speculative step's (rounds, drafted,
        # accepted, emitted)

        # padded per-tick geometry (a row at m < m_max carries fewer real
        # frames; a row sitting the tick out carries none)
        self.chunk_samples = stream_cfg.chunk_samples(m_max)
        self.chunk_frames = stream_cfg.chunk_frames(m_max)
        self.window_samples = CONV_LEFT_CONTEXT + 2 * self.chunk_samples
        V = cfg.llama.vocab_size
        sup = torch.zeros((V,), dtype=torch.bool)
        if suppress_tokens is not None:
            sup[torch.as_tensor(np.asarray(suppress_tokens, np.int64))] = True
        self._suppress = sup.to(self.device) if sup.any() else None

        w, ll, dev = cfg.w2v2, cfg.llama, self.device
        # this rank's rows (all of them on one data rank)
        self.windows = torch.zeros((self._B, self.window_samples),
                                   dtype=torch.float32, device=dev)
        self.valid_len_host = np.zeros((pool_size,), np.int64)
        # the heads this rank holds (a block of them under tensor
        # parallelism)
        self.enc_state = init_encoder_state(
            w.encoder_layers, self._B, stream_cfg.max_cache_frames,
            w2v2_mod.local_heads(self.params["w2v2"], w), w.head_dim,
            dtype, dev,
        )
        self.dec_state = init_decoder_state(
            ll.num_layers, self._B, stream_cfg.llm_cache_capacity,
            llama_mod.local_heads(self.params["llama"]["layers"], ll)[1],
            ll.head_dim, dtype, dev,
        )
        self.slots = [StreamSlot() for _ in range(pool_size)]
        # cumulative count of per-slot cache trims
        self.evictions = 0
        # decoder forwards over the pool: one prefill a tick, then one a
        # generated token (beam_token_step, or a greedy decode_step), or
        # the speculative rounds' draft and verify forwards
        self.forwards = {"prefill": 0, "token": 0, "draft": 0, "verify": 0}
        # deferred batched trim (keep (P,), sys (P,)), applied at the start
        # of the next tick's step
        self._pending_evict = None
        # slots whose chunk prefilled in the most recent tick
        self.last_ticked: tuple = ()
        # True from the moment a tick's prologue has written the pool's
        # state in place until the host's slot table has followed it: a
        # tick that raised in between left the two apart for good
        self._mid_tick = False

        # one prompt width for the pool: the longest first-chunk prompt
        # over languages and allowed multipliers, rounded up to 16
        smax = max(
            len(b.chunk_prompt(mi, first=True).ids)
            for b in builders.values()
            for mi in set(self.multipliers + (multiplier,))
        )
        self._S = int(np.ceil(smax / 16) * 16)
        self._alloc_tick_buffers()
        # the tick's device programs (``_tick_kind``), captured as CUDA
        # graphs on the card at their first tick (``_graphs_on = False``,
        # a private hook for checks: uncaptured on the card)
        self._programs: Dict[str, graphs.DeviceProgram] = {}
        self._graphs_on = self.device.type == "cuda"
        self._graph_pool = None

    # -- slot management -------------------------------------------------
    @_locked
    def open_stream(self, client_id: str, lang_pair=("English", "German"),
                    multiplier: Optional[int] = None):
        m = multiplier or self.m
        if m not in self.multipliers:
            raise ValueError(
                f"multiplier {m} not in the engine's allowed set "
                f"{self.multipliers} (pass multipliers=... at construction)"
            )
        for i, s in enumerate(self.slots):
            if not s.active:
                self.slots[i] = StreamSlot(
                    active=True, client_id=client_id, lang_pair=lang_pair,
                    m=m,
                )
                self._reset_slot_state(i)
                return i
        raise RuntimeError("no free slots")

    @_locked
    def update_multiplier(self, slot: int, m: int):
        """Switch a live slot's latency multiplier mid-stream: cadence,
        patch count and generation cap follow from its next chunk."""
        if m not in self.multipliers:
            raise ValueError((m, self.multipliers))
        self.slots[slot].m = m

    @_locked
    def close_stream(self, slot: int):
        self.slots[slot] = StreamSlot()
        self._reset_slot_state(slot)

    def _reset_slot_state(self, i: int):
        if self._pending_evict is not None:
            # a trim scheduled for this row is stale once the row is
            # zeroed: keep 0 / sys 0 makes it the reset's identity
            pk, ps = self._pending_evict
            pk[i] = 0
            ps[i] = 0
        self.valid_len_host[i] = 0
        if not self._rows.start <= i < self._rows.stop:
            return  # another data rank holds the row
        i -= self._rows.start
        self.windows[i] = 0.0
        for t in (self.enc_state.k, self.enc_state.v, self.dec_state.k,
                  self.dec_state.v):
            t[:, i] = 0
        self.enc_state.n_frames[i] = 0
        self.dec_state.valid_len[i] = 0

    @_locked
    def push_audio(self, slot: int, samples: np.ndarray, finished=False):
        s = self.slots[slot]
        s.pending = np.concatenate([s.pending, samples.astype(np.float32)])
        s.finished_input = s.finished_input or finished

    # -- batched step ------------------------------------------------------
    @property
    def spec_fallback_active(self) -> bool:
        """True once the acceptance guard swapped the pool to its
        plain-cost step."""
        return self._spec_fallback

    # -- the tick as a device program ---------------------------------------
    def _alloc_tick_buffers(self):
        """The static buffers of a tick: one int64 vector for the tick's
        host arrays (this rank's rows; the PCM packed four int16 samples
        to an int64), its pinned staging copy on CUDA, the named views
        the pieces read, and the packed result of the whole pool."""
        B, S, G = self._B, self._S, self.max_new
        Lh = self.stream.no_repeat_ngram_lookback
        cs = self.chunk_samples
        assert cs % 4 == 0, cs
        shapes = dict(ids=(B, S), valid=(B, S), hist=(B, Lh),
                      patch_starts=(B,), row_active=(B,), hist_len=(B,),
                      row_frames=(B,), row_patches=(B,), row_max_new=(B,),
                      ev_keep=(B,), ev_sys=(B,))
        n = sum(int(np.prod(sh)) for sh in shapes.values()) + B * cs // 4
        dev = self.device
        self._up_dev = torch.zeros((n,), dtype=torch.int64, device=dev)
        self._up_host = torch.zeros((n,), dtype=torch.int64,
                                    pin_memory=dev.type == "cuda")
        self._in, self._in_host = {}, {}
        host = self._up_host.numpy()
        off = 0
        for name, sh in shapes.items():
            size = int(np.prod(sh))
            self._in[name] = self._up_dev[off:off + size].view(sh)
            self._in_host[name] = host[off:off + size].reshape(sh)
            off += size
        self._in["chunks"] = self._up_dev[off:].view(torch.int16).view(B, cs)
        self._in_host["chunks"] = host[off:].view(np.int16).reshape(B, cs)
        self._packed = torch.zeros((self.pool, 1 + G), dtype=torch.int32,
                                   device=dev)

    def _upload(self, arrays: Dict[str, np.ndarray]):
        """This rank's rows of the tick's host arrays into the device
        buffers: one copy, without a synchronisation (through the pinned
        staging buffer on CUDA)."""
        rs = self._rows
        for name, a in arrays.items():
            self._in_host[name][...] = a[rs]
        self._up_dev.copy_(self._up_host, non_blocking=True)

    def _prologue(self):
        """The tick up to the decode, JAX's step in order, on this rank's
        rows: the deferred trim on every row (the identity on rows it
        leaves alone: keep = valid_len, sys = 0), the window roll by each
        row's frames, ``encode_chunk`` with ``row_frames``, the splice of
        each row's speech tokens at its patch start and the prefill.  The
        state is written in place only at the end, so a piece that raises
        before then leaves it as it was.  Returns (the last real
        position's logits (B, V), prompt lengths (B,))."""
        cfg, stream, dev = self.cfg, self.stream, self.device
        params, x = self.params, self._in
        B, S = x["ids"].shape
        dec = llama_mod.evict_cache(self.dec_state, x["ev_keep"],
                                    x["ev_sys"])
        # roll each window by its own chunk: row i's row_frames[i] * 320 new
        # samples (left-aligned in its chunk row) slide in, right-aligned; a
        # row with 0 frames keeps its window as it was
        new = x["chunks"].to(torch.float32) / 32768.0
        full = torch.cat([self.windows, new], dim=1)
        idx = (x["row_frames"] * SAMPLES_PER_FRAME)[:, None] + torch.arange(
            self.window_samples, device=dev)[None]
        windows = torch.gather(full, 1, idx)
        speech, enc = speech_llm.encode_chunk(
            params, cfg, self.enc_state, windows, self.chunk_frames,
            stream.max_cache_frames, row_frames=x["row_frames"],
        )
        emb = llama_mod.embed(params["llama"], x["ids"])
        # splice each row's speech (12 * m_slot tokens, left-aligned in
        # speech) over its patch span
        n_sp = speech.shape[1]
        pos = torch.arange(S, device=dev)[None]
        ps = x["patch_starts"][:, None]
        in_patch = (pos >= ps) & (pos < ps + x["row_patches"][:, None])
        rank = torch.clamp(pos - ps, 0, n_sp - 1)
        sp = torch.gather(speech, 1, rank[:, :, None].expand(
            B, S, speech.shape[2]))
        emb = torch.where(in_patch[:, :, None], sp.to(emb.dtype), emb)
        logits, dec = llama_mod.decode_step(
            params["llama"], cfg.llama, dec, emb, valid_mask=x["valid"])
        self.windows.copy_(windows)
        _put(self.enc_state, enc)
        _put(self.dec_state, dec)
        prompt_lens = x["valid"].sum(-1)
        at = torch.clamp(prompt_lens - 1, min=0)[:, None, None]
        last = torch.gather(logits, 1, at.expand(B, 1, logits.shape[-1]))
        return last[:, 0], prompt_lens

    def _pack(self, n: torch.Tensor, toks: torch.Tensor):
        """[n, tokens (G)] int32 a row, gathered over 'data' into
        ``_packed`` (the whole pool's, one host read)."""
        row = torch.cat([n[:, None], toks], dim=1)
        self._packed.copy_(par.gather_rows(row.to(torch.int32)))

    def _beam_program(self) -> graphs.DeviceProgram:
        """The beam tick: pieces A (prologue, the loop's start), B
        (``beam_select``, the pool-wide ``done`` over 'data'), C
        (``beam_forward`` at B * beam rows) and F (the winners' tokens
        and K/V committed, the packed result)."""
        cfg, stream, dev = self.cfg, self.stream, self.device
        G, pad = self.max_new, cfg.tokens.pad
        spec = beam_mod.BeamSpec(
            beam=self.beam, max_new_tokens=G, eos_id=cfg.tokens.eos,
            pad_id=pad, no_repeat_ngram_size=stream.no_repeat_ngram_size,
            repetition_penalty=stream.repetition_penalty,
        )
        dec = self.dec_state
        loop = beam_mod.alloc_loop(spec, cfg.llama, cfg.llama.vocab_size,
                                   self._S, dec.k.shape[3], dec.k.dtype,
                                   dev, pool=self._B, return_kv=True)
        x, ngram = self._in, stream.no_repeat_ngram_size
        me = weakref.proxy(self)  # the engine holds its programs

        def prefill():  # A
            last, prompt_lens = me._prologue()
            beam_mod.start_loop(
                loop, spec, last.to(torch.float32), x["ids"], prompt_lens,
                max_steps=torch.where(x["row_active"] != 0,
                                      x["row_max_new"], 1))

        def select():  # B
            beam_mod.beam_select(loop, spec, x["hist"], x["hist_len"], ngram,
                                 me._suppress, over_data=True)

        def forward():  # C
            beam_mod.beam_forward(loop, me.params["llama"], cfg.llama,
                                  me.dec_state)

        def finish():  # F
            out = beam_mod.beam_finish(loop, spec)
            n_emit = torch.where(out.hit_eos, out.n_tokens,
                                 torch.clamp(out.n_tokens - 1, min=0))
            n_emit = n_emit * (x["row_active"] != 0)
            # commit: the winner's K/V at valid_len, all G slots (the start
            # as dynamic_update_slice takes it: a negative one counts from
            # the end, then clamped so G slots fit); slots past n_emit land
            # past valid_len, where the next append overwrites them
            d = me.dec_state
            L, P, C, KV, Dh = d.k.shape
            vl = d.valid_len
            start = torch.clamp(torch.where(vl < 0, vl + C, vl), 0, C - G)
            at = (torch.arange(P, device=dev)[:, None] * C + start[:, None]
                  + torch.arange(G, device=dev)[None]).reshape(-1)
            for buf, kv in ((d.k, out.kv_k), (d.v, out.kv_v)):
                buf.view(L, P * C, KV, Dh).index_copy_(
                    1, at, kv.reshape(L, P * G, KV, Dh).to(buf.dtype))
            d.valid_len.add_(n_emit)
            toks = torch.where(torch.arange(G, device=dev)[None]
                               < n_emit[:, None], out.tokens, pad)
            me._pack(n_emit, toks)

        prog = graphs.DeviceProgram(
            dict(A=prefill, B=select, C=forward, F=finish), self._pool())
        prog.loop, prog.packed = loop, self._packed
        return prog

    def _greedy_program(self) -> graphs.DeviceProgram:
        """The greedy tick (beam 1, and the speculative greedy pool after
        its guard trips): pieces A (prologue, the scan's carry), S (one
        step of JAX's scan body up to its forward: the processors, the
        argmax, the per-row EOS stop and cap, the append; ``go``: some
        row of the pool emits), D (its ``decode_step``) and F (the packed
        result)."""
        cfg, stream, dev = self.cfg, self.stream, self.device
        B, S, G = self._B, self._S, self.max_new
        pad, eos = cfg.tokens.pad, cfg.tokens.eos
        V = cfg.llama.vocab_size
        i64 = dict(dtype=torch.int64, device=dev)
        seq_buf = torch.zeros((B, S + G), **i64)
        seq_len = torch.zeros((B,), **i64)
        n_tok = torch.zeros((B,), **i64)
        toks = torch.zeros((B, G), **i64)
        nxt = torch.zeros((B,), **i64)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        emit = torch.zeros((B,), dtype=torch.bool, device=dev)
        go = torch.zeros((), dtype=torch.bool, device=dev)
        cur = torch.zeros((B, V), dtype=torch.float32, device=dev)
        x, ngram = self._in, stream.no_repeat_ngram_size
        me = weakref.proxy(self)

        def prefill():  # A
            last, prompt_lens = me._prologue()
            seq_buf[:, :S].copy_(x["ids"])
            seq_buf[:, S:].fill_(pad)
            seq_len.copy_(prompt_lens)
            n_tok.zero_()
            toks.fill_(pad)
            done.zero_()
            cur.copy_(last)

        def select():  # S
            scores = torch.log_softmax(cur, dim=-1)
            scores = lp.process_scores(
                scores, seq_buf, seq_len, stream.repetition_penalty, ngram,
                x["hist"], x["hist_len"], ngram, me._suppress)
            n = torch.argmax(scores, dim=-1)
            is_eos = n == eos
            active = x["row_active"] != 0
            e = ~done & ~is_eos & active & (n_tok < x["row_max_new"])
            done.copy_(done | is_eos | ~active)
            for buf, i in ((toks, n_tok), (seq_buf, seq_len)):
                at = torch.clamp(i, max=buf.shape[1] - 1)[:, None]
                buf.scatter_(1, at, torch.where(e[:, None], n[:, None],
                                                buf.gather(1, at)))
            seq_len.add_(e)
            n_tok.add_(e)
            nxt.copy_(n)
            emit.copy_(e)
            # no row of the pool can emit again (done or capped): the JAX
            # scan's remaining steps append nothing
            go.copy_(par.any_over_data_tensor(torch.any(e)))

        def forward():  # D
            lg, d = llama_mod.decode_step(
                me.params["llama"], cfg.llama, me.dec_state,
                llama_mod.embed(me.params["llama"], nxt[:, None]),
                valid_mask=emit[:, None].to(torch.int64))
            _put(me.dec_state, d)
            cur.copy_(lg[:, 0])

        def finish():  # F
            me._pack(n_tok, toks)

        prog = graphs.DeviceProgram(
            dict(A=prefill, S=select, D=forward, F=finish), self._pool())
        prog.go, prog.packed = go, self._packed
        return prog

    def _pool(self) -> Optional[graphs.GraphPool]:
        """The graph pool of this engine's programs (None: uncaptured)."""
        if not self._graphs_on:
            return None
        if self._graph_pool is None:
            self._graph_pool = graphs.GraphPool(self.device)
        return self._graph_pool

    def _spec_program(self, kind: str) -> graphs.DeviceProgram:
        """The speculative tick: "spec" (greedy), "spec_sample" (the
        rejection sampler) or "spec_sample_self" (the sampling pool after
        its guard trips: the d = L self-draft, no draft head or adapter,
        as JAX's ``_build_step(fallback=True)``).  Pieces A (prologue,
        ``speculative.start_spec`` over the pool's rows), R
        (``spec_round``: one whole round for every row, ``go`` or'ed over
        'data') and F (each row's count, draft counters and tokens
        gathered over 'data', then the stats [rounds, drafted, accepted,
        emitted] of the whole pool, one int32 vector).  The sampler's R
        draws from the program's own generator, registered with R's graph
        and reseeded each tick."""
        cfg, stream, dev = self.cfg, self.stream, self.device
        B, S, G = self._B, self._S, self.max_new
        L = cfg.llama.num_layers
        self_draft = kind == "spec_sample_self"
        d = L if self_draft else self.spec_draft_layers
        common = dict(
            max_new_tokens=G, eos_id=cfg.tokens.eos, pad_id=cfg.tokens.pad,
            draft_layers=d, draft_k=self.spec_k,
            no_repeat_ngram_size=stream.no_repeat_ngram_size,
            repetition_penalty=stream.repetition_penalty)
        gen = None
        if kind == "spec":
            spec = spec_mod.SpecSpec(**common,
                                     accept_all=self.spec_accept_all)
        else:
            spec = spec_mod.SpecSampleSpec(**common, **self.sample)
            gen = torch.Generator(device=dev)
        params = self.params
        draft = spec_mod.draft_of(
            params["llama"], cfg.llama, d,
            None if self_draft else params.get("spec_draft_head"),
            None if self_draft else params.get("spec_adapter"))
        loop = spec_mod.alloc_spec(spec, B, cfg.llama.vocab_size, S, dev)
        packed = torch.zeros((self.pool * (3 + G) + 4,), dtype=torch.int32,
                             device=dev)
        x, ngram = self._in, stream.no_repeat_ngram_size
        me = weakref.proxy(self)

        def prefill():  # A
            last, prompt_lens = me._prologue()
            spec_mod.start_spec(loop, spec, last.to(torch.float32), x["ids"],
                                prompt_lens, x["row_active"] != 0,
                                x["row_max_new"])

        def round_():  # R
            spec_mod.spec_round(loop, spec, me.params["llama"], cfg.llama,
                                me.dec_state, draft, x["hist"],
                                x["hist_len"], gen, ngram, me._suppress)

        def finish():  # F
            rows = par.gather_rows(torch.cat(
                [loop.n_out[:, None], loop.drafted[:, None],
                 loop.accepted[:, None], loop.tokens], dim=1))
            stats = torch.stack([loop.rounds, rows[:, 1].sum(),
                                 rows[:, 2].sum(), rows[:, 0].sum()])
            packed.copy_(torch.cat([rows.reshape(-1), stats]).to(
                torch.int32))

        prog = graphs.DeviceProgram(
            dict(A=prefill, R=round_, F=finish), self._pool(),
            {"R": [gen]} if gen is not None else None)
        prog.loop, prog.packed, prog.generator = loop, packed, gen
        return prog

    def _tick_kind(self) -> str:
        """The program of this tick: "beam" or "greedy" (beam 1, and the
        speculative greedy pool after its guard trips), or a speculative
        one (``_spec_program``)."""
        if not self.speculative:
            return "beam" if self.beam > 1 else "greedy"
        if self.do_sample:
            return "spec_sample_self" if self._spec_fallback \
                else "spec_sample"
        return "greedy" if self._spec_fallback else "spec"

    def _program(self, kind: str) -> graphs.DeviceProgram:
        if kind not in self._programs:
            if kind == "beam":
                prog = self._beam_program()
            elif kind == "greedy":
                prog = self._greedy_program()
            else:
                prog = self._spec_program(kind)
            self._programs[kind] = prog
        return self._programs[kind]

    def _step(self, arrays: Dict[str, np.ndarray], tick_index: int):
        """One tick on the device over this rank's rows of ``arrays`` (the
        whole pool's host arrays); a sampling tick draws from its
        program's generator seeded with ``logits.chunk_seed(sample_seed,
        tick_index)``.  Returns (tokens (P, max_new) np, n (P,) np, token
        forwards), the whole pool's; a speculative step leaves the pool's
        statistics in ``_step_stats``.  The deferred trim is cleared once
        it is applied."""
        kind = self._tick_kind()
        prog = self._program(kind)
        n_fwd = 0
        with prog.step():
            self._upload(arrays)
            if getattr(prog, "generator", None) is not None:
                prog.generator.manual_seed(lp.chunk_seed(self.sample_seed,
                                                         tick_index))
            prog.run("A")
            self._pending_evict = None
            self._mid_tick = True
            if kind == "beam":
                prog.run("B")
                while not beam_mod.read_done(prog.loop):
                    prog.run("C")
                    n_fwd += 1
                    prog.run("B")
            elif kind == "greedy":
                for _ in range(self.max_new):
                    prog.run("S")
                    if not graphs.read(prog.go):
                        break
                    prog.run("D")
                    n_fwd += 1
            else:
                while graphs.read(prog.loop.go):  # one round a read
                    prog.run("R")
            prog.run("F")
            packed = np.asarray(graphs.read(prog.packed), np.int64)
        if kind in ("beam", "greedy"):
            return packed[:, 1:], packed[:, 0], n_fwd
        rows = packed[:-4].reshape(self.pool, 3 + self.max_new)
        self._step_stats = tuple(int(v) for v in packed[-4:])
        return rows[:, 3:], rows[:, 0], 0

    def _guard(self, stats):
        """The speculative statistics of a tick and the pool-wide guard."""
        rounds, drafted, accepted, emitted = stats
        self.forwards["verify"] += rounds
        self.forwards["draft"] += rounds * self.spec_k
        if self._spec_fallback:
            # the sampling pool's d = L self-draft: its machinery
            # statistics describe the self-draft, only the emission counts
            self.spec_stats["emitted"] += emitted
            return
        for key, v in zip(("rounds", "drafted", "accepted", "emitted"),
                          stats):
            self.spec_stats[key] += v
        if self._spec_breakeven is None or rounds <= 0:
            return
        tpr = (accepted + rounds) / rounds
        dc = self.spec_guard_decay
        self._spec_tpr_ema = (tpr if self._spec_tpr_ema is None
                              else dc * self._spec_tpr_ema + (1.0 - dc) * tpr)
        if self._spec_tpr_ema < self._spec_breakeven * self.spec_guard_margin:
            self._spec_below += 1
        else:
            self._spec_below = 0
        if self._spec_below >= self.spec_guard_patience:
            self._spec_fallback = True
            print(f"[spec-guard] pool tokens/round EMA "
                  f"{self._spec_tpr_ema:.2f} < break-even "
                  f"{self._spec_breakeven:.2f} for {self._spec_below} "
                  "ticks: swapping the pool to the plain-cost step",
                  file=sys.stderr, flush=True)

    @_locked
    def tick(self) -> Dict[int, str]:
        """Process one chunk for every slot with enough pending audio.
        Returns {slot: text} for slots that produced output."""
        if par.data_size() != self.n_data:
            raise RuntimeError(
                f"a pool split over {self.n_data} 'data' rank(s) ticked "
                f"inside a context of {par.data_size()}: tick it inside "
                "tensor_parallel(mesh) of the mesh it was built on")
        if self._mid_tick:
            raise RuntimeError(
                "an earlier tick raised after its prologue had written the "
                "pool's state in place (windows, encoder ring, cache, the "
                "trim applied): the slot table no longer describes that "
                "state, so this engine cannot tick again; build a new one")
        ready = []
        for i, s in enumerate(self.slots):
            if not s.active or s.done:
                continue
            cs = self.stream.chunk_samples(s.m)  # per-slot cadence
            if len(s.pending) >= cs or (
                s.finished_input and len(s.pending) > 0
            ):
                ready.append(i)
        if not ready:
            self.last_ticked = ()
            return {}

        B = self.pool
        Lh = self.stream.no_repeat_ngram_lookback
        chunks = np.zeros((B, self.chunk_samples), np.int16)
        patch_starts = np.zeros((B,), np.int64)
        row_active = np.zeros((B,), bool)
        row_frames = np.zeros((B,), np.int64)
        row_patches = np.zeros((B,), np.int64)
        row_max_new = np.ones((B,), np.int64)
        hist = np.full((B, Lh), self.cfg.tokens.pad, np.int64)
        hist_len = np.zeros((B,), np.int64)

        prompts = []
        for i in ready:
            s = self.slots[i]
            cs = self.stream.chunk_samples(s.m)
            seg = s.pending[:cs]
            if len(seg) < cs:
                seg = np.concatenate(
                    [seg, np.zeros(cs - len(seg), np.float32)]
                )
            s.pending = s.pending[cs:]
            # real samples left-aligned in the padded row; the step's
            # per-row window shift right-aligns them
            chunks[i, :cs] = np.clip(
                seg * 32768.0, -32768, 32767
            ).astype(np.int16)
            row_frames[i] = self.stream.chunk_frames(s.m)
            row_patches[i] = self.stream.chunk_speech_tokens(s.m)
            row_max_new[i] = min(self.stream.max_new_tokens(s.m),
                                 self.max_new)
            builder = self.builders[s.lang_pair]
            pr = builder.chunk_prompt(s.m, first=s.first_chunk)
            if s.first_chunk:
                s.system_prompt_size = builder.system_prompt_size(s.m)
            prompts.append((i, pr))
            row_active[i] = True
            tail = s.target_ids[-Lh:]
            hist[i, : len(tail)] = tail
            hist_len[i] = len(tail)

        S = self._S
        ids = np.full((B, S), self.cfg.tokens.pad, np.int64)
        valid = np.zeros((B, S), np.int64)
        for i, pr in prompts:
            ids[i, : len(pr.ids)] = pr.ids
            valid[i, : len(pr.ids)] = 1
            patch_starts[i] = pr.patch_start

        self.last_ticked = tuple(i for i, _ in prompts)
        tick_index = self._tick_counter
        self._tick_counter += 1
        self._step_stats = None
        # the deferred trim, or the identity on every row
        ev_keep, ev_sys = self._pending_evict or (
            self.valid_len_host.copy(), np.zeros_like(self.valid_len_host))
        toks, n_tok, n_fwd = self._step(dict(
            chunks=chunks, ids=ids, valid=valid, patch_starts=patch_starts,
            row_active=row_active, hist=hist, hist_len=hist_len,
            row_frames=row_frames, row_patches=row_patches,
            row_max_new=row_max_new, ev_keep=ev_keep, ev_sys=ev_sys),
            tick_index)
        self.forwards["prefill"] += 1
        self.forwards["token"] += n_fwd
        if self._step_stats is not None:
            self._guard(self._step_stats)

        out: Dict[int, str] = {}
        for i, pr in prompts:
            s = self.slots[i]
            n = int(n_tok[i])
            new_ids = toks[i, :n].tolist()
            s.target_ids.extend(new_ids)
            s.cache_len += len(pr.ids) + n
            self.valid_len_host[i] += len(pr.ids) + n
            s.cache_checkpoints.append(s.cache_len)
            s.first_chunk = False
            if s.finished_input and len(s.pending) == 0:
                s.done = True
            builder = self.builders[s.lang_pair]
            text = builder.tokenizer.decode(
                new_ids, skip_special_tokens=True
            ).strip().replace("�", "")
            if text or s.done:
                out[i] = text
        self._evict_overflowing()
        self._mid_tick = False
        return out

    def _evict_overflowing(self):
        """Trim every overflowing slot's cache with ONE batched gather
        (the single-stream agent's rule per slot), deferred to the next
        tick's step; the host mirrors show the post-trim lengths now."""
        keep_len = self.valid_len_host.copy()
        sys_lens = np.zeros_like(keep_len)
        any_evict = False
        for i, s in enumerate(self.slots):
            if not s.active or s.cache_len <= self.stream.max_llm_cache_tokens:
                continue
            new_len = s.cache_len
            for j, ckpt in enumerate(s.cache_checkpoints):
                new_len = s.cache_len - ckpt
                if new_len <= self.stream.max_llm_cache_tokens:
                    s.cache_checkpoints = s.cache_checkpoints[j + 1 :]
                    trimmed = ckpt
                    if self.stream.always_cache_system_prompt:
                        trimmed -= s.system_prompt_size
                    s.cache_checkpoints = [
                        c - trimmed for c in s.cache_checkpoints
                    ]
                    break
            sys_len = (
                s.system_prompt_size
                if self.stream.always_cache_system_prompt
                else 0
            )
            keep_len[i] = new_len
            sys_lens[i] = sys_len
            s.cache_len = new_len + sys_len
            self.valid_len_host[i] = s.cache_len
            any_evict = True
            self.evictions += 1
        if not any_evict:
            return
        # evict_cache keeps [0:sys] + tail(keep); untouched rows pass sys 0
        # and keep = valid_len (the identity)
        self._pending_evict = (keep_len, sys_lens)

    @_locked
    def flush_pending_evict(self):
        """Apply a deferred cache trim now, so that readers of
        ``dec_state`` see the post-trim cache; a no-op when nothing is
        pending.  The tick path never needs it."""
        if self._pending_evict is None:
            return
        keep, sys_lens = self._pending_evict
        _put(self.dec_state, llama_mod.evict_cache(
            self.dec_state, torch.as_tensor(keep[self._rows]),
            torch.as_tensor(sys_lens[self._rows])))
        self._pending_evict = None
