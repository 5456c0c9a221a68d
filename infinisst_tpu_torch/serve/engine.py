"""Batched multi-client streaming engine; port of
``infinisst_tpu/serve/engine.py``.

A fixed pool of stream slots shares one batched step per tick:

- every slot with a full pending chunk is encoded and prefilled in one
  call over all pool rows (a slot that sits the tick out is a row with no
  real frames and an empty prompt);
- decode is batched greedy (beam 1) or batched beam search (beam > 1,
  ``decode/beam.batched_beam_search``): per-token forwards run at
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
start of the next tick's step.  Here the step works on its own copies of
the state (the cache's in-place writes land past ``valid_len``, where no
one reads) and the engine takes them only once the step has returned, so
a step that raises leaves the state and the pending trim as they were
(the JAX engine cleared the trim before its step ran).

The server calls the slot methods from its event loop while a tick runs
in a worker thread, so one lock serialises ``tick`` and every method that
changes a slot (in the JAX engine a push during a tick could lose the
samples it appended, and a close during a tick had its reset undone when
the tick took its state).

``spec_warm_fallback`` is accepted and does nothing: the JAX engine
compiles its fallback step ahead in a thread, and eager PyTorch has
nothing to compile.
"""

from __future__ import annotations

import functools
import sys
import threading
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
from infinisst_tpu_torch.core.device import resolve_device
from infinisst_tpu_torch.data.template import PromptBuilder
from infinisst_tpu_torch.decode import beam as beam_mod
from infinisst_tpu_torch.decode import logits as lp
from infinisst_tpu_torch.decode import speculative as spec_mod
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.models import speech_llm
from infinisst_tpu_torch.models import wav2vec2 as w2v2_mod
from infinisst_tpu_torch.streaming.state import (
    DecoderState,
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
        from infinisst_tpu_torch.parallel import collectives as par

        if par.data_size() > 1:
            raise ValueError(
                f"a serving pool on a mesh of {par.data_size()} 'data' "
                "ranks: splitting the pool's rows over 'data', as the JAX "
                "engine's batch sharding does, is not ported (ROADMAP §3); "
                "build the engine under tensor_parallel(mesh['model']), one "
                "pool a data rank")
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
        self.windows = torch.zeros((pool_size, self.window_samples),
                                   dtype=torch.float32, device=dev)
        self.valid_len_host = np.zeros((pool_size,), np.int64)
        # the heads this rank holds (a block of them under tensor
        # parallelism)
        self.enc_state = init_encoder_state(
            w.encoder_layers, pool_size, stream_cfg.max_cache_frames,
            w2v2_mod.local_heads(self.params["w2v2"], w), w.head_dim,
            dtype, dev,
        )
        self.dec_state = init_decoder_state(
            ll.num_layers, pool_size, stream_cfg.llm_cache_capacity,
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

        # one prompt width for the pool: the longest first-chunk prompt
        # over languages and allowed multipliers, rounded up to 16
        smax = max(
            len(b.chunk_prompt(mi, first=True).ids)
            for b in builders.values()
            for mi in set(self.multipliers + (multiplier,))
        )
        self._S = int(np.ceil(smax / 16) * 16)

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
        self.windows[i] = 0.0
        self.valid_len_host[i] = 0
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

    def _step(self, chunks, ids, valid, patch_starts, row_active, hist,
              hist_len, row_frames, row_patches, row_max_new, ev,
              generator=None):
        """One tick on the device.  Works on its own copies of the state
        and returns (enc, dec, windows, tokens (P, max_new) np, n (P,) np,
        token forwards) for the caller to take; a speculative step leaves
        its statistics in ``_step_stats``."""
        cfg, stream, dev = self.cfg, self.stream, self.device
        params = self.params
        B, S = ids.shape
        i64 = dict(dtype=torch.int64, device=dev)
        dec = self.dec_state
        if ev is not None:
            # the previous tick's trim (rows it leaves alone pass keep =
            # valid_len, sys = 0: the identity)
            dec = llama_mod.evict_cache(dec, torch.as_tensor(ev[0]),
                                        torch.as_tensor(ev[1]))
        # roll each window by its own chunk: row i's row_frames[i] * 320 new
        # samples (left-aligned in its chunk row) slide in, right-aligned; a
        # row with 0 frames keeps its window as it was
        new = torch.from_numpy(chunks).to(dev).to(torch.float32) / 32768.0
        full = torch.cat([self.windows, new], dim=1)
        shift = torch.as_tensor(row_frames * SAMPLES_PER_FRAME, **i64)
        idx = shift[:, None] + torch.arange(self.window_samples,
                                            device=dev)[None]
        windows = torch.gather(full, 1, idx)
        rf = torch.as_tensor(row_frames, **i64)
        speech, enc = speech_llm.encode_chunk(
            params, cfg, self.enc_state, windows, self.chunk_frames,
            stream.max_cache_frames, row_frames=rf,
        )
        ids_t = torch.as_tensor(ids, **i64)
        emb = llama_mod.embed(params["llama"], ids_t)
        # splice each row's speech (12 * m_slot tokens, left-aligned in
        # speech) over its patch span
        n_sp = speech.shape[1]
        pos = torch.arange(S, device=dev)[None]
        ps = torch.as_tensor(patch_starts, **i64)[:, None]
        in_patch = (pos >= ps) & (pos < ps + torch.as_tensor(
            row_patches, **i64)[:, None])
        rank = torch.clamp(pos - ps, 0, n_sp - 1)
        sp = torch.gather(speech, 1, rank[:, :, None].expand(
            B, S, speech.shape[2]))
        emb = torch.where(in_patch[:, :, None], sp.to(emb.dtype), emb)

        logits, dec = llama_mod.decode_step(
            params["llama"], cfg.llama, dec, emb,
            valid_mask=torch.as_tensor(valid, **i64),
        )
        prompt_lens = valid.sum(-1).astype(np.int64)
        last = logits[torch.arange(B, device=dev),
                      torch.as_tensor(np.maximum(prompt_lens - 1, 0), **i64)]
        hist_t = torch.as_tensor(hist, **i64)
        G, pad = self.max_new, cfg.tokens.pad
        toks = np.full((B, G), pad, np.int64)

        if self.speculative and not (self._spec_fallback
                                     and not self.do_sample):
            return self._spec_step(enc, dec, windows, last, ids_t,
                                   prompt_lens, hist_t, hist_len, row_active,
                                   row_max_new, generator)
        if self.beam > 1:
            spec = beam_mod.BeamSpec(
                beam=self.beam, max_new_tokens=G, eos_id=cfg.tokens.eos,
                pad_id=pad, no_repeat_ngram_size=stream.no_repeat_ngram_size,
                repetition_penalty=stream.repetition_penalty,
            )
            res = beam_mod.batched_beam_search(
                params["llama"], cfg.llama, dec, last, ids_t, prompt_lens,
                hist_t, hist_len, spec,
                encoder_ngram_size=stream.no_repeat_ngram_size,
                suppress_mask=self._suppress,
                max_steps=np.where(row_active, row_max_new, 1),
                return_kv=True,
            )
            n_emit = np.asarray([
                (r.n_tokens if r.hit_eos else max(r.n_tokens - 1, 0)) * int(a)
                for r, a in zip(res, row_active)
            ], np.int64)
            for i, r in enumerate(res):
                toks[i, :n_emit[i]] = r.tokens[:n_emit[i]]
            # commit: copy the winner's K/V at valid_len, all G slots (the
            # start clamped as dynamic_update_slice clamps it); slots past
            # n_emit land past valid_len, where the next append overwrites
            # them
            C = dec.k.shape[2]
            starts = np.minimum(self.valid_len_host + prompt_lens, C - G)
            for i, r in enumerate(res):
                st = int(starts[i])
                dec.k[:, i, st:st + G] = r.kv_k.to(dec.k.dtype)
                dec.v[:, i, st:st + G] = r.kv_v.to(dec.v.dtype)
            dec = DecoderState(k=dec.k, v=dec.v, valid_len=dec.valid_len
                               + torch.as_tensor(n_emit, **i64))
            return (enc, dec, windows, toks, n_emit,
                    max(r.steps for r in res) - 1)

        # batched greedy decode with a per-row EOS stop and cap
        seq_buf = torch.cat([ids_t, torch.full((B, G), pad, **i64)], dim=1)
        seq_len = prompt_lens.copy()
        n_tok = np.zeros((B,), np.int64)
        done = np.zeros((B,), bool)
        hist_len_t = torch.as_tensor(hist_len, **i64)
        cur = last
        n_fwd = 0
        for _ in range(G):
            scores = torch.log_softmax(cur.to(torch.float32), dim=-1)
            scores = lp.process_scores(
                scores, seq_buf, torch.as_tensor(seq_len, **i64),
                stream.repetition_penalty, stream.no_repeat_ngram_size,
                hist_t, hist_len_t, stream.no_repeat_ngram_size,
                self._suppress,
            )
            nxt = torch.argmax(scores, dim=-1)
            nxt_h = nxt.cpu().numpy()
            is_eos = nxt_h == cfg.tokens.eos
            emit = ~done & ~is_eos & row_active & (n_tok < row_max_new)
            done |= is_eos | ~row_active
            if not emit.any():
                # no row can emit again (done or capped): the JAX scan's
                # remaining steps append nothing
                break
            rows = np.nonzero(emit)[0]
            toks[rows, n_tok[rows]] = nxt_h[rows]
            seq_buf[torch.as_tensor(rows, **i64),
                    torch.as_tensor(seq_len[rows], **i64)] = nxt[
                torch.as_tensor(rows, **i64)]
            seq_len += emit
            n_tok += emit
            x = llama_mod.embed(params["llama"], nxt[:, None])
            lg, dec = llama_mod.decode_step(
                params["llama"], cfg.llama, dec, x,
                valid_mask=torch.as_tensor(emit[:, None], **i64),
            )
            n_fwd += 1
            cur = lg[:, 0]
        return enc, dec, windows, toks, n_tok, n_fwd

    def _spec_step(self, enc, dec, windows, last, ids_t, prompt_lens, hist_t,
                   hist_len, row_active, row_max_new, generator):
        """The pooled speculative decode of a tick: greedy, or sampling
        (after a guard trip, the d = L self-draft with no draft head or
        adapter)."""
        cfg, stream = self.cfg, self.stream
        fallback = self._spec_fallback
        params = self.params
        common = dict(
            max_new_tokens=self.max_new, eos_id=cfg.tokens.eos,
            pad_id=cfg.tokens.pad,
            draft_layers=(cfg.llama.num_layers if fallback
                          else self.spec_draft_layers),
            draft_k=self.spec_k,
            no_repeat_ngram_size=stream.no_repeat_ngram_size,
            repetition_penalty=stream.repetition_penalty)
        kw = dict(
            row_active=row_active, row_max_new=row_max_new,
            encoder_ngram_size=stream.no_repeat_ngram_size,
            suppress_mask=self._suppress,
            draft_head=None if fallback else params.get("spec_draft_head"),
            exit_adapter=None if fallback else params.get("spec_adapter"))
        args = (params["llama"], cfg.llama, dec, last, ids_t, prompt_lens,
                hist_t, hist_len)
        if self.do_sample:
            sp = spec_mod.SpecSampleSpec(**common, **self.sample)
            out = spec_mod.batched_speculative_sample(*args, sp, generator,
                                                      **kw)
        else:
            sp = spec_mod.SpecSpec(**common,
                                   accept_all=self.spec_accept_all)
            out = spec_mod.batched_speculative_greedy(*args, sp, **kw)
        toks, n_tok, _, dec, rounds, drafted, accepted = out
        n_tok = n_tok.cpu().numpy()
        self._step_stats = (rounds, int(drafted.sum()), int(accepted.sum()),
                            int(n_tok.sum()))
        return enc, dec, windows, toks.cpu().numpy(), n_tok, 0

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
        gen = None
        if self.do_sample:  # fresh draws a tick, the same per (seed, tick)
            gen = lp.chunk_generator(self.sample_seed, self._tick_counter,
                                     self.device)
        self._tick_counter += 1
        self._step_stats = None
        enc, dec, windows, toks, n_tok, n_fwd = self._step(
            chunks, ids, valid, patch_starts, row_active, hist, hist_len,
            row_frames, row_patches, row_max_new, self._pending_evict, gen,
        )
        # the step returned: take its state, and with it the trim it applied
        self.enc_state, self.dec_state, self.windows = enc, dec, windows
        self._pending_evict = None
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
        self.dec_state = llama_mod.evict_cache(
            self.dec_state, torch.as_tensor(keep), torch.as_tensor(sys_lens)
        )
        self._pending_evict = None
