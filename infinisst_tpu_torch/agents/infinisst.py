"""InfiniSST streaming agent: host-side policy loop driving the chunk step;
port of ``infinisst_tpu/agents/infinisst.py``.

One chunk step (``_generate_chunk``), in the JAX package's order:
deferred LLM cache eviction -> roll the raw-audio window -> encoder chunk
step + adapter -> splice the speech into the chunk prompt -> one prefill
over [previous chunk's emitted tokens | prompt] -> decode -> drop the
last token when the cap was hit -> history ring update.

Every piece of the stream's state lives on the device in static buffers
updated in place (``_init_device_state``): the encoder ring, the LLM
cache, the audio window, the n-gram history ring and the pending tokens,
with their lengths.  The plain beam step is one device program per key
(m, n_units, first, beam), the counterpart of JAX's ``jax.jit`` of
``generate_chunk`` with its donated state (``_generate_chunk_fn``): four
pieces, (A) eviction -> window -> encoder -> splice at the device
``pend_n`` -> prefill -> the beam loop's start, (B) one beam step's
bookkeeping, (C) one ``beam_token_step``, (F) finalize -> pending tokens
-> history ring -> one packed int32 vector.  The host uploads the chunk
and the trim, runs A, then {B, read ``done``, C} until done, then F, and
reads the packed vector: one host read a beam step and one a chunk.  On
CUDA each piece is captured as a CUDA graph at the first chunk of its key
(``core/graphs.py``); on the CPU the same functions run uncaptured.

The decode is beam search, or by the options: ancestral sampling
(``do_sample``), speculative greedy or sampling (``speculative``; the
verify commits the emitted tokens' K/V, so nothing is pending), or
speculative beam search (``spec_beam``, deferred like plain beam).  The
acceptance guard drops a speculative stream whose tokens per verify round
stay below the weight-stream break-even to the true plain decoder of its
mode: beam 1 greedy, plain beam, or the plain sampler.  A sampled chunk
draws from a generator seeded from (``sample_seed``, chunk index).

The plain sampler is a device program too, keyed (m, n_units, first,
"sample") as JAX keys its jitted chunk step: (A) the prologue and the
sampling loop's start, (S) one draw (``beam.sample_select``) from the
program's own generator, registered with S's graph and reseeded each
chunk, (D) its ``beam_token_step`` at beam 1, (F) as above; the host
reads ``go`` once a draw.  So are the speculative decoders, keyed (m,
n_units, first, "spec" / "spec_sample" / "spec_beam"): greedy and
sampling are (A) the prologue and ``speculative.start_spec``, (R) one
whole round (``spec_round``: the draft, the verify, the acceptance, the
commit into the stream's cache; the sampler's draws from the program's
generator, registered with R's graph and reseeded each chunk) and (F)
the cap-dropped token rolled back out of the cache, the epilogue with
nothing pending and the packed [n_emit, n_tokens, hit_eos, tokens,
rounds, drafted, accepted] (``_finish_spec``), with one read of ``go``
a round; speculative beam search is (A), (T) the anchor transition
(``spec_beam.spec_beam_anchor``), (R) the draft, tree verify, replay and
commit (``spec_beam_round``) and (F) the finalize and the deferred
commit, with a read of ``go`` after T and after R (JAX's ``lax.cond``
skips the round's draft and verify when T ends the search).  The guard
reads its statistics from the packed vector.

``update_multiplier`` changes the latency multiplier mid-stream, and
``InfiniSSTOptions.quantize`` turns the Llama projections into weight-only
int8 (``quant.quantize_llama_params``, served by ``w8_bf16_gemm``).  The
AlignAtt and StreamAtt agents (``agents/alignatt.py``,
``agents/streamatt.py``) subclass this one for its model bundle.
"""

from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass
from time import perf_counter
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from infinisst_tpu_torch.agents.base import (
    AgentStates,
    ReadAction,
    SpeechToTextAgent,
    WriteAction,
)
from infinisst_tpu_torch.core.config import (
    CONV_LEFT_CONTEXT,
    ModelConfig,
    StreamConfig,
)
from infinisst_tpu_torch.core import graphs
from infinisst_tpu_torch.core.graphs import put as _put
from infinisst_tpu_torch.core.device import resolve_device
from infinisst_tpu_torch.data.template import PromptBuilder
from infinisst_tpu_torch.decode import beam as beam_mod
from infinisst_tpu_torch.decode import logits as lp
from infinisst_tpu_torch.decode import speculative as spec_mod
from infinisst_tpu_torch.decode import spec_beam as sb_mod
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.models import speech_llm
from infinisst_tpu_torch.models import wav2vec2 as w2v2_mod
from infinisst_tpu_torch.streaming.state import (
    init_decoder_state,
    init_encoder_state,
)


class _Chunk(NamedTuple):
    """The static geometry of one key's chunk step."""

    chunk_samples: int
    chunk_frames: int
    conv_width: int  # the window's trailing samples the conv reads
    prompt: object  # data.template.ChunkPrompt
    prompt_ids: torch.Tensor  # (S,) int64 on the device


@dataclass
class InfiniSSTOptions:
    """Generation / policy options (the release script's defaults)."""

    latency_multiplier: int = 1
    max_latency_multiplier: int = 4
    beam: int = 4
    max_new_tokens_per_mult: int = 10
    no_repeat_ngram_size: int = 5
    no_repeat_ngram_lookback: int = 100
    repetition_penalty: float = 1.2
    max_llm_cache_size: int = 1000
    always_cache_system_prompt: bool = True
    min_start_sec: float = 0.0
    source_lang: str = "English"
    target_lang: str = "German"
    suppress_tokens: Optional[np.ndarray] = None  # ids to ban
    rtf_timing: bool = False  # print per-policy-call wall time
    dpo_sampling: bool = False  # dump per-chunk translations
    output_file: str = "translations.json"
    quantize: bool = False  # weight-only int8 projections
    # sampling decode (the DPO collection path): ancestral sampling
    # through the beam path's processors and the HF filter stack
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    epsilon_cutoff: float = 0.0
    sample_seed: int = 0
    # speculative decode (decode/speculative.py): a draft of the first
    # spec_draft_layers layers and a verify of spec_k + 1 tokens; greedy
    # (beam is ignored) unless spec_beam; exact either way
    speculative: bool = False
    spec_draft_layers: int = 8
    spec_k: int = 4
    spec_accept_all: bool = False  # bench only: the machinery ceiling
    # the draft's head: a shortlist of spec_head_vocab ids (the id prefix,
    # or spec_head_ids), or low-rank factors (built by SVD at init with
    # spec_lowrank_rank, or given as spec_lowrank_head {'a', 'b'})
    spec_head_vocab: int = 0
    spec_head_ids: Optional[np.ndarray] = None
    spec_lowrank_rank: int = 0
    spec_lowrank_head: Optional[dict] = None
    # a distilled exit adapter {'ln', 'w1', 'w2'} (train/draft.py), draft
    # only
    spec_adapter: Optional[dict] = None
    # speculative beam search (decode/spec_beam.py): needs speculative and
    # beam > 1; deferred commit like plain beam
    spec_beam: bool = False
    # the acceptance guard: an EMA of tokens per verify round below the
    # break-even (x margin) for patience chunks drops the stream to its
    # plain decoder for good; off under spec_accept_all
    spec_guard: bool = True
    spec_guard_decay: float = 0.7
    spec_guard_patience: int = 3
    spec_guard_margin: float = 1.0
    # accepted and ignored: the JAX agent compiles its fallback graph
    # ahead in a thread; eager PyTorch has nothing to compile, so the
    # fallback swap costs nothing here
    spec_warm_fallback: bool = True


class InfiniSSTAgent(SpeechToTextAgent):
    def __init__(
        self,
        params,
        model_cfg: ModelConfig,
        stream_cfg: StreamConfig,
        builder: PromptBuilder,
        opts: InfiniSSTOptions,
        param_dtype=torch.float32,
        device="cuda",
    ):
        self.device = resolve_device(device)
        dev = self.device
        if opts.quantize:
            from infinisst_tpu_torch.models.quant import quantize_llama_params
            from infinisst_tpu_torch.parallel import collectives as par

            if par.model_size() > 1:
                raise ValueError(
                    "quantize under tensor parallelism: the int8 layouts "
                    "are not split over 'model' (ROADMAP §3)")

            params = dict(params)
            params["llama"] = quantize_llama_params(params["llama"])
        if opts.speculative:
            params = spec_mod.with_draft_params(
                params, model_cfg, param_dtype, dev,
                head_vocab=opts.spec_head_vocab, head_ids=opts.spec_head_ids,
                lowrank_rank=opts.spec_lowrank_rank,
                lowrank_head=opts.spec_lowrank_head,
                adapter=opts.spec_adapter,
            )
        if opts.spec_beam and opts.speculative:
            if opts.do_sample:
                raise ValueError("spec_beam is beam-search-exact; it cannot "
                                 "be combined with --do-sample")
            if opts.beam <= 1:
                raise ValueError("spec_beam requires beam > 1")
        if opts.speculative and opts.do_sample and opts.spec_accept_all:
            raise ValueError("--spec-accept-all is a greedy bench mode; it "
                             "has no sampling counterpart")
        # the guard's break-even (tokens a verify round must emit)
        self._spec_breakeven = None
        if opts.speculative and opts.spec_guard and not opts.spec_accept_all:
            self._spec_breakeven = spec_mod.breakeven_tokens_per_round(
                params["llama"], model_cfg.llama.num_layers,
                opts.spec_draft_layers, opts.spec_k,
                draft_head=params.get("spec_draft_head"),
                exit_adapter=params.get("spec_adapter"),
            )
        self.params = params
        self.cfg = model_cfg
        self.stream = stream_cfg
        self.builder = builder
        self.opts = opts
        self.dtype = param_dtype
        self.tokenizer = builder.tokenizer
        self.unit_samples = stream_cfg.chunk_samples(1)  # 960 ms unit
        # sized for the max multiplier, as the JAX agent sizes it
        self.window_samples = CONV_LEFT_CONTEXT + 2 * stream_cfg.chunk_samples(
            opts.max_latency_multiplier
        )
        self._set_multiplier_geometry(opts.latency_multiplier)
        V = model_cfg.llama.vocab_size
        sup = torch.zeros((V,), dtype=torch.bool)
        if opts.suppress_tokens is not None:
            sup[torch.as_tensor(np.asarray(opts.suppress_tokens, np.int64))] = True
        self._suppress = sup.to(self.device)
        self._prompts: Dict = {}
        # the chunk programs by key, and on CUDA their graphs' memory pool
        # (a private hook: ``_graphs_on = False`` runs the same programs
        # uncaptured on the card, for checks)
        self._programs: Dict = {}
        self._graph_pool = None
        self._graphs_on = self.device.type == "cuda"
        self.enc_state = None
        super().__init__()
        self._init_device_state()

    def _set_multiplier_geometry(self, m: int):
        self.opts.latency_multiplier = m
        self.chunk_samples = self.stream.chunk_samples(m)
        self.chunk_frames = self.stream.chunk_frames(m)
        self.max_new = self.stream.max_new_tokens(m)

    def update_multiplier(self, multiplier: int):
        """Change the latency multiplier mid-stream.  The device state is
        sized for the largest multiplier, so only the chunk geometry and
        the prompts follow the new one."""
        if not 1 <= multiplier <= self.opts.max_latency_multiplier:
            raise ValueError(
                f"latency multiplier {multiplier} is outside 1.."
                f"{self.opts.max_latency_multiplier}"
            )
        self._set_multiplier_geometry(multiplier)

    # -- state -------------------------------------------------------------
    def _init_device_state(self):
        """The stream's device state, made once and zeroed in place on a
        reset (the chunk programs' graphs hold its addresses)."""
        w, ll, dev = self.cfg.w2v2, self.cfg.llama, self.device
        pad = self.cfg.tokens.pad
        Lh = self.opts.no_repeat_ngram_lookback
        self.pend_cap = self.stream.max_new_tokens(
            self.opts.max_latency_multiplier
        )
        if self.enc_state is not None:
            for t in (*self.enc_state, *self.dec_state, self.window,
                      self.hist_len, self.pend_n, self._chunk_dev,
                      self._ev_dev):
                t.zero_()
            self.hist.fill_(pad)
            self.pend_tokens.fill_(pad)
        else:
            # the heads this rank holds (a block of them under tensor
            # parallelism; a policy-only agent has no parameters)
            p = self.params
            enc_heads, kv_heads = w.encoder_attention_heads, ll.num_kv_heads
            if p is not None:
                enc_heads = w2v2_mod.local_heads(p["w2v2"], w)
                kv_heads = llama_mod.local_heads(p["llama"]["layers"], ll)[1]
            self.enc_state = init_encoder_state(
                w.encoder_layers, 1, self.stream.max_cache_frames, enc_heads,
                w.head_dim, self.dtype, dev,
            )
            self.dec_state = init_decoder_state(
                ll.num_layers, 1, self.stream.llm_cache_capacity, kv_heads,
                ll.head_dim, self.dtype, dev,
            )
            self.window = torch.zeros((1, self.window_samples),
                                      dtype=torch.float32, device=dev)
            i64 = dict(dtype=torch.int64, device=dev)
            # n-gram history ring and deferred-commit pending tokens (the
            # previous chunk's emitted tokens, folded into the next
            # prefill), with their lengths
            self.hist = torch.full((Lh,), pad, **i64)
            self.hist_len = torch.zeros((), **i64)
            self.pend_tokens = torch.full((self.pend_cap,), pad, **i64)
            self.pend_n = torch.zeros((), **i64)
            # the chunk's 16-bit PCM and the trim (keep, sys) the host
            # uploads (from pinned staging buffers on CUDA)
            n = self.stream.chunk_samples(self.opts.max_latency_multiplier)
            self._chunk_dev = torch.zeros((n,), dtype=torch.int16,
                                          device=dev)
            self._ev_dev = torch.zeros((2,), **i64)
            if dev.type == "cuda":
                self._chunk_host = torch.zeros((n,), dtype=torch.int16,
                                               pin_memory=True)
                self._ev_host = torch.zeros((2,), dtype=torch.int64,
                                            pin_memory=True)
        self.cache_checkpoints = []  # token counts at chunk ends
        self.llm_cache_len = 0  # logical: physical + pending
        self.pend_n_host = 0
        self.evictions = 0
        # deferred eviction (keep_physical, sys_len), applied at the start
        # of the next chunk step
        self._pending_evict = None
        self.system_prompt_size = 0
        self.first_chunk = True
        self._chunk_counter = 0  # the sampling draws' chunk index
        # cumulative speculative statistics
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        # the acceptance guard: the EMA of tokens per verify round, the
        # chunks in a row below the break-even, the sticky fallback
        self._spec_tpr_ema = None
        self._spec_below = 0
        self._spec_fallback = False

    @property
    def spec_fallback_active(self) -> bool:
        """True once the acceptance guard dropped this stream to its plain
        decoder."""
        return self._spec_fallback

    def reset(self):
        super().reset()
        self._init_device_state()

    def flush_pending_evict(self):
        """Apply a deferred cache trim now (normally the next chunk step
        applies it); for inspecting ``dec_state`` between chunks."""
        if self._pending_evict is None:
            return
        keep, sys_len = self._pending_evict
        self._pending_evict = None
        _put(self.dec_state, llama_mod.evict_cache(
            self.dec_state, torch.tensor([keep], device=self.device), sys_len
        ))

    def build_states(self):
        return AgentStates()

    # -- chunk step ----------------------------------------------------------
    def _prompt(self, n_units: int, first: bool):
        key = (self.opts.latency_multiplier, n_units, first)
        if key not in self._prompts:
            m = self.opts.latency_multiplier
            prompt = self.builder.chunk_prompt(m, first, n_patches=12 * n_units)
            ids = torch.as_tensor(prompt.ids.astype(np.int64), device=self.device)
            self._prompts[key] = (prompt, ids)
        return self._prompts[key]

    def _geometry(self, n_units: int, first: bool) -> _Chunk:
        prompt, prompt_ids = self._prompt(n_units, first)
        cs = n_units * self.unit_samples
        # the conv reads the left context, the previous chunk and this
        # one; a short tail reads one full-m chunk of history instead
        prev = self.chunk_samples if n_units != self.opts.latency_multiplier \
            else cs
        return _Chunk(cs, 48 * n_units, CONV_LEFT_CONTEXT + prev + cs, prompt,
                      prompt_ids)

    def _upload(self, chunk_i16: np.ndarray, ev_keep: int, ev_sys: int):
        """The chunk's PCM and the trim into their device buffers, without
        a synchronisation (through pinned buffers on CUDA)."""
        src = torch.from_numpy(chunk_i16)
        ev = torch.tensor([ev_keep, ev_sys], dtype=torch.int64)
        n = src.shape[0]
        if self.device.type == "cuda":
            self._chunk_host[:n].copy_(src)
            self._ev_host.copy_(ev)
            src, ev = self._chunk_host[:n], self._ev_host
        self._chunk_dev[:n].copy_(src, non_blocking=True)
        self._ev_dev.copy_(ev, non_blocking=True)

    def _prologue(self, c: _Chunk) -> torch.Tensor:
        """The chunk step up to the decode, on the device state in place:
        the deferred trim (the identity with none pending: keep = the
        valid length, sys = 0), the window roll, the encoder and adapter,
        the splice at the device ``pend_n`` and one prefill over [pending
        tokens | prompt].  Returns the last real position's logits (V,)."""
        cfg, dev = self.cfg, self.device
        ev = self._ev_dev
        _put(self.dec_state, llama_mod.evict_cache(self.dec_state, ev[:1],
                                                   ev[1]))
        new = self._chunk_dev[:c.chunk_samples].to(torch.float32)[None]
        new = new / 32768.0
        self.window.copy_(torch.cat(
            [self.window[:, c.chunk_samples:], new], dim=1))
        speech, enc = speech_llm.encode_chunk(
            self.params, cfg, self.enc_state,
            self.window[:, -c.conv_width:], c.chunk_frames,
            self.stream.max_cache_frames,
        )
        _put(self.enc_state, enc)
        prompt_emb = speech_llm.splice_speech(
            self.params, c.prompt_ids[None], speech, c.prompt.patch_start
        )  # (1, S, D)
        S, D = prompt_emb.shape[1], prompt_emb.shape[2]
        P = self.pend_cap
        buf = torch.zeros((1, P + S, D), dtype=prompt_emb.dtype, device=dev)
        buf[:, :P] = llama_mod.embed(self.params["llama"],
                                     self.pend_tokens[None])
        ar = torch.arange(P + S, device=dev)
        buf[0].index_copy_(0, self.pend_n + ar[:S], prompt_emb[0])
        valid = (ar[None] < self.pend_n + S).to(torch.int64)
        logits, dec = llama_mod.decode_step(
            self.params["llama"], cfg.llama, self.dec_state, buf,
            valid_mask=valid,
        )
        _put(self.dec_state, dec)
        return logits[0].index_select(0, (self.pend_n + S - 1).reshape(1))[0]

    def _epilogue(self, tokens: torch.Tensor, n_emit: torch.Tensor,
                  pending: bool):
        """After the decode, in place: the new pending tokens (this
        chunk's ``n_emit`` emitted ones, committed by the next prefill;
        none when ``pending`` is False: the speculative verify committed
        them) and the history ring (append at hist_len, keep the trailing
        Lh window).  tokens (G,) int64, n_emit () int64."""
        dev, pad = self.device, self.cfg.tokens.pad
        P, Lh, G = self.pend_cap, self.hist.shape[0], tokens.shape[0]
        if pending:
            out = torch.full((P,), pad, dtype=torch.int64, device=dev)
            out[:G] = tokens
            keep = torch.arange(P, device=dev) < n_emit
            self.pend_tokens.copy_(torch.where(keep, out, pad))
            self.pend_n.copy_(n_emit)
        else:
            self.pend_tokens.fill_(pad)
            self.pend_n.zero_()
        ar_g = torch.arange(G, device=dev)
        ar_h = torch.arange(Lh, device=dev)
        cat = torch.cat([self.hist, torch.full((G,), pad, dtype=torch.int64,
                                               device=dev)])
        cat.index_copy_(0, self.hist_len + ar_g, tokens)
        new_len = torch.clamp(self.hist_len + n_emit, max=Lh)
        start = self.hist_len + n_emit - new_len
        new_hist = cat.index_select(0, start + ar_h)
        self.hist.copy_(torch.where(ar_h < new_len, new_hist, pad))
        self.hist_len.copy_(new_len)

    def _chunk_kind(self):
        """The decode of this chunk's device program, the last element of
        its key: the beam of the plain beam step, "sample" for the plain
        sampler, "spec", "spec_sample" or "spec_beam" for the speculative
        decoders (JAX's non-fallback key).  The speculative guard's
        fallback is plain beam search at beam 1 (at the options' beam for
        speculative beam search), or the plain sampler under sampling."""
        opts = self.opts
        if opts.speculative and not self._spec_fallback:
            if opts.spec_beam:
                return "spec_beam"
            return "spec_sample" if opts.do_sample else "spec"
        if opts.do_sample:
            return "sample"
        greedy_fallback = self._spec_fallback and not opts.spec_beam
        return 1 if greedy_fallback else opts.beam

    def _generate_chunk_fn(self, n_units: int, first: bool
                           ) -> graphs.DeviceProgram:
        """The chunk step of a chunk of ``n_units`` 960 ms units (n_units
        == m except for the stream tail) as one device program, made once
        per key (m, n_units, first, kind): pieces A, B, C and F of the
        plain beam step (see the module note), A, S, D and F of the
        sampler (``_sample_pieces``), A, R and F of speculative greedy or
        sampling (``_spec_pieces``), or A, T, R and F of speculative beam
        search (``_spec_beam_pieces``), captured as CUDA graphs on the
        card."""
        m, kind = self.opts.latency_multiplier, self._chunk_kind()
        key = (m, n_units, first, kind)
        if key in self._programs:
            return self._programs[key]
        c = self._geometry(n_units, first)
        G = self.max_new
        # [n_emit, pack_result] or [n_emit, pack_spec (+ steps, score)]
        size = {"spec": 6 + G, "spec_sample": 6 + G,
                "spec_beam": 8 + G}.get(kind, 5 + 2 * G)
        packed = torch.zeros((size,), dtype=torch.int32, device=self.device)
        # the pieces hold the agent weakly: the agent holds its programs,
        # and a cycle would keep the weights alive past the agent
        me = weakref.proxy(self)
        if kind == "sample":
            pieces, gens, loop = self._sample_pieces(me, c, packed)
        elif kind in ("spec", "spec_sample"):
            pieces, gens, loop = self._spec_pieces(me, c, packed, kind)
        elif kind == "spec_beam":
            pieces, gens, loop = self._spec_beam_pieces(me, c, packed)
        else:
            pieces, gens, loop = self._beam_pieces(me, c, packed, kind)
        prog = graphs.DeviceProgram(pieces, self._pool(), gens)
        prog.loop, prog.packed, prog.kind = loop, packed, kind
        prog.generator = next(iter(gens.values()))[0] if gens else None
        self._programs[key] = prog
        return prog

    def _pool(self) -> Optional[graphs.GraphPool]:
        """The graph pool of this agent's programs (None: uncaptured)."""
        if not self._graphs_on:
            return None
        if self._graph_pool is None:
            self._graph_pool = graphs.GraphPool(self.device)
        return self._graph_pool

    def _beam_pieces(self, me, c: _Chunk, packed: torch.Tensor, beam: int):
        """The plain beam step's pieces A, B, C and F, its loop."""
        cfg, opts, dev = self.cfg, self.opts, self.device
        spec = beam_mod.BeamSpec(
            beam=beam, max_new_tokens=self.max_new, eos_id=cfg.tokens.eos,
            pad_id=cfg.tokens.pad, no_repeat_ngram_size=opts.no_repeat_ngram_size,
            repetition_penalty=opts.repetition_penalty)
        Tp = c.prompt_ids.shape[0]
        loop = beam_mod.alloc_loop(spec, cfg.llama, cfg.llama.vocab_size, Tp,
                                   self.dec_state.k.shape[3], self.dtype,
                                   dev)

        def prefill():  # A
            beam_mod.start_loop(loop, spec, me._prologue(c)[None],
                                c.prompt_ids[None], Tp)

        def select():  # B
            beam_mod.beam_select(loop, spec, me.hist[None],
                                 me.hist_len.reshape(1),
                                 opts.no_repeat_ngram_size, me._suppress)

        def forward():  # C
            beam_mod.beam_forward(loop, me.params["llama"], cfg.llama,
                                  me.dec_state)

        def finish():  # F
            me._finish(beam_mod.beam_finish(loop, spec), packed)

        return dict(A=prefill, B=select, C=forward, F=finish), None, loop

    def _sample_pieces(self, me, c: _Chunk, packed: torch.Tensor):
        """The plain sampler's pieces: A (prologue, the loop's start), S
        (``beam.sample_select``: the processed scores, one draw, the EOS
        stop and the cap, the append, ``go``), D (``beam.sample_forward``:
        ``beam_token_step`` at beam 1 over the stream's cache) and F;
        its loop.  S draws from the program's own generator (registered
        with S's graph), which the chunk reseeds with
        ``logits.chunk_seed(sample_seed, chunk index)``."""
        cfg, opts, dev = self.cfg, self.opts, self.device
        spec = beam_mod.SampleSpec(
            max_new_tokens=self.max_new, eos_id=cfg.tokens.eos,
            pad_id=cfg.tokens.pad, temperature=opts.temperature,
            top_p=opts.top_p, top_k=opts.top_k,
            epsilon_cutoff=opts.epsilon_cutoff,
            no_repeat_ngram_size=opts.no_repeat_ngram_size,
            repetition_penalty=opts.repetition_penalty)
        Tp = c.prompt_ids.shape[0]
        loop = beam_mod.alloc_sample_loop(
            spec, cfg.llama, cfg.llama.vocab_size, Tp,
            self.dec_state.k.shape[3], self.dtype, dev)
        gen = torch.Generator(device=dev)

        def prefill():  # A
            beam_mod.start_sample(loop, spec, me._prologue(c), c.prompt_ids,
                                  Tp)

        def select():  # S
            beam_mod.sample_select(loop, spec, me.hist[None],
                                   me.hist_len.reshape(1), gen,
                                   opts.no_repeat_ngram_size, me._suppress)

        def forward():  # D
            beam_mod.sample_forward(loop, me.params["llama"], cfg.llama,
                                    me.dec_state)

        def finish():  # F
            me._finish(beam_mod.sample_out(loop), packed)

        return (dict(A=prefill, S=select, D=forward, F=finish), {"S": [gen]},
                loop)

    def _spec_pieces(self, me, c: _Chunk, packed: torch.Tensor,
                     kind: str):
        """Speculative greedy ("spec") or sampling ("spec_sample"): A
        (prologue, ``speculative.start_spec``), R (``spec_round``: one
        whole round, the draft, the verify, the acceptance and the
        commit into the stream's cache) and F (``_finish_spec``); its
        loop.  The sampler's R draws from the program's own generator
        (registered with R's graph), reseeded each chunk with
        ``logits.chunk_seed(sample_seed, chunk index)``."""
        cfg, opts, dev = self.cfg, self.opts, self.device
        G, pad, eos = self.max_new, cfg.tokens.pad, cfg.tokens.eos
        ngram, rep = opts.no_repeat_ngram_size, opts.repetition_penalty
        common = dict(max_new_tokens=G, eos_id=eos, pad_id=pad,
                      draft_layers=opts.spec_draft_layers,
                      draft_k=opts.spec_k, no_repeat_ngram_size=ngram,
                      repetition_penalty=rep)
        if kind == "spec_sample":
            spec = spec_mod.SpecSampleSpec(
                **common, temperature=opts.temperature, top_k=opts.top_k,
                top_p=opts.top_p, epsilon_cutoff=opts.epsilon_cutoff)
            gen = torch.Generator(device=dev)
        else:
            spec = spec_mod.SpecSpec(**common,
                                     accept_all=opts.spec_accept_all)
            gen = None
        Tp = c.prompt_ids.shape[0]
        V = cfg.llama.vocab_size
        loop = spec_mod.alloc_spec(spec, 1, V, Tp, dev)
        draft = self._draft()

        def prefill():  # A
            spec_mod.start_spec(loop, spec, me._prologue(c)[None],
                                c.prompt_ids[None], Tp)

        def round_():  # R
            spec_mod.spec_round(loop, spec, me.params["llama"], cfg.llama,
                                me.dec_state, draft, me.hist[None],
                                me.hist_len.reshape(1), gen, ngram,
                                me._suppress)

        def finish():  # F
            me._finish_spec(spec_mod.pack_spec(
                loop.tokens[0], loop.n_out[0], loop.hit_eos[0], loop.rounds,
                loop.drafted[0], loop.accepted[0]), packed)

        gens = {"R": [gen]} if gen is not None else None
        return dict(A=prefill, R=round_, F=finish), gens, loop

    def _spec_beam_pieces(self, me, c: _Chunk, packed: torch.Tensor):
        """Speculative beam search: A (prologue, ``start_spec_beam``), T
        (``spec_beam_anchor``: the anchor transition T0), R
        (``spec_beam_round``: the draft, the tree verify, the replay and
        the commit into the loop's buffers) and F (the finalize, the
        deferred commit as plain beam's); its loop."""
        cfg, opts, dev = self.cfg, self.opts, self.device
        spec = beam_mod.BeamSpec(
            beam=opts.beam, max_new_tokens=self.max_new,
            eos_id=cfg.tokens.eos, pad_id=cfg.tokens.pad,
            no_repeat_ngram_size=opts.no_repeat_ngram_size,
            repetition_penalty=opts.repetition_penalty)
        Tp = c.prompt_ids.shape[0]
        loop = sb_mod.alloc_spec_beam(
            spec, cfg.llama, opts.spec_k, cfg.llama.vocab_size, Tp,
            self.dec_state.k.shape[3], self.dtype, dev)
        draft = self._draft()
        ngram = opts.no_repeat_ngram_size

        def ctx():
            return (me.hist[None], me.hist_len.reshape(1), ngram,
                    me._suppress)

        def prefill():  # A
            sb_mod.start_spec_beam(loop, spec, me._prologue(c),
                                   c.prompt_ids, Tp)

        def anchor():  # T
            sb_mod.spec_beam_anchor(loop, spec, *ctx())

        def round_():  # R
            sb_mod.spec_beam_round(loop, spec, me.params["llama"],
                                   cfg.llama, me.dec_state, draft, *ctx(),
                                   accept_all=opts.spec_accept_all)

        def finish():  # F
            me._finish_spec(sb_mod.spec_beam_finish(loop, spec), packed,
                            pending=True)

        return dict(A=prefill, T=anchor, R=round_, F=finish), None, loop

    def _draft(self) -> spec_mod.Draft:
        """The speculative draft: the first ``spec_draft_layers`` layers
        with the draft head and the exit adapter."""
        p = self.params
        return spec_mod.draft_of(p["llama"], self.cfg.llama,
                                 self.opts.spec_draft_layers,
                                 p.get("spec_draft_head"),
                                 p.get("spec_adapter"))

    def _finish_spec(self, result: torch.Tensor, packed: torch.Tensor,
                     pending: bool = False):
        """Piece F of a speculative program, from its decode's
        ``pack_spec`` vector: the final token dropped when the cap was hit
        without EOS; greedy and sampling (``pending`` False) roll the
        verify-committed cap-dropped token back out of the cache (it must
        not condition later chunks) and leave nothing pending, speculative
        beam defers its commit as plain beam does; the epilogue and the
        packed [n_emit, ``result``] vector."""
        G = self.max_new
        n_tokens, hit_eos = result[0].to(torch.int64), result[1] != 0
        n_emit = torch.where(hit_eos, n_tokens,
                             torch.clamp(n_tokens - 1, min=0))
        if not pending:
            self.dec_state.valid_len.sub_(n_tokens - n_emit)
        self._epilogue(result[2:2 + G].to(torch.int64), n_emit,
                       pending=pending)
        packed.copy_(torch.cat([n_emit.to(torch.int32).reshape(1), result]))

    def _finish(self, res: beam_mod.BeamOut, packed: torch.Tensor):
        """Piece F: the final token dropped when the cap was hit without
        EOS, the epilogue (pending tokens, history ring) and the packed
        [n_emit, ``pack_result``] vector."""
        n_tokens, hit_eos = res.n_tokens[0], res.hit_eos[0]
        n_emit = torch.where(hit_eos, n_tokens,
                             torch.clamp(n_tokens - 1, min=0))
        self._epilogue(res.tokens[0], n_emit, pending=True)
        packed.copy_(torch.cat([n_emit.to(torch.int32).reshape(1),
                                beam_mod.pack_result(res)[0]]))

    def _generate_chunk(self, n_units: int, first: bool,
                        chunk_i16: np.ndarray, ev_keep: int, ev_sys: int):
        """One chunk step.  Returns (the decode's result, n_emit).  The
        deferred trim is cleared only once it is applied: a step that
        fails before then keeps it for the next one."""
        prog = self._generate_chunk_fn(n_units, first)
        kind, loop = prog.kind, prog.loop
        with prog.step():
            self._upload(chunk_i16, ev_keep, ev_sys)
            if prog.generator is not None:
                prog.generator.manual_seed(lp.chunk_seed(
                    self.opts.sample_seed, self._chunk_counter))
            prog.run("A")
            self._pending_evict = None
            if kind == "sample":
                for _ in range(self.max_new):
                    prog.run("S")
                    if not graphs.read(loop.go):
                        break
                    prog.run("D")
            elif kind in ("spec", "spec_sample"):
                while graphs.read(loop.go):  # one round a read
                    prog.run("R")
            elif kind == "spec_beam":
                # T ends the search, or R after it: JAX's lax.cond
                while True:
                    prog.run("T")
                    if not graphs.read(loop.go):
                        break
                    prog.run("R")
                    if not graphs.read(loop.go):
                        break
            else:
                prog.run("B")
                while not beam_mod.read_done(loop):
                    prog.run("C")
                    prog.run("B")
            prog.run("F")
            packed = graphs.read(prog.packed)
        G = self.max_new
        if kind in ("spec", "spec_sample"):
            return spec_mod.unpack_spec(packed, G, 1), packed[0]
        if kind == "spec_beam":
            return sb_mod.unpack_spec_beam(packed, G, 1), packed[0]
        return beam_mod.unpack_result(packed, G, 1), packed[0]

    def _guard(self, res, n_emit: int):
        """After a speculative chunk: the statistics, and the acceptance
        guard's EMA of tokens per verify round against the break-even."""
        opts = self.opts
        r, ac = res.rounds, res.accepted
        self.spec_rounds += r
        self.spec_drafted += res.drafted
        self.spec_accepted += ac
        self.spec_emitted += n_emit  # what the user saw
        if self._spec_breakeven is None or r <= 0:
            return
        tpr = (ac + r) / r  # the accepted prefix and the anchor
        dc = opts.spec_guard_decay
        self._spec_tpr_ema = (tpr if self._spec_tpr_ema is None
                              else dc * self._spec_tpr_ema + (1.0 - dc) * tpr)
        if self._spec_tpr_ema < self._spec_breakeven * opts.spec_guard_margin:
            self._spec_below += 1
        else:
            self._spec_below = 0
        if self._spec_below >= opts.spec_guard_patience:
            self._spec_fallback = True
            print(f"[spec-guard] tokens/round EMA {self._spec_tpr_ema:.2f} "
                  f"< break-even {self._spec_breakeven:.2f} for "
                  f"{self._spec_below} chunks: dropping this stream to "
                  "plain decode", file=sys.stderr, flush=True)

    # -- policy ------------------------------------------------------------
    def policy(self, states: Optional[AgentStates] = None):
        if states is None:
            states = self.states
        opts = self.opts
        if states.source_sample_rate == 0:
            length_in_seconds = 0.0
        else:
            length_in_seconds = len(states.source) / states.source_sample_rate
        if not states.source_finished and length_in_seconds < opts.min_start_sec:
            return ReadAction()
        if states.source_finished and length_in_seconds < 0.32:
            return WriteAction(content="", finished=True)

        t0 = perf_counter()
        if len(states.source) > self.stream.max_src_samples:
            drop = len(states.source) - self.stream.max_src_samples
            states.src_len -= drop
            states.source = states.source[-self.stream.max_src_samples :]

        new = np.asarray(states.source[states.src_len :], np.float32)
        if new.size == 0 and not states.source_finished:
            return ReadAction()

        translation_parts = []
        # full chunks; the stream tail is padded to 960 ms units
        pos = 0
        while True:
            remaining = new.size - pos
            if remaining >= self.chunk_samples:
                seg = new[pos : pos + self.chunk_samples]
                n_units = self.opts.latency_multiplier
                pos += self.chunk_samples
            elif states.source_finished and remaining > 0:
                n_units = int(np.ceil(remaining / self.unit_samples))
                seg = np.zeros((n_units * self.unit_samples,), np.float32)
                seg[:remaining] = new[pos:]
                pos += remaining
            else:
                break
            text = self._process_chunk(states, seg, n_units)
            if text:
                translation_parts.append(text)
        states.src_len += pos

        translation = " ".join(translation_parts).strip().replace("�", "")
        if opts.rtf_timing:
            print(f"generate: {perf_counter() - t0:.4f} seconds")
        if opts.dpo_sampling:
            states.translations_list.append(
                f"'{translation}'" if translation else "''"
            )
            if states.source_finished:
                try:
                    with open(opts.output_file, "a", encoding="utf-8") as f:
                        f.write(
                            "[" + ", ".join(states.translations_list) + "]\n"
                        )
                    states.translations_list = []
                except OSError as e:
                    print(f"Error writing translations to file: {e}")
        states.segment_idx += 1
        if translation != "" or states.source_finished:
            return WriteAction(content=translation,
                               finished=states.source_finished)
        return ReadAction()

    def _process_chunk(self, states: AgentStates, seg: np.ndarray,
                       n_units: int) -> str:
        opts = self.opts
        m = opts.latency_multiplier
        first = self.first_chunk
        if first:
            self.system_prompt_size = self.builder.system_prompt_size(m)
        prompt, _ = self._prompt(n_units, first)
        # 16-bit PCM, as the JAX agent uploads it
        chunk_i16 = np.clip(seg * 32768.0, -32768, 32767).astype(np.int16)
        if self._pending_evict is not None:
            ev_keep, ev_sys = self._pending_evict  # cleared once applied
        else:
            ev_keep = self.llm_cache_len - self.pend_n_host
            ev_sys = 0
        # the decode this chunk runs (the guard trips only after it)
        spec_path = opts.speculative and not self._spec_fallback
        res, n_emit = self._generate_chunk(n_units, first, chunk_i16,
                                           ev_keep, ev_sys)
        self._chunk_counter += 1
        self.last_result = res  # observability: steps, hit_eos, tokens
        out_ids = [int(t) for t in res.tokens[:n_emit]]
        if spec_path:
            # greedy and sampling speculation committed in the verify;
            # spec beam defers like plain beam
            self.pend_n_host = n_emit if opts.spec_beam else 0
            self._guard(res, n_emit)
        else:
            self.pend_n_host = n_emit
        self.first_chunk = False
        states.target_ids.extend(out_ids)

        # cache bookkeeping (logical = physical + pending)
        self.llm_cache_len += prompt.ids.shape[0] + n_emit
        self.cache_checkpoints.append(self.llm_cache_len)
        if self.llm_cache_len > opts.max_llm_cache_size:
            new_len = self.llm_cache_len
            for i, ckpt in enumerate(self.cache_checkpoints):
                new_len = self.llm_cache_len - ckpt
                if new_len <= opts.max_llm_cache_size:
                    self.cache_checkpoints = self.cache_checkpoints[i + 1 :]
                    trimmed = ckpt
                    if opts.always_cache_system_prompt:
                        trimmed -= self.system_prompt_size
                    self.cache_checkpoints = [
                        c - trimmed for c in self.cache_checkpoints
                    ]
                    break
            sys_len = (
                self.system_prompt_size if opts.always_cache_system_prompt
                else 0
            )
            # deferred: applied at the start of the next chunk step
            self._pending_evict = (new_len - self.pend_n_host, sys_len)
            self.evictions += 1
            self.llm_cache_len = new_len + sys_len

        text = self.tokenizer.decode(out_ids, skip_special_tokens=True).strip()
        return text.replace("�", "")
