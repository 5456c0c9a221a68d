"""InfiniSST streaming agent: host-side policy loop driving the chunk step;
port of ``infinisst_tpu/agents/infinisst.py``.

One chunk step (``_generate_chunk``), in the JAX package's order:
deferred LLM cache eviction -> roll the raw-audio window -> encoder chunk
step + adapter -> splice the speech into the chunk prompt -> one prefill
over [previous chunk's emitted tokens | prompt] -> decode -> drop the
last token when the cap was hit -> history ring update.

The decode is beam search, or by the options (``_decode``): ancestral
sampling (``do_sample``), speculative greedy or sampling
(``speculative``; the verify commits the emitted tokens' K/V, so nothing
is pending), or speculative beam search (``spec_beam``, deferred like
plain beam).  The acceptance guard drops a speculative stream whose
tokens per verify round stay below the weight-stream break-even to the
true plain decoder of its mode: beam 1 greedy, plain beam, or the plain
sampler.  A sampled chunk draws from a generator seeded from
(``sample_seed``, chunk index).

``update_multiplier`` changes the latency multiplier mid-stream, and
``InfiniSSTOptions.quantize`` turns the Llama projections into weight-only
int8 (``quant.quantize_llama_params``, served by ``w8_bf16_gemm``).  The
AlignAtt and StreamAtt agents (``agents/alignatt.py``,
``agents/streamatt.py``) subclass this one for its model bundle.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from time import perf_counter
from typing import Dict, Optional

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
from infinisst_tpu_torch.core.device import resolve_device
from infinisst_tpu_torch.data.template import PromptBuilder
from infinisst_tpu_torch.decode import beam as beam_mod
from infinisst_tpu_torch.decode import logits as lp
from infinisst_tpu_torch.decode import speculative as spec_mod
from infinisst_tpu_torch.decode.spec_beam import spec_beam_search
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.models import speech_llm
from infinisst_tpu_torch.models import wav2vec2 as w2v2_mod
from infinisst_tpu_torch.streaming.state import (
    DecoderState,
    init_decoder_state,
    init_encoder_state,
)


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
        w, ll, dev = self.cfg.w2v2, self.cfg.llama, self.device
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
        pad = self.cfg.tokens.pad
        Lh = self.opts.no_repeat_ngram_lookback
        # n-gram history ring and deferred-commit pending tokens (the
        # previous chunk's emitted tokens, folded into the next prefill)
        self.hist = np.full((Lh,), pad, np.int64)
        self.hist_len = 0
        self.pend_cap = self.stream.max_new_tokens(
            self.opts.max_latency_multiplier
        )
        self.pend_tokens = np.full((self.pend_cap,), pad, np.int64)
        self.pend_n = 0
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
        self.dec_state = llama_mod.evict_cache(
            self.dec_state, torch.tensor([keep], device=self.device), sys_len
        )

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

    def _generate_chunk(self, prompt, prompt_ids, n_units: int,
                        chunk_i16: np.ndarray, ev_keep: int, ev_sys: int):
        """One chunk step.  Returns (the decode's result, n_emit)."""
        cfg, stream, opts, dev = self.cfg, self.stream, self.opts, self.device
        pad = cfg.tokens.pad
        chunk_samples = n_units * self.unit_samples
        chunk_frames = 48 * n_units
        is_tail = n_units != opts.latency_multiplier
        P = self.pend_cap
        G = self.max_new
        Lh = opts.no_repeat_ngram_lookback

        # deferred eviction: the previous chunk's trim.  With no trim
        # pending (keep = valid_len, sys = 0) the gather is the identity,
        # so it is skipped.  The trim is cleared only once it is applied:
        # a step that fails before this point keeps it for the next one.
        if ev_sys != 0 or ev_keep != int(self.dec_state.valid_len[0]):
            self.dec_state = llama_mod.evict_cache(
                self.dec_state, torch.tensor([ev_keep], device=dev), ev_sys
            )
        self._pending_evict = None
        # roll the device window
        new = torch.as_tensor(chunk_i16, device=dev).to(torch.float32)[None]
        new = new / 32768.0
        self.window = torch.cat([self.window[:, chunk_samples:], new], dim=1)
        if not is_tail:
            conv_in = self.window[:, -(CONV_LEFT_CONTEXT + 2 * chunk_samples):]
        else:
            conv_in = self.window[
                :, -(CONV_LEFT_CONTEXT + self.chunk_samples + chunk_samples):
            ]
        speech, self.enc_state = speech_llm.encode_chunk(
            self.params, cfg, self.enc_state, conv_in,
            chunk_frames, stream.max_cache_frames,
        )
        prompt_emb = speech_llm.splice_speech(
            self.params, prompt_ids[None], speech, prompt.patch_start
        )  # (1, S, D)
        S, D = prompt_emb.shape[1], prompt_emb.shape[2]
        pend = torch.as_tensor(self.pend_tokens, device=dev)
        buf = torch.zeros((1, P + S, D), dtype=prompt_emb.dtype, device=dev)
        buf[:, :P] = llama_mod.embed(self.params["llama"], pend[None])
        buf[:, self.pend_n : self.pend_n + S] = prompt_emb
        valid = (torch.arange(P + S, device=dev)[None]
                 < self.pend_n + S).to(torch.int64)
        logits, self.dec_state = llama_mod.decode_step(
            self.params["llama"], cfg.llama, self.dec_state, buf,
            valid_mask=valid,
        )
        last_logits = logits[0, self.pend_n + S - 1]
        res = self._decode(last_logits, prompt_ids)
        # drop the final token when the cap was hit without EOS
        n_emit = res.n_tokens if res.hit_eos else max(res.n_tokens - 1, 0)
        pend_out = np.full((P,), pad, np.int64)
        if isinstance(res, spec_mod.SpecResult):
            # the verify committed the tokens' K/V: roll back to the
            # emitted prefix (a cap-dropped token must not condition later
            # chunks), nothing pending
            self.dec_state = DecoderState(
                k=res.dec.k, v=res.dec.v,
                valid_len=res.dec.valid_len - (res.n_tokens - n_emit))
            self.pend_tokens, self.pend_n = pend_out, 0
        else:
            # new pending = this chunk's emitted tokens, committed next
            # chunk
            pend_out[:n_emit] = res.tokens[:n_emit]
            self.pend_tokens, self.pend_n = pend_out, n_emit
        # history ring: append at hist_len, keep the trailing Lh window
        cat = np.concatenate([self.hist, np.full((G,), pad, np.int64)])
        cat[self.hist_len : self.hist_len + G] = res.tokens
        new_len = min(self.hist_len + n_emit, Lh)
        start = self.hist_len + n_emit - new_len
        new_hist = cat[start : start + Lh].copy()
        new_hist[new_len:] = pad
        self.hist, self.hist_len = new_hist, new_len
        return res, n_emit

    def _decode(self, last_logits, prompt_ids):
        """The chunk's decode by the options: speculative beam, greedy or
        sampling, plain sampling, or beam search.  Once the guard has
        tripped, the plain decoder of the mode: beam search at beam 1 for
        speculative greedy, at the options' beam for speculative beam,
        the plain sampler for speculative sampling."""
        opts, cfg, dev = self.opts, self.cfg, self.device
        fallback = self._spec_fallback
        speculative = opts.speculative and not fallback
        G, pad, eos = self.max_new, cfg.tokens.pad, cfg.tokens.eos
        args = (self.params["llama"], cfg.llama, self.dec_state, last_logits,
                prompt_ids, prompt_ids.shape[0],
                torch.as_tensor(self.hist, device=dev), self.hist_len)
        kw = dict(encoder_ngram_size=opts.no_repeat_ngram_size,
                  suppress_mask=self._suppress)
        draft = dict(draft_head=self.params.get("spec_draft_head"),
                     exit_adapter=self.params.get("spec_adapter"))
        gen = None
        if opts.do_sample:
            gen = lp.chunk_generator(opts.sample_seed, self._chunk_counter,
                                     dev)
        ngram, rep = opts.no_repeat_ngram_size, opts.repetition_penalty
        filters = dict(temperature=opts.temperature, top_k=opts.top_k,
                       top_p=opts.top_p, epsilon_cutoff=opts.epsilon_cutoff,
                       no_repeat_ngram_size=ngram, repetition_penalty=rep)
        if speculative and opts.spec_beam:
            spec = beam_mod.BeamSpec(
                beam=opts.beam, max_new_tokens=G, eos_id=eos, pad_id=pad,
                no_repeat_ngram_size=ngram, repetition_penalty=rep)
            return spec_beam_search(
                *args, spec, draft_layers=opts.spec_draft_layers,
                draft_k=opts.spec_k, accept_all=opts.spec_accept_all,
                **kw, **draft)
        if speculative and opts.do_sample:
            spec = spec_mod.SpecSampleSpec(
                max_new_tokens=G, eos_id=eos, pad_id=pad,
                draft_layers=opts.spec_draft_layers, draft_k=opts.spec_k,
                **filters)
            return spec_mod.speculative_sample(*args, spec, gen, **kw,
                                               **draft)
        if speculative:
            spec = spec_mod.SpecSpec(
                max_new_tokens=G, eos_id=eos, pad_id=pad,
                draft_layers=opts.spec_draft_layers, draft_k=opts.spec_k,
                no_repeat_ngram_size=ngram, repetition_penalty=rep,
                accept_all=opts.spec_accept_all)
            return spec_mod.speculative_greedy(*args, spec, **kw, **draft)
        if opts.do_sample:
            spec = beam_mod.SampleSpec(max_new_tokens=G, eos_id=eos,
                                       pad_id=pad, **filters)
            return beam_mod.sample_decode(*args, spec, gen, **kw)
        greedy_fallback = fallback and not opts.spec_beam
        spec = beam_mod.BeamSpec(
            beam=1 if greedy_fallback else opts.beam, max_new_tokens=G,
            eos_id=eos, pad_id=pad, no_repeat_ngram_size=ngram,
            repetition_penalty=rep)
        return beam_mod.beam_search(*args, spec, **kw)

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
        prompt, prompt_ids = self._prompt(n_units, first)
        # 16-bit PCM, as the JAX agent uploads it
        chunk_i16 = np.clip(seg * 32768.0, -32768, 32767).astype(np.int16)
        if self._pending_evict is not None:
            ev_keep, ev_sys = self._pending_evict  # cleared once applied
        else:
            ev_keep = self.llm_cache_len - self.pend_n_host
            ev_sys = 0
        # the decode this chunk runs (the guard trips only after it)
        spec_path = opts.speculative and not self._spec_fallback
        res, n_emit = self._generate_chunk(
            prompt, prompt_ids, n_units, chunk_i16, ev_keep, ev_sys
        )
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
