"""InfiniSST streaming agent: host-side policy loop driving the chunk step;
port of the plain beam path of ``infinisst_tpu/agents/infinisst.py``.

One chunk step (``_generate_chunk``), in the JAX package's order:
deferred LLM cache eviction -> roll the raw-audio window -> encoder chunk
step + adapter -> splice the speech into the chunk prompt -> one prefill
over [previous chunk's emitted tokens | prompt] -> beam search -> drop the
last token when the cap was hit -> history ring update.

``update_multiplier`` changes the latency multiplier mid-stream, and
``InfiniSSTOptions.quantize`` turns the Llama projections into weight-only
int8 (``quant.quantize_llama_params``, served by ``w8_bf16_gemm``).
Speculative decoding, sampling and the fallback warm are not ported;
asking for them raises ``NotImplementedError``.  The AlignAtt and
StreamAtt agents (``agents/alignatt.py``, ``agents/streamatt.py``)
subclass this one for its model bundle.
"""

from __future__ import annotations

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
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.models import speech_llm
from infinisst_tpu_torch.streaming.state import (
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
    # not ported yet: each raises NotImplementedError when set
    do_sample: bool = False
    speculative: bool = False
    spec_beam: bool = False


_UNPORTED = ("do_sample", "speculative", "spec_beam")


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
        for name in _UNPORTED:
            if getattr(opts, name):
                raise NotImplementedError(
                    f"InfiniSSTOptions.{name} is not ported to PyTorch yet"
                )
        self.device = resolve_device(device)
        if opts.quantize:
            from infinisst_tpu_torch.models.quant import quantize_llama_params

            params = dict(params)
            params["llama"] = quantize_llama_params(params["llama"])
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
        self.enc_state = init_encoder_state(
            w.encoder_layers, 1, self.stream.max_cache_frames,
            w.encoder_attention_heads, w.head_dim, self.dtype, dev,
        )
        self.dec_state = init_decoder_state(
            ll.num_layers, 1, self.stream.llm_cache_capacity,
            ll.num_kv_heads, ll.head_dim, self.dtype, dev,
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
        """One chunk step.  Returns (beam result, n_emit)."""
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
        spec = beam_mod.BeamSpec(
            beam=opts.beam, max_new_tokens=G, eos_id=cfg.tokens.eos,
            pad_id=pad, no_repeat_ngram_size=opts.no_repeat_ngram_size,
            repetition_penalty=opts.repetition_penalty,
        )
        res = beam_mod.beam_search(
            self.params["llama"], cfg.llama, self.dec_state, last_logits,
            prompt_ids, prompt_ids.shape[0],
            torch.as_tensor(self.hist, device=dev), self.hist_len, spec,
            encoder_ngram_size=opts.no_repeat_ngram_size,
            suppress_mask=self._suppress,
        )
        # drop the final token when the cap was hit without EOS
        n_emit = res.n_tokens if res.hit_eos else max(res.n_tokens - 1, 0)
        # new pending = this chunk's emitted tokens, committed next chunk
        pend_out = np.full((P,), pad, np.int64)
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
        res, n_emit = self._generate_chunk(
            prompt, prompt_ids, n_units, chunk_i16, ev_keep, ev_sys
        )
        self.last_result = res  # observability: steps, hit_eos, tokens
        out_ids = [int(t) for t in res.tokens[:n_emit]]
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
