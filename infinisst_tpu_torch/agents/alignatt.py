"""AlignAtt agent: attention-guided streaming policy over an offline model;
port of ``infinisst_tpu/agents/alignatt.py``.

Every policy call re-encodes the audio so far (its last
``max_audio_chunks`` x 960 ms, zero-padded up to a multiple of
``length_bucket_chunks`` units) with the encoder made bidirectional
(``block_frames = max_cache_frames = 10**7``), builds the single-turn
offline prompt with the target so far as the assistant's prefix (its
last ``max_prompt_target_tokens`` ids, padded up to a multiple of 64),
prefills it on a fresh cache and beam-decodes while probing the
head-averaged attention of layer ``attn_layer`` over the speech span.
Emission stops at the first token whose most-attended speech token lies
in the last ``frame_num`` tokens of the real (unpadded) speech, with a
word-boundary trim for targets other than Chinese.

The probe reads the prompt's own speech span in the prefill too; the JAX
agent's prefill probe reads an empty cache block and returns 0 (ROADMAP
§3), so its first token's index and its history trace differ from this
agent's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from infinisst_tpu_torch.agents.base import AgentStates, ReadAction, WriteAction
from infinisst_tpu_torch.agents.infinisst import InfiniSSTAgent, InfiniSSTOptions
from infinisst_tpu_torch.core.config import CONV_LEFT_CONTEXT
from infinisst_tpu_torch.decode import beam as beam_mod
from infinisst_tpu_torch.models import adapter as adapter_mod
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.models import wav2vec2 as w2v2_mod
from infinisst_tpu_torch.streaming.state import init_decoder_state

SAMPLES_PER_SPEECH_TOKEN = 1280  # 80 ms
PROMPT_BUCKET = 64  # prompt lengths are padded to a multiple of this


@dataclass
class AlignAttOptions(InfiniSSTOptions):
    frame_num: int = 1
    attn_layer: int = 14
    min_start_sec: float = 0.32
    max_len_a: int = 5  # tokens per second cap
    max_len_b: int = 20
    length_bucket_chunks: int = 4  # audio length bucketing (960 ms units)
    decode_buf_tokens: int = 64  # the beam's generation buffer per call
    # the audio is capped to the last max_audio_chunks x 960 ms and the
    # target prefix to the last max_prompt_target_tokens ids
    max_audio_chunks: int = 30  # 28.8 s
    max_prompt_target_tokens: int = 256
    # end the beam loop once every live beam has an in-zone token instead
    # of generating to the length cap (the winner is then chosen among the
    # early-stopped beams); off for the reference's semantics
    attn_early_stop: bool = False


class AlignAttStates(AgentStates):
    def __init__(self):
        super().__init__()
        self.most_attended_indices: list = []

    def reset(self):
        super().reset()
        self.most_attended_indices = []


class AlignAttAgent(InfiniSSTAgent):
    """Offline-model attention policy on InfiniSSTAgent's model bundle; its
    streaming caches are unused (every call recomputes)."""

    _uses_eviction = False

    def build_states(self):
        return AlignAttStates()

    # -- offline generate ----------------------------------------------------
    def _offline_generate(self, audio, ids, plen: int, n_units: int,
                          max_steps: int, stop_idx: int):
        """Encoder -> adapter -> splice at the speech patches -> prefill on
        a fresh cache of pbucket + G slots -> probed beam search.  audio
        (1, CONV_LEFT_CONTEXT + n_units * 15360) float32; ids (1, pbucket)
        padded.  Returns (beam result, the prefill's (pbucket,) probes)."""
        cfg, opts, dev = self.cfg, self.opts, self.device
        n_speech = 12 * n_units
        G = opts.decode_buf_tokens
        pbucket = ids.shape[1]
        spec = beam_mod.BeamSpec(
            beam=opts.beam, max_new_tokens=G, eos_id=cfg.tokens.eos,
            pad_id=cfg.tokens.pad,
            no_repeat_ngram_size=opts.no_repeat_ngram_size,
            repetition_penalty=opts.repetition_penalty,
        )
        patch_start = self.builder.offline_prompt(n_speech, []).patch_start
        probe = (opts.attn_layer, patch_start, patch_start + n_speech)
        frames = w2v2_mod.forward(
            self.params["w2v2"], cfg.w2v2, audio,
            block_frames=10**7, max_cache_frames=10**7,
        )
        speech = adapter_mod.forward(self.params["adapter"], cfg.adapter,
                                     frames)
        emb = llama_mod.embed(self.params["llama"], ids)
        start = min(patch_start, pbucket - speech.shape[1])
        emb[:, start:start + speech.shape[1]] = speech.to(emb.dtype)
        ll = cfg.llama
        dec = init_decoder_state(ll.num_layers, 1, pbucket + G,
                                 ll.num_kv_heads, ll.head_dim, emb.dtype, dev)
        valid = (torch.arange(pbucket, device=dev)[None] < plen).to(
            torch.int64)
        logits, dec, probes = llama_mod.decode_step(
            self.params["llama"], ll, dec, emb, valid_mask=valid,
            attn_probe=probe,
        )
        probes = probes[0].tolist()
        res = beam_mod.beam_search(
            self.params["llama"], ll, dec, logits[0, plen - 1], ids[0], plen,
            torch.zeros((1,), dtype=torch.int64, device=dev), 0, spec,
            encoder_ngram_size=0, suppress_mask=self._suppress,
            max_steps=max_steps, attn_probe=probe,
            first_attn_idx=probes[plen - 1],
            attn_stop_idx=stop_idx if opts.attn_early_stop else None,
        )
        return res, probes

    # -- policy ----------------------------------------------------------------
    def policy(self, states: Optional[AlignAttStates] = None):
        if states is None:
            states = self.states
        opts: AlignAttOptions = self.opts

        if states.source_sample_rate == 0:
            length_in_seconds = 0.0
        else:
            length_in_seconds = len(states.source) / states.source_sample_rate
        if not states.source_finished and length_in_seconds < opts.min_start_sec:
            return ReadAction()
        if states.source_finished and length_in_seconds < 0.32:
            return WriteAction(content="", finished=True)

        # the audio in 960 ms units, zero-padded up to the bucket; only the
        # last max_audio_chunks units
        src_full = np.asarray(states.source, np.float32)
        unit = self.unit_samples
        tail_start = max(0, len(src_full) - opts.max_audio_chunks * unit)
        src = src_full[tail_start:]
        n_units = int(np.ceil(len(src) / unit))
        bucket = opts.length_bucket_chunks
        n_units = min(int(np.ceil(n_units / bucket) * bucket),
                      opts.max_audio_chunks)
        audio = np.zeros(CONV_LEFT_CONTEXT + n_units * unit, np.float32)
        audio[CONV_LEFT_CONTEXT:CONV_LEFT_CONTEXT + len(src)] = src

        n_speech = 12 * n_units
        prompt = self.builder.offline_prompt(
            n_speech, states.target_ids[-opts.max_prompt_target_tokens:]
        )
        plen = len(prompt.ids)
        pbucket = int(np.ceil(plen / PROMPT_BUCKET) * PROMPT_BUCKET)
        ids = np.full((1, pbucket), self.cfg.tokens.pad, np.int64)
        ids[0, :plen] = prompt.ids

        max_tokens = int(length_in_seconds * opts.max_len_a + opts.max_len_b)
        max_steps = max(1, max_tokens - len(states.target_ids))
        max_steps = min(max_steps, opts.decode_buf_tokens)

        # the stop zone's start over the speech span; never reached once
        # the source is finished (every token is emitted then)
        real_speech_pre = int(
            np.ceil(len(src) / (SAMPLES_PER_SPEECH_TOKEN * 12)) * 12
        )
        stop_idx = (real_speech_pre - opts.frame_num
                    if not states.source_finished else 2**30)
        res, probes = self._offline_generate(
            torch.as_tensor(audio, device=self.device)[None],
            torch.as_tensor(ids, device=self.device), plen, n_units,
            max_steps, stop_idx,
        )
        self.last_result = res  # observability: steps, tokens, attn_idx
        self.last_call = dict(n_units=n_units, prompt_len=plen,
                              prompt_bucket=pbucket, max_steps=max_steps,
                              stop_idx=stop_idx, tail_start=tail_start)
        n_tok = res.n_tokens
        out_ids = [int(t) for t in res.tokens[:n_tok]]
        attn_idx = res.attn_idx[:n_tok]

        # the history trace: the prefill's probes over the recomputed
        # target prefix, in absolute stream samples
        tgt_start = prompt.patch_start + n_speech + 5  # assistant text
        states.most_attended_indices = [
            tail_start + probes[i] * SAMPLES_PER_SPEECH_TOKEN
            for i in range(tgt_start, plen)
        ]

        if not states.source_finished:
            # emit up to the first token attending within the last
            # frame_num speech tokens (stop_idx, the zone the beam loop
            # stopped on).  The reference scans range(len(output_ids) - 1):
            # the final token is withheld mid-stream.  With the early stop
            # the loop ends AT the first in-zone token (index n_tok - 1),
            # so the scan includes it; a loop that ran to max_steps falls
            # back to the reference's semantics.
            early = opts.attn_early_stop and n_tok < max_steps
            scan_bound = n_tok if early else max(n_tok - 1, 0)
            cnt = 0
            broke = False
            for a in attn_idx[:scan_bound]:
                if a >= stop_idx:
                    broke = True
                    break
                states.most_attended_indices.append(
                    tail_start + a * SAMPLES_PER_SPEECH_TOKEN
                )
                cnt += 1
            if early and not broke and cnt > max(n_tok - 1, 0):
                # a zone-stopped loop whose winner (an EOS hypothesis that
                # finished earlier) has no in-zone token: withhold the
                # final token as the reference's range(len - 1) does
                cnt = max(n_tok - 1, 0)
                states.most_attended_indices.pop()
            prediction_ids = out_ids[:cnt]
            if "�" in self.tokenizer.decode(prediction_ids):
                prediction_ids = prediction_ids[:-1]
            if opts.target_lang != "Chinese":
                # word-boundary trim (the guard mirrors the reference's
                # cnt < len(output_ids) - 1 bound)
                trim_guard = broke if early else cnt < n_tok - 1
                if trim_guard and cnt < n_tok and not self.tokenizer.decode(
                        [out_ids[cnt]]).startswith(" "):
                    prediction_ids = prediction_ids[:-1]
                    while prediction_ids:
                        tok = prediction_ids[-1]
                        prediction_ids = prediction_ids[:-1]
                        if self.tokenizer.decode([tok]).startswith(" "):
                            break
        else:
            prediction_ids = out_ids

        states.target_ids.extend(prediction_ids)
        translation = self.tokenizer.decode(
            prediction_ids, skip_special_tokens=True).strip()
        states.src_len = len(states.source)
        if translation != "" or states.source_finished:
            return WriteAction(content=translation,
                               finished=states.source_finished)
        return ReadAction()
