"""AlignAtt agent: attention-guided streaming policy over an offline model;
port of ``infinisst_tpu/agents/alignatt.py``.

Every policy call re-encodes the audio so far (its last
``max_audio_chunks`` x 960 ms, zero-padded up to a multiple of
``length_bucket_chunks`` units) with the encoder made bidirectional
(``block_frames = max_cache_frames = 10**7``), builds the single-turn
offline prompt with the target so far as the assistant's prefix (its
last ``max_prompt_target_tokens`` ids, padded up to a multiple of 64),
prefills it on an empty cache and beam-decodes while probing the
head-averaged attention of layer ``attn_layer`` over the speech span.
The call is one device program per (n_units, prompt bucket), as JAX jits
it (``_offline_fn``; captured as CUDA graphs on the card, its pieces run
uncaptured on the CPU): the host uploads the call's inputs, reads
``done`` once a beam step and the packed result (the winner and the
prefill's probes) once.
Emission stops at the first token whose most-attended speech token lies
in the last ``frame_num`` tokens of the real (unpadded) speech, with a
word-boundary trim for targets other than Chinese.

The probe reads the prompt's own speech span in the prefill too; the JAX
agent's prefill probe reads an empty cache block and returns 0 (ROADMAP
§3), so its first token's index and its history trace differ from this
agent's.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from infinisst_tpu_torch.agents.base import AgentStates, ReadAction, WriteAction
from infinisst_tpu_torch.agents.infinisst import InfiniSSTAgent, InfiniSSTOptions
from infinisst_tpu_torch.core import graphs
from infinisst_tpu_torch.core.config import CONV_LEFT_CONTEXT
from infinisst_tpu_torch.core.graphs import put as _put
from infinisst_tpu_torch.decode import beam as beam_mod
from infinisst_tpu_torch.models import adapter as adapter_mod
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.models import wav2vec2 as w2v2_mod
from infinisst_tpu_torch.streaming.state import DecoderState

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


class _OfflineBuffers(NamedTuple):
    """What every (n_units, pbucket) program of an agent shares."""

    k: torch.Tensor  # flat: the decoder cache of the largest bucket
    v: torch.Tensor
    valid_len: torch.Tensor  # (1,) int64
    loop: beam_mod.BeamLoop  # probed, prompt buffer of pmax ids
    hist: torch.Tensor  # (1, 1) int64: no cross-chunk history
    hist_len: torch.Tensor  # (1,) int64
    pmax: int  # the largest prompt bucket the options allow


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

    def __init__(self, *args, **kw):
        # the offline programs' shared buffers (``_offline_buffers``)
        self._offline: Optional[_OfflineBuffers] = None
        self.last_graph = None  # the last call: capture, replay or eager
        super().__init__(*args, **kw)

    def build_states(self):
        return AlignAttStates()

    # -- offline generate ----------------------------------------------------
    def _offline_buffers(self) -> _OfflineBuffers:
        """The buffers every key shares, made at the first call: the
        decoder cache (each key's cache of pbucket + G slots is a view of
        its prefix), its valid length, the beam loop (its prompt buffer
        as wide as the largest bucket) and the empty cross-chunk
        history."""
        if self._offline is not None:
            return self._offline
        cfg, opts, dev = self.cfg, self.opts, self.device
        ll = cfg.llama
        G = opts.decode_buf_tokens
        longest = self.builder.offline_prompt(
            12 * opts.max_audio_chunks,
            [cfg.tokens.pad] * opts.max_prompt_target_tokens).ids.shape[0]
        pmax = -(-longest // PROMPT_BUCKET) * PROMPT_BUCKET
        KV = llama_mod.local_heads(self.params["llama"]["layers"], ll)[1]
        n = ll.num_layers * (pmax + G) * KV * ll.head_dim
        spec = self._offline_spec()
        i64 = dict(dtype=torch.int64, device=dev)
        self._offline = _OfflineBuffers(
            k=torch.zeros((n,), dtype=self.dtype, device=dev),
            v=torch.zeros((n,), dtype=self.dtype, device=dev),
            valid_len=torch.zeros((1,), **i64),
            loop=beam_mod.alloc_loop(spec, ll, ll.vocab_size, pmax, KV,
                                     self.dtype, dev, probe=True),
            hist=torch.zeros((1, 1), **i64),
            hist_len=torch.zeros((1,), **i64),
            pmax=pmax)
        return self._offline

    def _offline_spec(self) -> beam_mod.BeamSpec:
        cfg, opts = self.cfg, self.opts
        return beam_mod.BeamSpec(
            beam=opts.beam, max_new_tokens=opts.decode_buf_tokens,
            eos_id=cfg.tokens.eos, pad_id=cfg.tokens.pad,
            no_repeat_ngram_size=opts.no_repeat_ngram_size,
            repetition_penalty=opts.repetition_penalty,
        )

    def _offline_fn(self, n_units: int, pbucket: int) -> graphs.DeviceProgram:
        """The offline call over ``n_units`` 960 ms units and a prompt
        padded to ``pbucket`` ids as one device program, made once per
        key (n_units, pbucket) as JAX jits it: pieces (A) encoder ->
        adapter -> splice at the speech patches -> probed prefill on the
        cache, set to valid length 0 in place -> the beam loop's start at
        the device prompt length, step cap and stop zone, (B) one beam
        step's bookkeeping, (C) one probed ``beam_token_step``, (F) the
        winner, packed with the prefill's probes.  Its inputs (the audio,
        the padded ids and [prompt_len, max_steps, stop_idx]) are static
        buffers of the key; captured as CUDA graphs on the card."""
        key = (n_units, pbucket)
        if key in self._programs:
            return self._programs[key]
        cfg, opts, dev = self.cfg, self.opts, self.device
        ll, G = cfg.llama, opts.decode_buf_tokens
        n_speech = 12 * n_units
        spec = self._offline_spec()
        patch_start = self.builder.offline_prompt(n_speech, []).patch_start
        probe = (opts.attn_layer, patch_start, patch_start + n_speech)
        start = min(patch_start, pbucket - n_speech)
        buf = self._offline_buffers()
        if pbucket > buf.pmax:
            raise ValueError(f"a prompt bucket of {pbucket} ids is past the "
                             f"largest the options allow ({buf.pmax})")
        KV = buf.loop.gen_k.shape[3]
        cap = pbucket + G
        shape = (ll.num_layers, 1, cap, KV, ll.head_dim)
        n = math.prod(shape)
        dec = DecoderState(k=buf.k[:n].view(shape), v=buf.v[:n].view(shape),
                           valid_len=buf.valid_len)
        i64 = dict(dtype=torch.int64, device=dev)
        audio = torch.zeros((1, CONV_LEFT_CONTEXT + n_units * self.unit_samples),
                            dtype=torch.float32, device=dev)
        ids = torch.zeros((1, pbucket), **i64)
        scal = torch.zeros((3,), **i64)  # prompt_len, max_steps, stop_idx
        probes = torch.zeros((pbucket,), **i64)
        packed = torch.zeros((4 + 2 * G + pbucket,), dtype=torch.int32,
                             device=dev)
        loop = buf.loop
        # the pieces hold the agent weakly (see InfiniSSTAgent's programs)
        me = weakref.proxy(self)

        def prefill():  # A
            p = me.params
            frames = w2v2_mod.forward(
                p["w2v2"], cfg.w2v2, audio,
                block_frames=10**7, max_cache_frames=10**7,
            )
            speech = adapter_mod.forward(p["adapter"], cfg.adapter, frames)
            emb = llama_mod.embed(p["llama"], ids)
            emb[:, start:start + n_speech] = speech.to(emb.dtype)
            dec.valid_len.zero_()
            plen = scal[0]
            valid = (torch.arange(pbucket, device=dev)[None] < plen).to(
                torch.int64)
            logits, new, pr = llama_mod.decode_step(
                p["llama"], ll, dec, emb, valid_mask=valid, attn_probe=probe)
            _put(dec, new)
            probes.copy_(pr[0])
            last = (plen - 1).reshape(1)
            beam_mod.start_loop(
                loop, spec, logits[0].index_select(0, last).to(torch.float32),
                ids, plen.reshape(1), max_steps=scal[1:2],
                first_attn_idx=probes.index_select(0, last),
                attn_stop_idx=scal[2:3] if opts.attn_early_stop else None)

        def select():  # B
            beam_mod.beam_select(loop, spec, buf.hist, buf.hist_len, 0,
                                 me._suppress)

        def forward():  # C
            beam_mod.beam_forward(loop, me.params["llama"], ll, dec, probe)

        def finish():  # F
            packed.copy_(beam_mod.pack_result(beam_mod.beam_finish(loop, spec),
                                              probes[None])[0])

        prog = graphs.DeviceProgram(
            dict(A=prefill, B=select, C=forward, F=finish), self._pool())
        prog.loop, prog.packed, prog.probes = loop, packed, probes
        prog.inputs = (audio, ids, scal)
        # pinned staging on the card: the upload needs no synchronisation
        prog.staging = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            if dev.type == "cuda" else None for t in prog.inputs)
        self._programs[key] = prog
        return prog

    def _offline_generate(self, audio: np.ndarray, ids: np.ndarray,
                          plen: int, n_units: int, max_steps: int,
                          stop_idx: int):
        """One call of the key's program: audio (1, CONV_LEFT_CONTEXT +
        n_units * 15360) float32 and ids (1, pbucket) padded int64 are
        uploaded into its buffers with [plen, max_steps, stop_idx], then
        A, {B, read ``done``, C} until done, F and one read of the packed
        result: steps + 1 host reads.  Returns (beam result, the prefill's
        (pbucket,) probes)."""
        G = self.opts.decode_buf_tokens
        prog = self._offline_fn(n_units, ids.shape[1])
        host = (audio, ids, np.asarray([plen, max_steps, stop_idx], np.int64))
        with prog.step():
            for dst, stage, x in zip(prog.inputs, prog.staging, host):
                src = torch.from_numpy(x)
                if stage is None:
                    dst.copy_(src)
                else:
                    stage.copy_(src)
                    dst.copy_(stage, non_blocking=True)
            prog.run("A")
            prog.run("B")
            while not beam_mod.read_done(prog.loop):
                prog.run("C")
                prog.run("B")
            prog.run("F")
            packed = graphs.read(prog.packed)
        self.last_graph = ("replay" if prog.captured and prog.replays
                           else "capture" if prog.captured else "eager")
        return (beam_mod.unpack_result(packed, G),
                beam_mod.unpack_trace(packed, G))

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
            audio[None], ids, plen, n_units, max_steps, stop_idx)
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
