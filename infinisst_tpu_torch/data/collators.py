"""The five training collators (a copy of
``infinisst_tpu/data/collators.py``; numpy only).

Behavioural mirrors of the reference's collator family
(ref: train/dataset.py:279-940), producing numpy batches in our Batch
layout (train/step.py).  Variant selection matches --trajectory 0..4
(ref: model/model.py:33-39):

  0 offline plain prompt (+ parallel text-only batch)      :279-374
  1 offline chat template                                   :376-451
  2 trajectory plain                                        :453-560
  3 trajectory chat w/ perturbation opt/aug/off             :562-784
  4 trajectory chat multi-latency (+ <latency_m> system)    :786-940

Differences by design: prompts are built as explicit token layouts
(data/template.py) instead of tokenizer.apply_chat_template, and speech
embeddings are spliced by patch-mask scatter, so ragged speech lengths do
not mutate sequence lengths at runtime.
"""

from __future__ import annotations

import copy
from typing import Dict, Sequence

import numpy as np

from infinisst_tpu_torch.core.config import (
    CONV_LEFT_CONTEXT,
    ModelConfig,
)
from infinisst_tpu_torch.data.template import (
    IGNORE_INDEX,
    PromptBuilder,
    build_trajectory_prompt,
)
from infinisst_tpu_torch.models import adapter as adapter_mod
from infinisst_tpu_torch.models import wav2vec2 as w2v2_mod

SP_SEG_SAMPLES = int(12 * 0.08 * 16000)  # 960 ms


def conv_frames(model_cfg: ModelConfig, n_samples: int) -> int:
    return int(w2v2_mod.conv_out_length(model_cfg.w2v2, n_samples))


def speech_token_len(model_cfg: ModelConfig, n_samples: int) -> int:
    return int(
        adapter_mod.out_length(
            model_cfg.adapter, w2v2_mod.conv_out_length(model_cfg.w2v2, n_samples)
        )
    )


def _pad_stack(seqs: Sequence[np.ndarray], pad_value, dtype) -> np.ndarray:
    mx = max(len(s) for s in seqs)
    out = np.full((len(seqs), mx), pad_value, dtype)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out


class CollatorBase:
    def __init__(
        self,
        builder: PromptBuilder,
        model_cfg: ModelConfig,
        block_size: int = 48,
        **kw,
    ):
        self.builder = builder
        self.cfg = model_cfg
        self.t = model_cfg.tokens
        self.speech_segment_size = block_size // 4

    def validate(self, dataset) -> int:
        """Dataset-wide invariant sweep (the reference's manual validate()
        methods, train/dataset.py:465-478, :571-638): every trajectory's
        length must equal its padded speech-token count / segment size.
        Returns the number of rows checked; raises on violation."""
        if getattr(dataset, "trajectories", None) is None:
            return 0
        checked = 0
        for i in range(len(dataset)):
            traj = dataset.trajectories[i]
            if traj is None:
                continue
            n = dataset.n_frames[i]
            if n % SP_SEG_SAMPLES != 0:
                n += SP_SEG_SAMPLES - n % SP_SEG_SAMPLES
            n += CONV_LEFT_CONTEXT
            n_tok = speech_token_len(self.cfg, n)
            assert len(traj) == n_tok // self.speech_segment_size, (
                dataset.ids[i], len(traj), n_tok, self.speech_segment_size,
            )
            checked += 1
        return checked

    def _speech_batch(self, samples, pad_to_unit: bool):
        """Pad each source (optionally to 960 ms units), prepend the
        399-sample zero offset, batch-pad.  Returns (speech, frame_lengths,
        speech_token_lens)."""
        srcs = []
        for x in samples:
            s = x.source
            if pad_to_unit and len(s) % SP_SEG_SAMPLES != 0:
                n_pad = SP_SEG_SAMPLES - len(s) % SP_SEG_SAMPLES
                s = np.concatenate([s, np.zeros(n_pad, np.float32)])
            srcs.append(np.concatenate([np.zeros(CONV_LEFT_CONTEXT, np.float32), s]))
        speech = _pad_stack(srcs, 0.0, np.float32)
        frame_lens = np.asarray(
            [conv_frames(self.cfg, len(s)) for s in srcs], np.int32
        )
        tok_lens = np.asarray(
            [speech_token_len(self.cfg, len(s)) for s in srcs], np.int32
        )
        return speech, frame_lens, tok_lens

    def _finish(self, ids_list, labels_list, speech, frame_lens, extra=None):
        t = self.t
        input_ids = _pad_stack(ids_list, t.pad, np.int32)
        labels = _pad_stack(labels_list, IGNORE_INDEX, np.int32)
        attention_mask = (input_ids != t.pad).astype(np.int32)
        labels = np.where(attention_mask.astype(bool), labels, IGNORE_INDEX)
        batch = dict(
            speech=speech,
            frame_lengths=frame_lens,
            input_ids=input_ids,
            labels=labels,
            attention_mask=attention_mask,
            patch_mask=input_ids == t.sp_patch,
        )
        if extra:
            batch.update(extra)
        return batch


class OfflineCollator(CollatorBase):
    """trajectory=0: plain prompt + parallel text-only batch
    (ref: train/dataset.py:279-374)."""

    def __call__(self, samples) -> Dict:
        enc = self.builder.tokenizer.encode
        t = self.t
        speech, frame_lens, tok_lens = self._speech_batch(samples, False)
        max_tok = int(tok_lens.max())

        instruction = (
            f"Translate the following speech from {self.builder.source_lang} "
            f"to {self.builder.target_lang}:"
        )
        instr_ids = enc(instruction)
        ids_list, labels_list = [], []
        text_ids_list, text_labels_list = [], []
        for x in samples:
            target_ids = enc(x.target)
            ids = (
                instr_ids
                + [t.sp_start]
                + [t.sp_patch] * max_tok
                + [t.sp_end]
                + target_ids
                + [t.end_of_text]
            )
            lab = list(ids)
            n_prefix = len(instr_ids) + max_tok + 2
            lab[:n_prefix] = [IGNORE_INDEX] * n_prefix
            ids_list.append(np.asarray(ids, np.int32))
            labels_list.append(np.asarray(lab, np.int32))

            src_ids = enc(x.src_text)
            tids = (
                instr_ids
                + [t.sp_start]
                + src_ids
                + [t.sp_end]
                + target_ids
                + [t.end_of_text]
            )
            tlab = list(tids)
            np_prefix = len(instr_ids) + len(src_ids) + 2
            tlab[:np_prefix] = [IGNORE_INDEX] * np_prefix
            text_ids_list.append(np.asarray(tids, np.int32))
            text_labels_list.append(np.asarray(tlab, np.int32))

        text_input_ids = _pad_stack(text_ids_list, t.pad, np.int32)
        text_labels = _pad_stack(text_labels_list, IGNORE_INDEX, np.int32)
        return self._finish(
            ids_list,
            labels_list,
            speech,
            frame_lens,
            extra=dict(
                text_input_ids=text_input_ids,
                text_labels=text_labels,
                text_attention_mask=(text_input_ids != t.pad).astype(np.int32),
                multiplier=1,
            ),
        )


class OfflineInstructCollator(CollatorBase):
    """trajectory=1: single-turn chat template
    (ref: train/dataset.py:376-451)."""

    def __call__(self, samples) -> Dict:
        enc = self.builder.tokenizer.encode
        t = self.t
        speech, frame_lens, tok_lens = self._speech_batch(samples, False)
        max_tok = int(tok_lens.max())
        ids_list, labels_list = [], []
        for x in samples:
            ids, labels = build_trajectory_prompt(
                self.builder, [x.target], max_tok, 1, latency_token=False
            )
            ids_list.append(ids)
            labels_list.append(labels)
        return self._finish(
            ids_list, labels_list, speech, frame_lens,
            extra=dict(multiplier=1),
        )


def _as_pairs(traj):
    if traj and not isinstance(traj[0], (list, tuple)):
        return [[seg, True] for seg in traj]
    return [list(p) for p in traj]


def perturb_trajectory(traj, rng: np.random.RandomState, cut=None):
    """shift+merge augmentation (ref: train/dataset.py:670-697,
    :834-862).  ``cut`` tokenises a segment into words (jieba for zh)."""
    if cut is None:
        try:
            import jieba

            cut = lambda s: list(jieba.cut(s))  # noqa: E731
        except ImportError:  # pragma: no cover
            cut = lambda s: s.split()  # noqa: E731
    shift = []
    for i in range(len(traj)):
        seg = traj[len(traj) - i - 1][0]
        if seg == "" or rng.rand() < 0.5 or i == 0:
            shift.append([seg, True])
            continue
        words = cut(seg)
        k = rng.randint(len(words))
        shift[-1][0] = "".join(words[k:]) + shift[-1][0]
        shift.append(["".join(words[:k]), False])
    shift = shift[::-1]
    merged = copy.deepcopy(shift)
    for i in range(len(merged) - 1):
        seg, _ = merged[i]
        if seg == "" or rng.rand() < 0.5:
            continue
        merged[i] = ["", False]
        merged[i + 1][0] = seg + merged[i + 1][0]
    return merged


class TrajectoryCollator(CollatorBase):
    """trajectory=2: plain prompt with per-chunk sp_start/patch/sp_end +
    text + <|end_of_text|> (ref: train/dataset.py:453-560)."""

    def __call__(self, samples) -> Dict:
        enc = self.builder.tokenizer.encode
        t = self.t
        speech, frame_lens, tok_lens = self._speech_batch(samples, True)
        seg = self.speech_segment_size
        instruction = (
            f"Translate the following speech from {self.builder.source_lang} "
            f"to {self.builder.target_lang}: "
        )
        instr_ids = enc(instruction)
        ids_list, labels_list = [], []
        for i, x in enumerate(samples):
            traj = _as_pairs(x.trajectory)
            assert len(traj) == int(tok_lens[i]) // seg, (
                len(traj), int(tok_lens[i]), seg,
            )
            ids = list(instr_ids)
            lab = [IGNORE_INDEX] * len(instr_ids)
            for j, (text, _) in enumerate(traj):
                n_sp = min(seg, int(tok_lens[i]) - j * seg)
                sp = [t.sp_start] + [t.sp_patch] * n_sp + [t.sp_end]
                text_ids = enc(text) if text else []
                ids.extend(sp + text_ids + [t.end_of_text])
                lab.extend(
                    [IGNORE_INDEX] * len(sp) + text_ids + [t.end_of_text]
                )
            ids_list.append(np.asarray(ids, np.int32))
            labels_list.append(np.asarray(lab, np.int32))
        return self._finish(
            ids_list, labels_list, speech, frame_lens,
            extra=dict(multiplier=1),
        )


class TrajectoryInstructCollator(CollatorBase):
    """trajectory=3: multi-turn chat with perturbation modes opt/aug/off
    (ref: train/dataset.py:562-784)."""

    def __init__(self, *a, perturb=(0.3, 0.3, 0.4), seed=0, **kw):
        super().__init__(*a, **kw)
        assert abs(sum(perturb) - 1) < 1e-6
        self.perturb = perturb
        self.rng = np.random.RandomState(seed)

    def __call__(self, samples) -> Dict:
        speech, frame_lens, tok_lens = self._speech_batch(samples, True)
        mode = self.rng.choice(["opt", "aug", "off"], p=self.perturb)
        ids_list, labels_list = [], []
        for i, x in enumerate(samples):
            traj = _as_pairs(x.trajectory)
            if mode == "aug":
                traj = perturb_trajectory(traj, self.rng)
            elif mode == "off":
                traj = [["", False]] * (len(traj) - 1) + [[x.target, True]]
            ids, labels = build_trajectory_prompt(
                self.builder, traj, int(tok_lens[i]), 1, latency_token=False
            )
            ids_list.append(ids)
            labels_list.append(labels)
        return self._finish(
            ids_list, labels_list, speech, frame_lens,
            extra=dict(multiplier=1, mode=mode),
        )


class TrajectoryMultiLatencyCollator(CollatorBase):
    """trajectory=4 (release recipe): sample m in 1..max, merge every m
    segments, <latency_m> system prompt
    (ref: train/dataset.py:786-940)."""

    def __init__(self, *a, max_multiplier=4, prob_aug=0.0, seed=0, **kw):
        super().__init__(*a, **kw)
        self.max_multiplier = max_multiplier
        self.prob_aug = prob_aug
        self.rng = np.random.RandomState(seed)

    def __call__(self, samples) -> Dict:
        m = int(self.rng.randint(1, self.max_multiplier + 1))
        # pad to m * 960 ms units
        unit = SP_SEG_SAMPLES * m
        for x in samples:
            if len(x.source) % unit != 0:
                n_pad = unit - len(x.source) % unit
                x.source = np.concatenate(
                    [x.source, np.zeros(n_pad, np.float32)]
                )
        speech, frame_lens, tok_lens = self._speech_batch(samples, False)

        ids_list, labels_list = [], []
        for i, x in enumerate(samples):
            traj = _as_pairs(x.trajectory)
            merged = []
            for j in range(0, len(traj), m):
                text = "".join(
                    traj[k][0] for k in range(j, min(j + m, len(traj)))
                )
                merged.append([text, True])
            if self.rng.rand() < self.prob_aug:  # zh only in the reference
                merged = perturb_trajectory(merged, self.rng)
            ids, labels = build_trajectory_prompt(
                self.builder, merged, int(tok_lens[i]), m, latency_token=True
            )
            ids_list.append(ids)
            labels_list.append(labels)
        return self._finish(
            ids_list, labels_list, speech, frame_lens,
            extra=dict(multiplier=m),
        )


COLLATORS = {
    0: OfflineCollator,
    1: OfflineInstructCollator,
    2: TrajectoryCollator,
    3: TrajectoryInstructCollator,
    4: TrajectoryMultiLatencyCollator,
}
