"""TSV-manifest speech-to-text dataset (a copy of
``infinisst_tpu/data/dataset.py``; numpy only).

Mirror of PromptSpeechToTextDataset(Creator) (ref: train/dataset.py:88-213):
reads MuST-C-style TSV manifests with columns
  id, audio, n_frames, tgt_text [, src_text, speaker, trajectory,
  speech_word, text_word, sampling]
where audio may use the sliced 'path:offset:frames' convention.  Structured
columns are parsed with ast.literal_eval (the reference uses eval on
manifest text, train/dataset.py:193-200 — literal_eval accepts the same
data without executing code).
"""

from __future__ import annotations

import ast
import csv
from dataclasses import dataclass
from pathlib import Path
from typing import Any, List, Optional

import numpy as np

from infinisst_tpu_torch.data.audio import get_waveform


@dataclass
class SpeechToTextItem:
    id: str
    index: int
    source: np.ndarray  # float32 waveform
    target: str
    src_text: str
    task: str = ""
    speech_word: Optional[List] = None
    text_word: Optional[List] = None
    trajectory: Optional[List] = None
    sampled_trajectory: Optional[List] = None


def _maybe_literal(s: Optional[str]) -> Optional[Any]:
    if not s:
        return None
    return ast.literal_eval(s)


class SpeechToTextDataset:
    def __init__(
        self,
        audio_paths: List[str],
        n_frames: List[int],
        tgt_texts: List[str],
        src_texts: List[str],
        ids: List[str],
        tasks: Optional[List[str]] = None,
        speech_words=None,
        text_words=None,
        trajectories=None,
        sampled_trajectories=None,
    ):
        self.audio_paths = audio_paths
        self.n_frames = n_frames
        self.tgt_texts = tgt_texts
        self.src_texts = src_texts
        self.ids = ids
        self.tasks = tasks or [""] * len(ids)
        self.speech_words = speech_words
        self.text_words = text_words
        self.trajectories = trajectories
        self.sampled_trajectories = sampled_trajectories

    def __len__(self) -> int:
        return len(self.audio_paths)

    def __getitem__(self, index: int) -> SpeechToTextItem:
        # bounded retry with random backoff on flaky reads (the reference
        # retries forever on NFS hiccups, train/dataset.py:117-124)
        import random
        import time as _time

        last_err = None
        for _ in range(20):
            try:
                source, _sr = get_waveform(self.audio_paths[index])
                break
            except OSError as e:  # pragma: no cover - fs dependent
                last_err = e
                _time.sleep(random.uniform(0, 1))
        else:  # pragma: no cover
            raise last_err
        return SpeechToTextItem(
            id=self.ids[index],
            index=index,
            source=source.astype(np.float32),
            target=self.tgt_texts[index],
            src_text=self.src_texts[index],
            task=self.tasks[index],
            speech_word=(
                self.speech_words[index] if self.speech_words else None
            ),
            text_word=self.text_words[index] if self.text_words else None,
            trajectory=(
                self.trajectories[index] if self.trajectories else None
            ),
            sampled_trajectory=(
                self.sampled_trajectories[index]
                if self.sampled_trajectories
                else None
            ),
        )

    @classmethod
    def from_tsv(cls, root: str, split: str) -> "SpeechToTextDataset":
        tsv_path = Path(root) / f"{split}.tsv"
        if not tsv_path.is_file():
            raise FileNotFoundError(f"Dataset not found: {tsv_path}")
        with open(tsv_path) as f:
            reader = csv.DictReader(
                f,
                delimiter="\t",
                quotechar=None,
                doublequote=False,
                lineterminator="\n",
                quoting=csv.QUOTE_NONE,
            )
            samples = [dict(e) for e in reader]
        if not samples:
            raise ValueError(f"Empty manifest: {tsv_path}")
        return cls(
            audio_paths=[s["audio"] for s in samples],
            n_frames=[int(s["n_frames"]) for s in samples],
            tgt_texts=[s.get("tgt_text", "") for s in samples],
            src_texts=[s.get("src_text", "") for s in samples],
            ids=[s["id"] for s in samples],
            tasks=[s.get("task", "") for s in samples],
            speech_words=[
                _maybe_literal(s.get("speech_word", "")) for s in samples
            ],
            text_words=[
                _maybe_literal(s.get("text_word", "")) for s in samples
            ],
            trajectories=[
                _maybe_literal(s.get("trajectory", "")) for s in samples
            ],
            sampled_trajectories=[
                _maybe_literal(s.get("sampling", "")) for s in samples
            ],
        )
