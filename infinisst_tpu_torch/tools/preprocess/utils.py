"""Shared preprocess helpers (TSV/wav/log IO).

Behavioural mirror of the reference's preprocess/utils.py: TSV read/write
with QUOTE_NONE and the 'path:offset:frames' wav slicing convention."""

from __future__ import annotations

import csv
from typing import Dict, List

from infinisst_tpu_torch.data.audio import get_waveform, parse_path, read_wav  # noqa: F401


def read_tsv(path: str) -> List[Dict[str, str]]:
    with open(path) as f:
        reader = csv.DictReader(
            f,
            delimiter="\t",
            quotechar=None,
            doublequote=False,
            lineterminator="\n",
            quoting=csv.QUOTE_NONE,
        )
        return [dict(r) for r in reader]


def write_tsv(path: str, rows: List[Dict[str, str]], fieldnames=None):
    if fieldnames is None:
        fieldnames = list(rows[0].keys())
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(
            f,
            fieldnames=fieldnames,
            delimiter="\t",
            quotechar=None,
            doublequote=False,
            lineterminator="\n",
            quoting=csv.QUOTE_NONE,
        )
        w.writeheader()
        for r in rows:
            w.writerow(r)


def word_error_rate(hyp: str, ref: str) -> float:
    """Levenshtein WER (the reference uses evaluate/jiwer,
    preprocess/filter_by_asr.py)."""
    h, r = hyp.split(), ref.split()
    if not r:
        return 0.0 if not h else 1.0
    prev = list(range(len(h) + 1))
    for j, rw in enumerate(r, 1):
        cur = [j] + [0] * len(h)
        for i, hw in enumerate(h, 1):
            cur[i] = min(
                prev[i] + 1,
                cur[i - 1] + 1,
                prev[i - 1] + (0 if hw == rw else 1),
            )
        prev = cur
    return prev[len(h)] / len(r)
