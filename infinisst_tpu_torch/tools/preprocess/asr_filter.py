"""ASR-based data filtering: transcribe slices with Whisper and drop
samples whose WER vs the original transcript exceeds a threshold.

Behavioural mirror of preprocess/asr.py + preprocess/filter_by_asr.py:
- Whisper-large-v3 transcription via the transformers pipeline (shardable
  with --shard i/n like the 8-way SLURM array in preprocess/asr.sh);
- WER > 0.4 drops the sample, with the reference's special-casing of
  non-speech markers like "(Laughter)" (filter_by_asr.py:110-123).
"""

from __future__ import annotations

import argparse
import json
import os
import re

from infinisst_tpu_torch.data.audio import get_waveform
from infinisst_tpu_torch.tools.preprocess.utils import (
    read_tsv,
    word_error_rate,
    write_tsv,
)

NON_SPEECH_RE = re.compile(r"\((Laughter|Applause|Music|Audio|Video)[^)]*\)", re.I)


def normalize(text: str) -> str:
    text = NON_SPEECH_RE.sub(" ", text)
    text = re.sub(r"[^\w\s']", " ", text.lower())
    return " ".join(text.split())


def transcribe(rows, model_name="openai/whisper-large-v3", device=-1):
    """Yield (id, transcript).  Requires the Whisper weights locally."""
    from transformers import pipeline  # pragma: no cover - needs weights

    asr = pipeline(
        "automatic-speech-recognition", model=model_name, device=device
    )
    for row in rows:
        wav, sr = get_waveform(row["audio"])
        out = asr({"array": wav, "sampling_rate": sr})
        yield row["id"], out["text"]


def run_asr(argv=None):  # pragma: no cover - needs model weights
    p = argparse.ArgumentParser()
    p.add_argument("--tsv", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--model", default="openai/whisper-large-v3")
    p.add_argument("--shard", default="0/1", help="i/n sharding")
    args = p.parse_args(argv)
    i, n = map(int, args.shard.split("/"))
    rows = read_tsv(args.tsv)[i::n]
    with open(args.output, "w") as f:
        for uid, text in transcribe(rows, args.model):
            f.write(json.dumps({"id": uid, "asr": text}) + "\n")


def filter_by_asr(rows, asr_texts, threshold: float = 0.4):
    kept, dropped = [], 0
    for row in rows:
        asr = asr_texts.get(row["id"])
        if asr is None:
            kept.append(row)
            continue
        ref = normalize(row.get("src_text", ""))
        hyp = normalize(asr)
        # non-speech-only segments (e.g. "(Laughter)") are kept
        if not ref:
            kept.append(row)
            continue
        if word_error_rate(hyp, ref) > threshold:
            dropped += 1
        else:
            kept.append(row)
    return kept, dropped


def run_filter(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tsv", required=True)
    p.add_argument("--asr-jsonl", required=True, nargs="+")
    p.add_argument("--output", default=None)
    p.add_argument("--threshold", type=float, default=0.4)
    args = p.parse_args(argv)
    rows = read_tsv(args.tsv)
    asr_texts = {}
    for path in args.asr_jsonl:
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                asr_texts[rec["id"]] = rec["asr"]
    kept, dropped = filter_by_asr(rows, asr_texts, args.threshold)
    out = args.output or args.tsv.replace(".tsv", "_filtered.tsv")
    write_tsv(out, kept)
    print(f"{len(kept)} kept, {dropped} dropped (WER>{args.threshold}) -> {out}")


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["asr"]:
        run_asr(sys.argv[2:])
    else:
        run_filter(sys.argv[1:] if sys.argv[1:2] != ["filter"] else sys.argv[2:])
