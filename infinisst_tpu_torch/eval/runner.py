"""Streaming evaluation harness: a SimulEval-equivalent driver (a copy of
``infinisst_tpu/eval/runner.py``).

SimulEval is not needed: this runner reproduces its protocol (ref:
scripts/infer/infinisst.sh): for each line of the source file (one wav
path per line — for the unbounded condition one full TED talk per line,
prepare_simuleval_inputs.py), feed the agent fixed ``source_segment_size``
chunks, collect WriteActions with their delays, then score BLEU
(sacrebleu, 13a/zh; NaN without sacrebleu) + LAAL/StreamLAAL (+ CA
variants) and RTF.

Outputs an ``instances.log``-style JSONL compatible in spirit with
SimulEval's output directory.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from infinisst_tpu_torch.data.audio import get_waveform
from infinisst_tpu_torch.eval.latency import Emission, InstanceLog, rtf, stream_laal


@dataclass
class EvalArgs:
    source: str  # file: one wav path per line
    target: str  # file: one tab-or-newline-separated reference per line
    timing: Optional[str] = None  # file: tab-separated start_ms:dur_ms per
    # reference segment (prepare_simuleval_inputs.py .timing output); when
    # absent StreamLAAL falls back to an equal split of the source
    output: str = "eval_out"
    source_segment_size: int = 960  # ms
    eval_latency_unit: str = "word"  # 'word' | 'char'
    sacrebleu_tokenizer: str = "13a"  # '13a' | 'zh'
    max_instances: Optional[int] = None


def run_streaming_eval(agent, args: EvalArgs) -> dict:
    with open(args.source) as f:
        sources = [l.strip() for l in f if l.strip()]
    with open(args.target) as f:
        targets = [l.rstrip("\n") for l in f]
    timings = None
    if args.timing:
        with open(args.timing) as f:
            timings = [
                [
                    tuple(float(x) for x in seg.split(":"))
                    for seg in line.strip().split("\t")
                ]
                if line.strip()
                else []
                for line in f
            ]
    if args.max_instances:
        sources = sources[: args.max_instances]
        targets = targets[: args.max_instances]
        if timings is not None:
            timings = timings[: args.max_instances]
    # fail FAST on a mismatched .timing file (an IndexError during scoring
    # would throw away hours of streaming compute): every talk needs a
    # timing line, and each line as many start:dur entries as the talk has
    # tab-separated reference segments
    if timings is not None:
        if len(timings) < len(sources):
            raise SystemExit(
                f"--timing has {len(timings)} lines for {len(sources)} "
                "source talks; regenerate it from the same TSV "
                "(prepare_simuleval_inputs.py)"
            )
        for i, t in enumerate(targets[: len(sources)]):
            n_seg = t.count("\t") + 1
            if timings[i] and len(timings[i]) != n_seg:
                raise SystemExit(
                    f"--timing line {i} has {len(timings[i])} segments but "
                    f"the reference has {n_seg}; regenerate the timing file"
                )

    os.makedirs(args.output, exist_ok=True)
    seg_samples = int(args.source_segment_size * 16)
    hyps, logs = [], []
    total_compute = 0.0
    total_audio = 0.0

    with open(os.path.join(args.output, "instances.log"), "w") as inst_f:
        for idx, (src, tgt) in enumerate(zip(sources, targets)):
            agent.reset()
            wav, sr = get_waveform(src)
            assert sr == 16000, f"expected 16 kHz, got {sr}"
            log = InstanceLog(source_duration_ms=len(wav) / 16.0)
            compute_s = 0.0
            pos = 0
            while pos < len(wav):
                seg = wav[pos : pos + seg_samples]
                pos += len(seg)
                finished = pos >= len(wav)
                t0 = time.perf_counter()
                act = agent.push(seg, finished=finished)
                dt = time.perf_counter() - t0
                compute_s += dt
                if not act.is_read() and act.content:
                    log.emissions.append(
                        Emission(
                            text=act.content,
                            delay_ms=pos / 16.0,
                            ca_delay_ms=pos / 16.0 + compute_s * 1000.0,
                        )
                    )
            joiner = "" if args.eval_latency_unit == "char" else " "
            hyp = joiner.join(e.text for e in log.emissions).strip()
            hyps.append(hyp)
            logs.append(log)
            total_compute += compute_s
            total_audio += len(wav) / 16000.0
            refs = tgt.split("\t") if "\t" in tgt else [tgt]
            inst_f.write(
                json.dumps(
                    {
                        "index": idx,
                        "prediction": hyp,
                        "reference": tgt,
                        "delays": [e.delay_ms for e in log.emissions],
                        "elapsed": [e.ca_delay_ms for e in log.emissions],
                        "source_length": log.source_duration_ms,
                        "rtf": compute_s / max(len(wav) / 16000.0, 1e-9),
                    }
                )
                + "\n"
            )

    # quality
    refs = [t.replace("\t", " ") for t in targets[: len(hyps)]]
    try:
        import sacrebleu

        bleu = sacrebleu.corpus_bleu(
            hyps, [refs], tokenize=args.sacrebleu_tokenizer
        ).score
    except Exception:
        bleu = float("nan")

    def _seg_times(i):
        return timings[i] if timings is not None and timings[i] else None

    laal = float(
        np.mean(
            [
                stream_laal(
                    log,
                    targets[i].split("\t") if "\t" in targets[i] else [targets[i]],
                    unit=args.eval_latency_unit,
                    seg_times=_seg_times(i),
                )
                for i, log in enumerate(logs)
            ]
        )
    )
    laal_ca = float(
        np.mean(
            [
                stream_laal(
                    log,
                    targets[i].split("\t") if "\t" in targets[i] else [targets[i]],
                    unit=args.eval_latency_unit,
                    computation_aware=True,
                    seg_times=_seg_times(i),
                )
                for i, log in enumerate(logs)
            ]
        )
    )
    scores = {
        "bleu": bleu,
        "stream_laal": laal,
        "stream_laal_ca": laal_ca,
        "rtf": rtf(total_compute, total_audio),
        "n_instances": len(hyps),
    }
    with open(os.path.join(args.output, "scores.json"), "w") as f:
        json.dump(scores, f, indent=2)
    return scores
