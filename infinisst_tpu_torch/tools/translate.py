"""Offline (non-streaming) translation of wav files; port of
``infinisst_tpu/tools/translate.py``.

The offline condition: a whole-utterance bidirectional encode, the
single-turn prompt and beam search, i.e. the AlignAtt agent's model path
with the policy off (a finished source emits every token).

Usage (``--device`` defaults to ``cuda``):
  python -m infinisst_tpu_torch.tools.translate --wav utt.wav [utt2.wav ...] \\
      --state-dict-path .../pytorch_model.bin --model-name .../llama-dir \\
      --target-lang German [--beam 4] [--dtype float32] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def translate_waveform(agent, wav: np.ndarray) -> str:
    """One-shot offline translation of a 16 kHz waveform by an AlignAtt
    agent: the source is pushed whole and finished."""
    agent.reset()
    act = agent.push(wav, finished=True)
    return act.content if not act.is_read() else ""


def main(argv=None):
    from infinisst_tpu_torch.agents.cli import add_args, build_agent
    from infinisst_tpu_torch.data.audio import get_waveform

    p = argparse.ArgumentParser()
    add_args(p)
    p.add_argument("--wav", nargs="+", required=True)
    # the eval CLI's parser requires --source / --target; they are moot here
    args = p.parse_args(
        ["--source", "/dev/null", "--target", "/dev/null", "--agent",
         "alignatt"] + (sys.argv[1:] if argv is None else list(argv))
    )
    agent = build_agent(args)
    out = []
    for path in args.wav:
        wav, sr = get_waveform(path)
        assert sr == 16000, (path, sr)
        text = translate_waveform(agent, wav)
        print(f"{path}\t{text}")
        out.append(text)
    return out


if __name__ == "__main__":
    main()
