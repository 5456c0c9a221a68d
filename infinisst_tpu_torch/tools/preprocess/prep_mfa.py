"""Dump per-utterance wav + txt for Montreal Forced Aligner.

Behavioural mirror of preprocess/prep_mfa.py: for each TSV row, write
<id>.wav (sliced from the source audio) and <id>.txt (source transcript)
into an output corpus directory; MFA itself runs externally
(`mfa align`, ref: preprocess/README.md).
"""

from __future__ import annotations

import argparse
import os

from infinisst_tpu_torch.data.audio import get_waveform, write_wav
from infinisst_tpu_torch.tools.preprocess.utils import read_tsv


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tsv", required=True)
    p.add_argument("--output-dir", required=True)
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    rows = read_tsv(args.tsv)
    for row in rows:
        wav, sr = get_waveform(row["audio"])
        uid = row["id"]
        write_wav(os.path.join(args.output_dir, f"{uid}.wav"), wav, sr)
        with open(os.path.join(args.output_dir, f"{uid}.txt"), "w") as f:
            f.write(row.get("src_text", "") + "\n")
    print(f"wrote {len(rows)} utterances to {args.output_dir}")


if __name__ == "__main__":
    main()
