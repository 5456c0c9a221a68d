"""Prepare full-talk streaming-eval inputs.

Behavioural mirror of preprocess/prepare_simuleval_inputs.py: order
tst-COMMON rows by (talk id, offset), then emit one line per talk —
source: the full talk wav; target: the concatenated per-utterance
references joined by tabs (segment boundaries preserved for StreamLAAL
resegmentation).

Additionally emits ``.timing``: per talk, tab-separated
``start_ms:duration_ms`` for every reference segment, derived from the
TSV's audio offsets/frame counts.  eval/latency.stream_laal consumes this
so per-segment delays are measured against the segment's REAL start time
(MuST-C utterance durations are very unequal; an equal split misstates
StreamLAAL by hundreds of ms).
"""

from __future__ import annotations

import argparse
from collections import defaultdict

from infinisst_tpu_torch.data.audio import parse_path
from infinisst_tpu_torch.tools.preprocess.utils import read_tsv


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tsv", required=True)
    p.add_argument("--output-prefix", required=True)
    p.add_argument("--sample-rate", type=int, default=16000)
    args = p.parse_args(argv)

    rows = read_tsv(args.tsv)
    talks = defaultdict(list)
    for row in rows:
        path, off, n_frames = parse_path(row["audio"])
        talks[path].append((off, n_frames, row))
    ms = 1000.0 / args.sample_rate
    with open(args.output_prefix + ".source", "w") as src_f, open(
        args.output_prefix + ".target", "w"
    ) as tgt_f, open(args.output_prefix + ".timing", "w") as tim_f:
        for path in sorted(talks):
            utts = sorted(talks[path], key=lambda x: x[0])
            src_f.write(path + "\n")
            tgt_f.write("\t".join(r["tgt_text"] for _, _, r in utts) + "\n")
            tim_f.write(
                "\t".join(
                    f"{off * ms:.1f}:{nf * ms:.1f}" for off, nf, _ in utts
                )
                + "\n"
            )
    print(
        f"{len(talks)} talks -> "
        f"{args.output_prefix}.{{source,target,timing}}"
    )


if __name__ == "__main__":
    main()
