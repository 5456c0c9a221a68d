"""Benchmark reporting: collect BENCH_r*.json + eval scores and render a
markdown comparison against the reference baselines (BASELINE.md).

The reference keeps its numbers as hardcoded arrays in plots/plot.ipynb
(SURVEY.md §2.23); here the report is generated from machine-readable
artifacts.

Usage: python -m infinisst_tpu_torch.tools.report [--dir .] [--out REPORT.md]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

BASELINES = {
    # (pair, metric) -> [m1, m2, m3, m4]  (BASELINE.md / plot.ipynb cell 3, 9)
    ("en-de", "bleu"): [22.3, 25.7, 27.4, 27.7],
    ("en-de", "stream_laal"): [839, 1365, 1787, 2292],
    ("en-de", "stream_laal_ca"): [1444, 2054, 2651, 3303],
    ("en-de", "rtf"): [0.382, 0.286, 0.250, 0.235],
    ("en-es", "bleu"): [26.14, 29.88, 31.47, 32.00],
    ("en-es", "stream_laal"): [763, 1316, 1763, 2211],
    ("en-es", "rtf"): [0.550, 0.268, 0.235, 0.355],
    ("en-zh", "bleu"): [23.75, 25.39, 25.75, 25.99],
    ("en-zh", "stream_laal"): [1078, 1522, 1948, 2353],
    ("en-zh", "rtf"): [0.338, 0.233, 0.201, 0.236],
}


def collect(d: str):
    rows = []
    for path in sorted(glob.glob(os.path.join(d, "BENCH_r*.json"))):
        with open(path) as f:
            rec = json.load(f)
        # a run record may nest the bench's JSON line under "parsed"
        if isinstance(rec.get("parsed"), dict):
            rec = dict(rec["parsed"], **{
                k: v for k, v in rec.items() if k not in ("parsed", "tail")
            })
        rec["round"] = os.path.basename(path)
        rows.append(rec)
    for path in sorted(
        glob.glob(os.path.join(d, "docs", "hw_rows_r*.jsonl"))
    ):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                tag = rec.get("_queue_name") or " ".join(
                    rec.get("_argv", [])
                )
                base = os.path.basename(path)
                rec["round"] = f"{base}:{tag}" if tag else base
                rows.append(rec)
    for path in sorted(glob.glob(os.path.join(d, "**", "scores.json"),
                                 recursive=True)):
        with open(path) as f:
            rec = json.load(f)
        rec["round"] = path
        rows.append(rec)
    return rows


def render(rows) -> str:
    out = ["# Benchmark report", ""]
    out.append("## This framework")
    out.append("")
    out.append("| source | metric | value | unit | vs baseline |")
    out.append("|---|---|---|---|---|")
    for r in rows:
        if "metric" in r:
            out.append(
                f"| {r['round']} | {r['metric']} | {r['value']} | "
                f"{r.get('unit','')} | {r.get('vs_baseline','')} |"
            )
        else:
            for k in ("bleu", "stream_laal", "stream_laal_ca", "rtf"):
                if k in r:
                    out.append(f"| {r['round']} | {k} | {r[k]:.3f} | | |")
    out.append("")
    out.append(
        "vs-baseline semantics per metric family: rtf rows = reference_rtf"
        " / ours (speedup, reference 8B on L40S); serve tok/s rows = ours /"
        " 30 tok/s (the serving target); train speech-s/s rows = x realtime"
        " per chip (ours / 1.0)."
    )
    out.append("")
    out.append("## Reference baselines (L40S; BASELINE.md)")
    out.append("")
    out.append("| pair | metric | m=1 | m=2 | m=3 | m=4 |")
    out.append("|---|---|---|---|---|---|")
    for (pair, metric), vals in BASELINES.items():
        out.append(
            f"| {pair} | {metric} | " + " | ".join(str(v) for v in vals) + " |"
        )
    return "\n".join(out) + "\n"


def plot_rtf(rows, out_path: str):
    """RTF-vs-multiplier comparison figure (the reference keeps these in
    plots/figures/*.pdf)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return None
    ours = {}
    for r in rows:
        m = r.get("metric", "")
        if m.startswith("streaming_rtf_m") and "int8" not in m:
            mult = int(m.split("_m")[1].split("_")[0])
            ours[mult] = r["value"]
    if not ours:
        return None
    fig, ax = plt.subplots(figsize=(5, 3.2))
    ms = [1, 2, 3, 4]
    ax.plot(ms, BASELINES[("en-de", "rtf")], "o-", label="reference (L40S)")
    xs = sorted(ours)
    ax.plot(xs, [ours[m] for m in xs], "s-", label="ours")
    ax.set_xlabel("latency multiplier m")
    ax.set_ylabel("streaming RTF (lower is better)")
    ax.set_xticks(ms)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path)
    return out_path


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default=".")
    p.add_argument("--out", default="REPORT.md")
    p.add_argument("--figure", default=None, help="optional RTF figure path")
    args = p.parse_args()
    rows = collect(args.dir)
    md = render(rows)
    with open(args.out, "w") as f:
        f.write(md)
    if args.figure:
        out = plot_rtf(rows, args.figure)
        if out:
            print(f"figure -> {out}")
    print(md)


if __name__ == "__main__":
    main()
