"""Latency metrics for simultaneous translation (a copy of
``infinisst_tpu/eval/latency.py``).

Implements (Length-Adaptive) Average Lagging and its computation-aware
variant as scored by SimulEval on the reference's outputs
(BASELINE.md; ref: scripts/infer/infinisst.sh --quality-metrics/
--eval-latency-unit), plus the StreamLAAL resegmentation wrapper for
unbounded streams (one delay per reference segment via monotonic alignment
of the hypothesis stream to reference segment lengths).

Delays are recorded per emitted target unit (word for non-zh, char for zh):
``d_i`` = milliseconds of source audio consumed when the unit was emitted;
computation-aware delays add wall-clock compute time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence


@dataclass
class Emission:
    """One WriteAction: text + source-consumed ms (+ CA ms)."""

    text: str
    delay_ms: float
    ca_delay_ms: float


@dataclass
class InstanceLog:
    emissions: List[Emission] = field(default_factory=list)
    source_duration_ms: float = 0.0

    def units(self, unit: str = "word"):
        out = []
        for e in self.emissions:
            toks = list(e.text) if unit == "char" else e.text.split()
            out.extend((t, e.delay_ms, e.ca_delay_ms) for t in toks)
        return out


def average_lagging(
    delays: Sequence[float],
    source_ms: float,
    n_ref_units: int,
    length_adaptive: bool = True,
) -> float:
    """AL / LAAL over one instance.

    AL  = 1/tau * sum_i (d_i - (i-1) * T/|Y*|)
    LAAL uses max(|Y|, |Y*|) in the denominator (length-adaptive), which
    avoids rewarding over-generation.
    tau = first index with d_i >= T (all source consumed), inclusive.
    """
    n = len(delays)
    if n == 0:
        return 0.0
    denom_len = max(n, n_ref_units) if length_adaptive else n_ref_units
    denom_len = max(denom_len, 1)
    gamma = source_ms / denom_len
    tau = n
    for i, d in enumerate(delays):
        if d >= source_ms:
            tau = i + 1
            break
    s = 0.0
    for i in range(tau):
        s += delays[i] - i * gamma
    return s / tau


def _mwer_segment_bounds(
    hyp_units: Sequence[str], ref_segments: Sequence[str], unit: str
) -> list:
    """mwerSegmenter-style resegmentation: split the hypothesis word stream
    into |ref| contiguous segments minimising the summed word edit distance
    to each reference segment (Matusov et al.'s segmenter, which SimulEval's
    StreamLAAL protocol uses).  DP over (segment, boundary).  Returns
    exclusive end indices per segment."""
    refs = [
        list(r) if unit == "char" else r.split() for r in ref_segments
    ]
    H, R = len(hyp_units), len(refs)

    def edit(h_lo, h_hi, ref):
        h = hyp_units[h_lo:h_hi]
        prev = list(range(len(h) + 1))
        for j, rw in enumerate(ref, 1):
            cur = [j] + [0] * len(h)
            for i, hw in enumerate(h, 1):
                cur[i] = min(
                    prev[i] + 1, cur[i - 1] + 1,
                    prev[i - 1] + (0 if hw == rw else 1),
                )
            prev = cur
        return prev[len(h)]

    INF = float("inf")
    # dp[r][b] = min cost of assigning hyp[:b] to refs[:r]
    dp = [[INF] * (H + 1) for _ in range(R + 1)]
    back = [[0] * (H + 1) for _ in range(R + 1)]
    dp[0][0] = 0.0
    for r in range(1, R + 1):
        for b in range(H + 1):
            best, arg = INF, 0
            for a in range(b + 1):
                if dp[r - 1][a] == INF:
                    continue
                c = dp[r - 1][a] + edit(a, b, refs[r - 1])
                if c < best:
                    best, arg = c, a
            dp[r][b] = best
            back[r][b] = arg
    bounds = [0] * R
    b = H
    for r in range(R, 0, -1):
        bounds[r - 1] = b
        b = back[r][b]
    return bounds


def stream_laal(
    log: InstanceLog,
    ref_segments: Sequence[str],
    unit: str = "word",
    computation_aware: bool = False,
    max_dp_units: int = 4000,
    seg_times: Sequence = None,
) -> float:
    """StreamLAAL: resegment the continuous hypothesis stream against the
    reference segments (mwerSegmenter-style minimum-edit-distance DP, with
    a proportional-split fallback for very long streams), then average LAAL
    over segments — the StreamAtt/StreamLAAL protocol for scoring
    long-form streams segment by segment.

    ``seg_times``: per-reference-segment (start_ms, duration_ms) from the
    manifest (MuST-C utterances have very unequal durations — offsets are
    in the TSV, emitted by prepare_simuleval_inputs.py as the ``.timing``
    file).  Without it, segments are assumed to split the source equally —
    only adequate for synthetic streams."""
    units = log.units(unit)
    if not units:
        return 0.0
    ref_lens = [
        max(1, len(list(r)) if unit == "char" else len(r.split()))
        for r in ref_segments
    ]
    total_ref = sum(ref_lens)
    n = len(units)
    bounds = None
    # native C++ DP first (exact for short streams, banded for long ones)
    try:
        from infinisst_tpu_torch.native import mwer_segment_native

        vocab: dict = {}

        def intern(w):
            return vocab.setdefault(w, len(vocab))

        hyp_ids = [intern(u[0]) for u in units]
        ref_ids = [
            [intern(w) for w in (list(r) if unit == "char" else r.split())]
            for r in ref_segments
        ]
        band = 0 if n * len(ref_segments) <= max_dp_units * 40 else 200
        bounds = mwer_segment_native(hyp_ids, ref_ids, band=band)
    except Exception:
        bounds = None
    if bounds is None and n * len(ref_segments) <= max_dp_units * 40:
        bounds = _mwer_segment_bounds(
            [u[0] for u in units], ref_segments, unit
        )
    if bounds is None:  # proportional monotonic fallback
        bounds = []
        acc = 0
        for rl in ref_lens:
            acc += rl
            bounds.append(round(n * acc / total_ref))
    eq_ms = log.source_duration_ms / max(len(ref_segments), 1)
    scores = []
    start = 0
    for seg_idx, end in enumerate(bounds):
        seg_units = units[start:end]
        if seg_units:
            # delays relative to this segment's start time in the stream
            if seg_times is not None:
                t0, seg_ms = seg_times[seg_idx]
                seg_ms = max(float(seg_ms), 1e-9)
            else:
                t0, seg_ms = seg_idx * eq_ms, eq_ms
            delays = [
                (u[2] if computation_aware else u[1]) - t0 for u in seg_units
            ]
            scores.append(
                average_lagging(delays, seg_ms, ref_lens[seg_idx])
            )
        start = end
    return float(sum(scores) / len(scores)) if scores else 0.0


def rtf(total_compute_s: float, source_duration_s: float) -> float:
    """Real-time factor: compute seconds per second of audio
    (ref measures with synchronized_timer, agents/infinisst.py:37-48)."""
    return total_compute_s / max(source_duration_s, 1e-9)
