"""Build chunk-aligned training trajectories from MFA alignments.

Behavioural mirror of preprocess/build_trajectory_full_mfa.py:
1. word-align source -> target (simalign/LaBSE in the reference, :20,66;
   optional here with a monotone proportional fallback), then build the
   cumulative alignment frontier (:73-85);
2. map MFA TextGrid word end-times to source word indices by scanning the
   lowercased source text (:87-126);
3. lay each utterance's trajectory on the TALK step grid: steps start at
   ``offset // 15360 * 15360`` and every 960 ms step emits the target words
   newly covered — '' for steps where no source word finishes (:129-155);
4. re-slice whole talks into <= 30 x 960 ms (28.8 s) windows on the talk
   timeline: window step lists are pre-sized over the full window duration
   so inter-utterance gaps get empty steps, utterances that failed
   alignment truncate the window and are skipped, and windows snap forward
   to the last utterance start when it lies beyond the window head
   (:159-224).  The resulting rows satisfy the collators' validate()
   invariant (trajectory length == speech tokens / segment size) by
   construction.

Chinese targets are tokenized with jieba when available (ref :61), with a
per-character fallback, and trajectory segments join without spaces.

TextGrid parsing is implemented here directly (the reference depends on the
`textgrids` package).
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Dict, List, Optional, Tuple

from infinisst_tpu_torch.tools.preprocess.utils import read_tsv, write_tsv

STEP_S = 0.96
STEP_SAMPLES = 15360  # 0.96 s @ 16 kHz
MAX_WINDOW_STEPS = 30  # 28.8 s / 0.96 s


# ---------------------------------------------------------------------------
# TextGrid parsing (long + short formats, 'words' tier)


def parse_textgrid_words(path: str) -> List[Tuple[float, float, str]]:
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    # find the 'words' tier
    out = []
    tiers = re.split(r'item\s*\[\d+\]\s*:', text)
    for tier in tiers:
        if '"words"' not in tier.split("\n", 5)[0:5].__str__() and '"words"' not in tier[:200]:
            continue
        intervals = re.findall(
            r'xmin\s*=\s*([\d.]+)\s*\n\s*xmax\s*=\s*([\d.]+)\s*\n\s*'
            r'text\s*=\s*"([^"]*)"',
            tier,
        )
        for xmin, xmax, word in intervals:
            w = word.strip()
            if w:
                out.append((float(xmin), float(xmax), w))
        if out:
            break
    return out


# ---------------------------------------------------------------------------
# Target tokenization


def tokenize_target(text: str, lang: str) -> List[str]:
    """Whitespace for non-zh; jieba for zh (ref :61) with a per-character
    fallback when jieba is unavailable."""
    if lang != "zh":
        return text.split()
    try:  # pragma: no cover - optional dep
        import jieba

        return [w for w in jieba.cut(text) if w.strip()]
    except Exception:
        return [c for c in text if not c.isspace()]


# ---------------------------------------------------------------------------
# Word alignment


def monotone_align(n_src: int, n_tgt: int) -> List[Tuple[int, int]]:
    """Proportional monotone fallback when simalign is unavailable."""
    return [
        (i, min(n_tgt - 1, round(i * n_tgt / max(n_src, 1))))
        for i in range(n_src)
    ]


def align_words(
    src_words: List[str], tgt_words: List[str]
) -> List[Tuple[int, int]]:
    """Raw word-alignment pairs (simalign LaBSE in the reference, :20,66;
    proportional monotone fallback here)."""
    try:  # pragma: no cover - optional dep
        from simalign import SentenceAligner

        aligner = align_words._aligner
        if aligner is None:
            aligner = SentenceAligner(
                model="LaBSE", token_type="word", matching_methods="i"
            )
            align_words._aligner = aligner
        res = aligner.get_word_aligns(src_words, tgt_words)
        return sorted(res["itermax"])
    except Exception:
        return monotone_align(len(src_words), len(tgt_words))


align_words._aligner = None


def alignment_frontier(
    pairs: List[Tuple[int, int]], n_src: int, n_tgt: int
) -> List[Tuple[int, int]]:
    """The reference's cumulative alignment frontier (:73-85): sort by
    (tgt, src), force the final pair, collapse per target index keeping the
    last source, make source indices non-decreasing, prepend the (-1, -1)
    sentinel.  Walking this list with a source frontier k yields the target
    span newly covered."""
    a = sorted(pairs, key=lambda x: (x[1], x[0]))
    a.append((n_src - 1, n_tgt - 1))
    r: List[Tuple[int, int]] = []
    for s, t in a:
        if r and r[-1][1] == t:
            r[-1] = (s, t)
        else:
            r.append((s, t))
    for i in range(1, len(r)):
        r[i] = (max(r[i][0], r[i - 1][0]), r[i][1])
    return [(-1, -1)] + r


def map_words_to_src(
    words_timed: List[Tuple[float, float, str]], src_words: List[str]
) -> Optional[List[Tuple[float, int]]]:
    """Map TextGrid word end-times to source word indices by scanning the
    lowercased source text left-to-right (ref :87-126; handles MFA
    contraction splits and digit formatting).  Returns (xmax_s, src_idx)
    collapsed per index, or None when a word cannot be located (the
    reference skips such utterances)."""
    text = " ".join(src_words).lower()
    mapping: List[Tuple[float, int]] = []
    p = 0
    for _, xmax, w in words_timed:
        t = w.lower()
        if t in ("(bracketed)", "[bracketed]"):
            continue
        if t == "[laughter]":
            t = "(laughter)"
        if text.find(t, p) == -1 and "'" in t[1:-1]:
            t = t[t.rfind("'") + 1:]
        if text.find(t, p) == -1 and t.isdigit():
            t = f"{int(t):,}"
        j = text.find(t, p)
        if j == -1:
            return None
        p = j + len(t)
        idx = text[:p].count(" ")
        if mapping and mapping[-1][1] == idx:
            mapping[-1] = (xmax, idx)
        else:
            mapping.append((xmax, idx))
    return mapping


def utterance_trajectory(
    words_timed: List[Tuple[float, float, str]],
    src_words: List[str],
    tgt_words: List[str],
    offset: int,
    n_frames: int,
    lang: str = "de",
    align_pairs: Optional[List[Tuple[int, int]]] = None,
):
    """Trajectory of one utterance on the TALK step grid (ref :108-155).

    Returns (offset_rounded, trajectory, src_segments); trajectory is None
    when the TextGrid words cannot be matched to the source text (caller
    treats the utterance as skipped, like the reference)."""
    step = STEP_SAMPLES
    offset_rounded = offset // step * step
    mapping = map_words_to_src(words_timed, src_words)
    if mapping is None or not src_words or not tgt_words:
        return offset_rounded, None, None
    mapping.append((n_frames / 16000.0, len(src_words) - 1))
    if align_pairs is None:
        align_pairs = align_words(src_words, tgt_words)
    frontier = alignment_frontier(align_pairs, len(src_words), len(tgt_words))

    joiner = "" if lang == "zh" else " "
    j = k = -1
    r = 0
    traj: List[str] = []
    src_segments: List[str] = []
    for i in range(offset_rounded, offset + n_frames, step):
        rbound = min(i + step, offset + n_frames) - offset
        while j < len(mapping) - 1 and int(mapping[j + 1][0] * 16000) <= rbound:
            j += 1
        if j >= 0 and int(mapping[j][0] * 16000) > i - offset:
            src_segments.append(" ".join(src_words[k + 1: mapping[j][1] + 1]))
            k = mapping[j][1]
            old_r = r
            while r < len(frontier) - 1 and frontier[r + 1][0] <= k:
                r += 1
            traj.append(
                joiner.join(tgt_words[frontier[old_r][1] + 1: frontier[r][1] + 1])
            )
        else:
            src_segments.append("")
            traj.append("")
    traj[-1] += " "
    return offset_rounded, traj, src_segments


def trajectory_for_utterance(
    src_words_timed: List[Tuple[float, float, str]],
    tgt_words: List[str],
    duration_s: float,
    step_s: float = STEP_S,
    lang: str = "de",
) -> List[str]:
    """Single-utterance convenience wrapper (offset 0)."""
    src_words = [w for _, _, w in src_words_timed]
    _, traj, _ = utterance_trajectory(
        src_words_timed, src_words, tgt_words, 0,
        int(round(duration_s * 16000)), lang=lang,
    )
    return traj if traj is not None else []


# ---------------------------------------------------------------------------
# Talk re-slicing (ref :159-224)


def reslice_talk(
    utterances: List[Dict],
    window_steps: int = MAX_WINDOW_STEPS,
    talk_n_frames: Optional[int] = None,
    lang: str = "de",
) -> List[Dict]:
    """Re-slice a talk's utterance trajectories into <= window_steps x
    960 ms document-level windows on the TALK timeline.

    Each utterance dict needs: path, offset, n_frames, traj_offset (step-
    rounded talk offset), trajectory (list per talk-grid step; None =
    alignment failed -> the window is truncated before it and the next
    window starts past its end), optional src_segments.  Windows pre-size
    their step list over the full duration so inter-utterance gaps become
    empty steps; a window whose last utterance starts beyond the window
    head snaps the next window to that utterance (overlapping samples, as
    in the reference).  Invariant: len(trajectory) == ceil(n_frames/step)
    for every emitted row."""
    step = STEP_SAMPLES
    path = utterances[0]["path"]
    if talk_n_frames is None:
        talk_n_frames = max(u["offset"] + u["n_frames"] for u in utterances)
    max_win = window_steps * step
    out: List[Dict] = []
    offset = 0
    i = -1
    while offset < talk_n_frames:
        duration = min(max_win, talk_n_frames - offset)
        slice_traj = [""] * ((duration + step - 1) // step)
        slice_src = ""
        new_offset = -1
        while (
            i < len(utterances) - 1
            and utterances[i + 1]["traj_offset"] < offset + duration
        ):
            i += 1
            u = utterances[i]
            if u["trajectory"] is None:
                # skipped utterance: truncate the window before it, resume
                # past its end (ref :183-191)
                duration = u["traj_offset"] - offset
                slice_traj = slice_traj[: ((duration + step - 1) // step)]
                end_frame = u["offset"] + u["n_frames"]
                new_offset = end_frame // step * step
                break
            so = u["traj_offset"]
            for j, seg in enumerate(u["trajectory"]):
                if so + j * step - offset < duration:
                    slot = so // step + j - offset // step
                    if slot >= 0:
                        slice_traj[slot] += seg + ("" if lang == "zh" else " ")
                        srcs = u.get("src_segments")
                        if srcs and srcs[j] != "":
                            slice_src += srcs[j] + " "
        if duration > 0 and slice_traj:
            out.append(
                {
                    "audio": f"{path}:{offset}:{duration}",
                    "n_frames": duration,
                    "src_text": slice_src.strip(),
                    "tgt_text": "".join(slice_traj).strip(),
                    "trajectory": repr(slice_traj),
                }
            )
        if new_offset != -1:
            offset = max(new_offset, offset + step)
        elif i >= 0 and utterances[i]["traj_offset"] > offset:
            # snap the next window to the last (window-straddling)
            # utterance and re-consume it (ref :216-221)
            offset = utterances[i]["traj_offset"]
            i -= 1
        else:
            offset += max(duration, step)
    return out


def main(argv=None):  # pragma: no cover - the file-system entry point
    p = argparse.ArgumentParser()
    p.add_argument("--tsv", required=True)
    p.add_argument("--textgrid-dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--lang", default="de")
    p.add_argument("--window-steps", type=int, default=MAX_WINDOW_STEPS)
    p.add_argument("--max-duration", type=float, default=43.2,
                   help="skip utterances longer than this (ref :17)")
    args = p.parse_args(argv)

    rows = read_tsv(args.tsv)
    by_talk: Dict[str, List[Dict]] = {}
    for row in rows:
        path, off, fr = (row["audio"].split(":") + ["0", row["n_frames"]])[:3]
        n_frames = int(row["n_frames"])
        offset = int(off)
        tg = os.path.join(args.textgrid_dir, row["id"] + ".TextGrid")
        src_words = row["src_text"].replace("(Laughing)", "(Laughter)").split()
        tgt_words = tokenize_target(row["tgt_text"], args.lang)
        if (
            os.path.isfile(tg)
            and n_frames / 16000.0 <= args.max_duration
        ):
            words = parse_textgrid_words(tg)
            traj_off, traj, src_segs = utterance_trajectory(
                words, src_words, tgt_words, offset, n_frames, args.lang
            )
        else:
            traj_off, traj, src_segs = (
                offset // STEP_SAMPLES * STEP_SAMPLES, None, None,
            )
        talk = row["id"].rsplit("_", 1)[0]
        by_talk.setdefault(talk, []).append(
            {
                "path": path,
                "offset": offset,
                "n_frames": n_frames,
                "traj_offset": traj_off,
                "trajectory": traj,
                "src_segments": src_segs,
                "id": row["id"],
            }
        )
    out_rows = []
    for talk, utts in by_talk.items():
        utts.sort(key=lambda u: u["traj_offset"])
        for i, doc in enumerate(
            reslice_talk(utts, args.window_steps, lang=args.lang)
        ):
            doc["id"] = f"{talk}_doc{i}"
            out_rows.append(doc)
    write_tsv(
        args.output,
        out_rows,
        fieldnames=["id", "audio", "n_frames", "src_text", "tgt_text", "trajectory"],
    )
    print(f"{len(out_rows)} document samples -> {args.output}")


if __name__ == "__main__":
    main()
