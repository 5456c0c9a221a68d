"""Remove speaker tags ("NAME: ...") from transcripts.

Behavioural mirror of preprocess/remove_speakers.py with the reference's
decision rules (:77, :150-155):

- tag detection anywhere in the source via the reference's name regex —
  a known-names alternation (Audience/Narrator/Video/...), capitalised
  full names ("Firstname Lastname:"), and 1-3 letter initials ("CA:");
- the target tag is the prefix before ':' or the zh full-width colon '：'
  (empty when neither occurs);
- a source tag matching the number-word/LG SUBSTRING search (One..Ten,
  LG — unanchored, so e.g. "Tenzin:" matches "Ten") is skipped by the
  correction pass and therefore DROPPED with the other uncorrected
  tagged rows (the reference's exact, quirky behaviour — its `continue`
  at :150 excludes the row from the next round's sample set);
- a sample is CORRECTED (tag stripped from both sides) only when both
  tags are non-empty, the source tag is <= 3 words, and the target tag is
  short (<= 3 units; characters for zh, words otherwise) OR similar to
  the source tag (LaBSE cosine > 0.5 in the reference;
  sentence-transformers is optional here with a character-overlap
  fallback);
- everything else carrying a tag is DROPPED;
- iterate to fixpoint (corrected samples may expose another tag).

Writes *_nospeaker.tsv.
"""

from __future__ import annotations

import argparse
import re
from typing import Callable, Dict, List, Tuple

from infinisst_tpu_torch.tools.preprocess.utils import read_tsv, write_tsv

# ref preprocess/remove_speakers.py:77
KNOWN_NAMES = (
    "Audience|Narrator|Video|Man|Woman|Bono|Voice|Announcer|Rives|"
    "George W\\. Bush|Broadcasting|Boy|Professor|Engineer|Interviewer|"
    "Shereen El-Feki|Tina|Girl|Dad|Voice"
)
NAME_RE = re.compile(
    r"\b(?<!\")(" + KNOWN_NAMES + r"):"
    r"|[A-Z][a-z]+(?:\s[A-Z][a-z]+)*:"
    r"|[A-Z]{1,3}:"
)
# ref :150 — number words and LG are regex false positives, never tags
FALSE_POSITIVE_RE = re.compile(
    r"One|Two|Three|Four|Five|Six|Seven|Eight|Nine|Ten|LG"
)


def _similarity_fn() -> Callable[[str, str], float]:
    try:  # pragma: no cover - optional dep
        from sentence_transformers import SentenceTransformer

        model = SentenceTransformer("sentence-transformers/LaBSE")

        def sim(a: str, b: str) -> float:
            import numpy as np

            ea, eb = model.encode([a, b])
            return float(
                np.dot(ea, eb)
                / (np.linalg.norm(ea) * np.linalg.norm(eb) + 1e-8)
            )

        return sim
    except Exception:

        def sim(a: str, b: str) -> float:
            sa, sb = set(a.lower().split()), set(b.lower().split())
            if not sa or not sb:
                return 0.0
            return len(sa & sb) / max(len(sa), len(sb))

        return sim


def find_tag(src: str) -> bool:
    """Does the source text carry a speaker tag (ref name regex)?"""
    return NAME_RE.search(src) is not None


def split_tags(src: str, tgt: str) -> Tuple[str, str]:
    """The reference's tag extraction: source prefix before ':', target
    prefix before ':' or '：' (else empty)."""
    src_tag = src[: src.find(":")] if ":" in src else src
    if ":" in tgt:
        tgt_tag = tgt[: tgt.find(":")]
    elif "：" in tgt:
        tgt_tag = tgt[: tgt.find("：")]
    else:
        tgt_tag = ""
    return src_tag, tgt_tag


def strip_speakers(
    rows: List[Dict],
    lang: str = "de",
    sim_threshold: float = 0.5,
    max_iters: int = 10,
):
    """Apply the reference's iterate-to-fixpoint protocol.  Returns
    (kept_rows, n_stripped, n_dropped)."""
    sim = _similarity_fn()
    samples = [dict(r) for r in rows]
    n_stripped = 0
    for _ in range(max_iters):
        cleaned, tagged = [], []
        for s in samples:
            (tagged if find_tag(s.get("src_text", "")) else cleaned).append(s)
        if not tagged:
            break
        corrected = []
        for s in tagged:
            src, tgt = s.get("src_text", ""), s.get("tgt_text", "")
            src_tag, tgt_tag = split_tags(src, tgt)
            if FALSE_POSITIVE_RE.search(src_tag):
                # number-word/LG false positive: keep untouched (the
                # reference's `continue` drops it from correction AND from
                # cleaned — i.e. removes the sample; we mirror that)
                continue
            src_len = len(src_tag.split(" "))
            tgt_len = len(tgt_tag) if lang == "zh" else len(tgt_tag.split(" "))
            if (
                src_tag != ""
                and tgt_tag != ""
                and src_len <= 3
                and (tgt_len <= 3 or sim(src_tag, tgt_tag) > sim_threshold)
            ):
                s = dict(s)
                s["src_text"] = src[len(src_tag) + 1:].strip()
                s["tgt_text"] = tgt[len(tgt_tag) + 1:].strip()
                corrected.append(s)
                n_stripped += 1
            # else: dropped
        samples = cleaned + corrected
    n_dropped = len(rows) - len(samples)
    return samples, n_stripped, n_dropped


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tsv", required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--lang", default="de")
    args = p.parse_args(argv)
    rows = read_tsv(args.tsv)
    kept, n_stripped, n_dropped = strip_speakers(rows, lang=args.lang)
    out = args.output or args.tsv.replace(".tsv", "_nospeaker.tsv")
    write_tsv(out, kept)
    print(
        f"{len(kept)} rows kept ({n_stripped} tags stripped, "
        f"{n_dropped} dropped) -> {out}"
    )


if __name__ == "__main__":
    main()
