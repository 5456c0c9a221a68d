"""Llama-3/3.1 chat template for the streaming transcript and the training
transcript (a copy of ``infinisst_tpu/data/template.py``).

The template is built once per (multiplier, first/later) as a fixed token
layout, so the chunk step sees a closed set of shapes and the speech patch
offset is a constant.

  first chunk:
    <|begin_of_text|><|start_header_id|>system<|end_header_id|>\\n\\n
    {system text, incl. <latency_m>}<|eot_id|>
    <|start_header_id|>user<|end_header_id|>\\n\\n {12m x <sp_patch>} <|eot_id|>
    <|start_header_id|>assistant<|end_header_id|>\\n\\n
  later chunks: the user + assistant part only.

The offline prompt (the AlignAtt agents) is one turn: the system block
without a latency token, the user turn with the speech patches, and the
open assistant turn followed by the target so far.

The training transcript (``build_trajectory_prompt``, the collators'
layout) is the system block and one (user patches, assistant text) turn
pair per trajectory segment, supervised on the assistant text only.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from infinisst_tpu_torch.core.config import SpecialTokens

DEFAULT_SPEECH_PATCH_TOKEN = "<sp_patch>"
DEFAULT_SPEECH_START_TOKEN = "<sp_start>"
DEFAULT_SPEECH_END_TOKEN = "<sp_end>"
DEFAULT_LATENCY_TOKEN = "<latency_{}>"
IGNORE_INDEX = -100


class StubTokenizer:
    """Deterministic hash tokenizer for tests: one id per word."""

    def __init__(self, vocab_size: int = 128263, lo: int = 1000,
                 hi: int = 60000):
        self.vocab_size = vocab_size
        self.lo, self.hi = lo, hi

    def encode(self, text: str) -> List[int]:
        words = text.split()
        if not words and text:
            # pure-whitespace strings (the template's "\n\n") still occupy
            # one token, as in the real Llama tokenizer
            words = [repr(text)]
        out = []
        for w in words:
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            out.append(self.lo + h % (self.hi - self.lo))
        return out

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return " ".join(f"tok{i}" for i in ids)


class HFTokenizerAdapter:
    """Wraps a HF tokenizer (with the 7 extra tokens registered, ref:
    model/llm.py:149-190) behind the minimal interface the agents use."""

    def __init__(self, tok):
        self.tok = tok
        self.vocab_size = len(tok)

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.tok.decode(ids, skip_special_tokens=skip_special_tokens)

    def apply_chat_template(self, messages) -> List[int]:
        return list(
            self.tok.apply_chat_template(
                messages, add_special_tokens=False
            )
        )


def register_special_tokens(tok, model_cfg, max_multiplier: int = 4):
    """Register the 7 extra tokens on a HF tokenizer and check that their
    ids line up with the model config (the reference's preprocess(),
    model/llm.py:149-190; the ids follow the base vocabulary: sp_patch ==
    128256)."""
    tok.add_tokens(
        [
            DEFAULT_SPEECH_PATCH_TOKEN,
            DEFAULT_SPEECH_START_TOKEN,
            DEFAULT_SPEECH_END_TOKEN,
        ]
        + [DEFAULT_LATENCY_TOKEN.format(i) for i in range(1, max_multiplier + 1)],
        special_tokens=True,
    )
    tok.pad_token = "<|finetune_right_pad_id|>"
    t = model_cfg.tokens
    got = tok.convert_tokens_to_ids(
        [
            DEFAULT_SPEECH_PATCH_TOKEN,
            DEFAULT_SPEECH_START_TOKEN,
            DEFAULT_SPEECH_END_TOKEN,
        ]
    )
    expect = [t.sp_patch, t.sp_start, t.sp_end]
    assert got == expect, (
        f"added-token ids {got} do not match the model config {expect}; "
        "check the tokenizer matches the released checkpoints"
    )
    assert len(tok) <= model_cfg.llama.vocab_size, (
        len(tok), model_cfg.llama.vocab_size,
    )
    return tok


@dataclass
class ChunkPrompt:
    ids: np.ndarray  # (S,) int32
    patch_start: int  # index of the first <sp_patch>
    n_patches: int


class PromptBuilder:
    def __init__(
        self,
        tokenizer,
        tokens: SpecialTokens,
        source_lang: str = "English",
        target_lang: str = "German",
        llama31: bool = True,
        use_hf_template: Optional[bool] = None,
    ):
        self.tokenizer = tokenizer
        self.t = tokens
        self.source_lang = source_lang
        self.target_lang = target_lang
        self.llama31 = llama31
        if use_hf_template is None:
            use_hf_template = hasattr(tokenizer, "apply_chat_template")
        self.use_hf_template = use_hf_template

    def system_text(self, multiplier: int) -> str:
        lat = DEFAULT_LATENCY_TOKEN.format(multiplier)
        return (
            f"Translate the following speech from {self.source_lang} to "
            f"{self.target_lang} with latency {lat}."
        )

    def offline_system_text(self) -> str:
        """The offline (AlignAtt) system text: no latency token."""
        return (
            f"Translate the following speech from {self.source_lang} to "
            f"{self.target_lang}."
        )

    def _sys_text_ids(self, text: str) -> List[int]:
        """Tokenize the system text whole; if the tokenizer does not know
        the latency token, encode each side of it whole and splice its id."""
        t = self.t
        ids = list(self.tokenizer.encode(text))
        m_all = re.findall(r"<latency_(\d+)>", text)
        valid = [g for g in m_all if 1 <= int(g) <= len(t.latency)]
        knows_latency = valid and all(
            list(self.tokenizer.encode(f"<latency_{g}>"))
            == [t.latency[int(g) - 1]]
            for g in valid
        )
        if knows_latency or not valid:
            return ids
        out: List[int] = []
        for part in re.split(r"(<latency_\d+>)", text):
            m = re.fullmatch(r"<latency_(\d+)>", part)
            if m and 1 <= int(m.group(1)) <= len(t.latency):
                out.append(t.latency[int(m.group(1)) - 1])
            elif part:
                out.extend(self.tokenizer.encode(part))
        return out

    def system_ids(self, text: str) -> np.ndarray:
        """<|begin_of_text|> + system block."""
        if self.use_hf_template:
            ids = self.tokenizer.apply_chat_template(
                [{"role": "system", "content": text}]
            )
            return np.asarray(ids, np.int32)
        t = self.t
        ids = (
            [t.bos, t.start_header]
            + self.tokenizer.encode("system")
            + [t.end_header]
            + self.tokenizer.encode("\n\n")
            + self._sys_text_ids(text)
            + [t.eot]
        )
        return np.asarray(ids, np.int32)

    def _turn_ids(self, n_patches: int) -> List[int]:
        """user turn with n speech patches + open assistant header."""
        t = self.t
        nl2 = self.tokenizer.encode("\n\n")
        return (
            [t.start_header, t.user, t.end_header]
            + nl2
            + [t.sp_patch] * n_patches
            + [t.eot, t.start_header, t.assistant, t.end_header]
            + nl2
        )

    def chunk_prompt(self, multiplier: int, first: bool,
                     n_patches: Optional[int] = None) -> ChunkPrompt:
        """Prompt ids for one streaming chunk; n_patches defaults to 12*m."""
        if n_patches is None:
            n_patches = 12 * multiplier
        t = self.t
        if self.use_hf_template:
            sys_text = self.system_text(multiplier)
            messages = [
                {"role": "system", "content": sys_text},
                {"role": "user",
                 "content": DEFAULT_SPEECH_PATCH_TOKEN * n_patches},
                {"role": "assistant", "content": ""},
            ]
            ids = self.tokenizer.apply_chat_template(messages)[:-1]
            if not first:
                sys_len = len(self.system_ids(sys_text))
                ids = ids[sys_len:] if self.llama31 else [t.eos] + ids[sys_len:]
            ids = np.asarray(ids, np.int32)
            patch_pos = np.where(ids == t.sp_patch)[0]
            assert len(patch_pos) == n_patches, (len(patch_pos), n_patches)
            return ChunkPrompt(ids=ids, patch_start=int(patch_pos[0]),
                               n_patches=n_patches)
        nl2 = self.tokenizer.encode("\n\n")
        header = [t.start_header, t.user, t.end_header] + nl2
        if first:
            sys_ids = list(self.system_ids(self.system_text(multiplier)))
            ids = sys_ids + self._turn_ids(n_patches)
            patch_start = len(sys_ids) + len(header)
        else:
            ids = self._turn_ids(n_patches)
            patch_start = len(header)
            if not self.llama31:
                # llama-3-8B-instruct: a leading eos in place of bos
                ids = [t.eos] + ids
                patch_start += 1
        return ChunkPrompt(ids=np.asarray(ids, np.int32),
                           patch_start=patch_start, n_patches=n_patches)

    def offline_prompt(self, n_patches: int,
                       target_ids: Sequence[int]) -> ChunkPrompt:
        """Single-turn offline prompt with the target so far as the
        assistant's prefix."""
        sys_ids = list(self.system_ids(self.offline_system_text()))
        ids = sys_ids + self._turn_ids(n_patches) + list(target_ids)
        patch_start = len(sys_ids) + 3 + len(self.tokenizer.encode("\n\n"))
        return ChunkPrompt(ids=np.asarray(ids, np.int32),
                           patch_start=patch_start, n_patches=n_patches)

    def system_prompt_size(self, multiplier: int) -> int:
        return len(self.system_ids(self.system_text(multiplier)))


def build_trajectory_prompt(
    builder: PromptBuilder,
    trajectory: List,
    n_speech_tokens: int,
    multiplier: int,
    latency_token: bool = True,
):
    """Training-side multi-turn transcript of one sample: the system block,
    then one (user patches, assistant text) turn pair per trajectory
    segment.  Returns (ids, labels), int32, with labels IGNORE_INDEX
    outside the assistant spans.

    A ``trajectory`` entry may be a (text, keep) pair; a segment with
    keep=False has its labels masked (the perturbation modes)."""
    t = builder.t
    seg = 12 * multiplier
    ids: List[int] = list(
        builder.system_ids(
            builder.system_text(multiplier)
            if latency_token
            else builder.offline_system_text()
        )
    )
    labels: List[int] = [IGNORE_INDEX] * len(ids)
    nl2 = builder.tokenizer.encode("\n\n")
    for j, entry in enumerate(trajectory):
        if isinstance(entry, (list, tuple)):
            text, keep = entry[0], entry[1]
        else:
            text, keep = entry, True
        n_sp = min(seg, n_speech_tokens - j * seg)
        assert n_sp > 0, "trajectory longer than speech"
        turn = (
            [t.start_header, t.user, t.end_header]
            + nl2
            + [t.sp_patch] * n_sp
            + [t.eot, t.start_header, t.assistant, t.end_header]
            + nl2
        )
        ids.extend(turn)
        labels.extend([IGNORE_INDEX] * len(turn))
        text_ids = builder.tokenizer.encode(text) if text else []
        ids.extend(text_ids + [t.eot])
        if keep:
            labels.extend(text_ids + [t.eot])
        else:
            labels.extend([IGNORE_INDEX] * (len(text_ids) + 1))
    return np.asarray(ids, np.int32), np.asarray(labels, np.int32)
