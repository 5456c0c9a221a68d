"""StreamAtt agent: AlignAtt with text and speech history pruning for
unbounded streams; port of ``infinisst_tpu/agents/streamatt.py``.

After each AlignAtt policy call the target history keeps its last
``text_preserve_num`` words (a word starts at a token that decodes with a
leading space; every token is a word for Chinese), and the audio history
is cut at the earliest most-attended sample of the preserved text, but
keeps at least ``min_speech_duration`` seconds, and at most
``max_speech_duration``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from infinisst_tpu_torch.agents.alignatt import (
    AlignAttAgent,
    AlignAttOptions,
    AlignAttStates,
)


@dataclass
class StreamAttOptions(AlignAttOptions):
    text_preserve_num: int = 40
    min_speech_duration: float = 10.0
    max_speech_duration: float = 28.8


class StreamAttAgent(AlignAttAgent):
    def policy(self, states: Optional[AlignAttStates] = None):
        if states is None:
            states = self.states
        opts: StreamAttOptions = self.opts

        action = super().policy(states)

        if not states.source_finished:
            if opts.text_preserve_num != -1:
                n_words = opts.text_preserve_num
                preserved = []
                for idx in states.target_ids[::-1]:
                    preserved.append(idx)
                    if (opts.target_lang == "Chinese"
                            or self.tokenizer.decode([idx]).startswith(" ")):
                        n_words -= 1
                        if n_words == 0:
                            break
                preserved = preserved[::-1]
                while "�" in self.tokenizer.decode(preserved):
                    preserved.pop(0)
                states.target_ids = preserved

                if states.target_ids and states.most_attended_indices:
                    attended = states.most_attended_indices[
                        -len(states.target_ids):]
                    src_idx = min(
                        int(min(attended)),
                        max(0, len(states.source)
                            - int(opts.min_speech_duration * 16000)),
                    )
                    states.source = states.source[src_idx:]

            states.source = states.source[
                -int(opts.max_speech_duration * 16000):]
            states.src_len = len(states.source)

        return action
