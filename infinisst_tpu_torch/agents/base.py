"""Agent infrastructure: read/write actions and streaming states (a copy of
``infinisst_tpu/agents/base.py`` without the optional SimulEval adapter).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ReadAction:
    def is_read(self) -> bool:
        return True


@dataclass
class WriteAction:
    content: str
    finished: bool = False

    def is_read(self) -> bool:
        return False


@dataclass
class AgentStates:
    """Host-side stream state; device caches live on the agent."""

    source: List[float] = field(default_factory=list)
    source_sample_rate: int = 0
    source_finished: bool = False
    target: List[str] = field(default_factory=list)
    target_ids: List[int] = field(default_factory=list)
    src_len: int = 0  # samples already consumed
    segment_idx: int = 0
    translations_list: List[str] = field(default_factory=list)

    def reset(self):
        self.__init__()


class SpeechToTextAgent:
    """Base class: subclasses implement policy(states) -> Action."""

    def __init__(self):
        self.states = self.build_states()

    def build_states(self) -> AgentStates:
        return AgentStates()

    def reset(self):
        self.states.reset()

    def policy(self, states: Optional[AgentStates] = None):
        raise NotImplementedError

    def push(self, samples, sample_rate: int = 16000, finished: bool = False):
        """Feed a segment of audio and run the policy once."""
        ext = samples.tolist() if hasattr(samples, "tolist") else list(samples)
        self.states.source.extend(ext)
        self.states.source_sample_rate = sample_rate
        self.states.source_finished = finished
        return self.policy(self.states)


def make_simuleval_agent(agent_cls, args):
    """Wrap one of the port's agents as a SimulEval ``SpeechToTextAgent``
    if ``simuleval`` imports (an optional dependency): its policy copies
    SimulEval's source into the agent's states and maps the agent's Read
    and Write to SimulEval's actions."""
    try:
        from simuleval.agents import SpeechToTextAgent as SimulAgent
        from simuleval.agents.actions import (
            ReadAction as SimulRead,
            WriteAction as SimulWrite,
        )
    except ImportError as e:
        raise RuntimeError(
            "simuleval is not installed; use the built-in eval harness "
            "(infinisst_tpu_torch.eval.runner) instead"
        ) from e

    inner = agent_cls(args)

    class Wrapped(SimulAgent):
        def policy(self, states=None):
            st = states if states is not None else self.states
            inner.states.source = list(st.source)
            inner.states.source_sample_rate = st.source_sample_rate
            inner.states.source_finished = st.source_finished
            act = inner.policy(inner.states)
            if act.is_read():
                return SimulRead()
            return SimulWrite(content=act.content, finished=act.finished)

    return Wrapped
