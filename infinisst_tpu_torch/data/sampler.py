"""Token-budget batch sampler with rank-strided distributed iteration (a
copy of ``infinisst_tpu/data/sampler.py``; numpy only).

Mirror of SpeechSampler (ref: train/dataset.py:216-276): effective sample
size = per-chunk chat headers (5 tokens x 2) + 12 speech tokens per chunk +
target text tokens + 39-token beginning prompt; samples are sorted by size
and greedily packed so max_size * n_items <= budget, capped at
``batch_size_sent`` sentences; the batch count is rounded down to a
multiple of ``multiplier`` (n_device * grad_acc, ref main.py usage); each
rank iterates its stride (ref :265).
"""

from __future__ import annotations

from typing import Callable, Iterator, List

import numpy as np

SP_SEG_FRAME = int(12 * 0.08 * 16000)  # 960 ms in samples


class SpeechSampler:
    def __init__(
        self,
        dataset,
        shuffle: bool,
        batch_size: int,
        batch_size_sent: int = 30,
        min_ms: float = 0,
        multiplier: int = 1,
        filter: bool = True,
        tokenizer: Callable[[str], List[int]] = None,
        rank: int = 0,
        num_replicas: int = 1,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.shuffle = shuffle
        self.batch_size = batch_size
        self.batch_size_sent = batch_size_sent
        self.rank = rank
        self.num_replicas = num_replicas
        self.seed = seed
        self.epoch = 0
        self._obtain_batches(min_ms, multiplier, filter, tokenizer)

    def _obtain_batches(self, min_ms, multiplier, filter, tokenizer):
        eff_sizes = []
        for idx in range(len(self.dataset)):
            n_seg = (
                self.dataset.n_frames[idx] + SP_SEG_FRAME - 1
            ) // SP_SEG_FRAME
            eff = n_seg * 5 * 2  # chat headers per chunk
            eff += n_seg * 12  # speech tokens
            if tokenizer is not None:
                eff += len(tokenizer(self.dataset.tgt_texts[idx]))
            else:
                eff += len(self.dataset.tgt_texts[idx].split())
            eff += 39  # beginning prompt
            eff_sizes.append((eff, idx))
        eff_sizes.sort()

        batches: List[List[int]] = []
        cur: List[int] = []
        n_skipped = 0
        for eff, idx in eff_sizes:
            if not filter or self.dataset.n_frames[idx] >= min_ms * 16:
                if (
                    eff * (len(cur) + 1) <= self.batch_size
                    and len(cur) < self.batch_size_sent
                ):
                    cur.append(idx)
                else:
                    batches.append(cur)
                    cur = [idx]
            else:
                n_skipped += 1
        assert len(cur) > 0, "batch budget too small for any sample"
        batches.append(cur)

        n_batches = len(batches) // multiplier * multiplier
        self.batch_indices = batches[:n_batches][::-1]
        self.n_skipped = n_skipped

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[List[int]]:
        if self.shuffle:
            g = np.random.RandomState(self.seed + self.epoch)
            order = g.permutation(len(self.batch_indices)).tolist()
        else:
            order = list(range(len(self.batch_indices)))
        order = order[self.rank : len(self) : self.num_replicas]
        for i in order:
            yield self.batch_indices[i]

    def __len__(self) -> int:
        return len(self.batch_indices)
