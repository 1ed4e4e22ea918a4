"""Datalists, concatenation, collation and the evaluation loader
(counterpart of ``esr_tpu/data/loader.py``).

The evaluation loader is synchronous: batch 1, in order, non-overlapping
sequences. The prefetch thread and the lane-packed engine feed wait for the
streaming-engine slice.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np

from esr_tpu_torch.data.dataset import SequenceDataset


def read_datalist(path: str) -> List[str]:
    """Datalist txt -> recording paths (one per line, '#' comments ok)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line)
    return out


class ConcatSequenceDataset:
    """Concatenation of per-recording :class:`SequenceDataset`s."""

    def __init__(self, recordings: Sequence, config: Dict):
        self.datasets = [SequenceDataset(r, config) for r in recordings]
        if not self.datasets:
            raise ValueError("empty datalist")
        lengths = {d.L for d in self.datasets}
        if len(lengths) > 1:
            raise ValueError(
                f"inconsistent sequence lengths {sorted(lengths)}: some "
                "recordings are too short for sequence_length="
                f"{config['sequence']['sequence_length']}"
            )
        self.cumlen = np.cumsum([len(d) for d in self.datasets])
        self.inp_resolution = self.datasets[0].inp_resolution
        self.gt_resolution = self.datasets[0].gt_resolution

    def __len__(self) -> int:
        return int(self.cumlen[-1])

    def get_item(self, index: int):
        d = int(np.searchsorted(self.cumlen, index, side="right"))
        local = index - (self.cumlen[d - 1] if d else 0)
        return self.datasets[d].get_item(int(local))


def collate_sequences(
    sequences: List[List[Dict[str, np.ndarray]]],
) -> Dict[str, np.ndarray]:
    """[B sequences of L item-dicts] -> {key: (B, L, ...)} float32 batch."""
    keys = sequences[0][0].keys()
    return {
        k: np.stack([np.stack([item[k] for item in seq]) for seq in sequences])
        for k in keys
    }


class InferenceSequenceLoader:
    """Streams ONE recording for evaluation: ``{key: (1, L, ...)}`` batches,
    in order; the caller carries the recurrent state across them."""

    def __init__(self, recording, config: Dict):
        self.dataset = ConcatSequenceDataset([recording], config)
        self.inp_resolution = self.dataset.inp_resolution
        self.gt_resolution = self.dataset.gt_resolution

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self.dataset)):
            yield collate_sequences([self.dataset.get_item(i)])
