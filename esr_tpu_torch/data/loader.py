"""Datalists, concatenation, collation, the training loader and the
evaluation loader (counterpart of ``esr_tpu/data/loader.py``).

:class:`SequenceLoader` is the training loader: :class:`ShardedSampler`'s
epoch shuffle (``np.random.default_rng((seed, epoch))``), one derived
augmentation seed per sequence, and batches built in order by a thread pool
``prefetch`` deep. Process workers (``num_workers > 0``) are not ported.
The evaluation loader is synchronous: batch 1, in order, non-overlapping
sequences. The lane-packed engine feed waits for the streaming-engine
slice.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

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

    def get_item(self, index: int, seed: Optional[int] = None):
        d = int(np.searchsorted(self.cumlen, index, side="right"))
        local = index - (self.cumlen[d - 1] if d else 0)
        return self.datasets[d].get_item(int(local), seed=seed)


class ShardedSampler:
    """The reference's sampler at one shard (data parallelism is not
    ported): the (optionally shuffled) indices are cut to (``drop_last``)
    or wrap-padded to a multiple of ``batch_size`` and dealt in batches."""

    def __init__(self, num_items: int, batch_size: int, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0):
        self.num_items = num_items
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = np.arange(self.num_items)
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        batch = self.batch_size
        if self.drop_last:
            idx = idx[: (len(idx) // batch) * batch]
        elif len(idx) % batch:
            # np.resize tiles, so this also covers num_items < batch_size
            idx = np.resize(idx, -(-len(idx) // batch) * batch)
        yield from idx.reshape(-1, batch)

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_items // self.batch_size
        return -(-self.num_items // self.batch_size)


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


class SequenceLoader:
    """Collated ``{key: (B, L, ...)}`` training batches with epoch semantics.

    Batches come in the sampler's order; ``prefetch`` > 0 builds that many
    ahead on a thread pool (the consumer still receives them in order).
    """

    def __init__(self, dataset: ConcatSequenceDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 prefetch: int = 2, num_workers: int = 0):
        if num_workers > 0:
            raise NotImplementedError(
                "num_workers > 0 (process workers) is not ported; set the "
                "loader's num_workers to 0")
        self.dataset = dataset
        self.sampler = ShardedSampler(len(dataset), batch_size, shuffle, drop_last, seed)
        self.prefetch = prefetch
        self.seed = seed
        self.inp_resolution = dataset.inp_resolution
        self.gt_resolution = dataset.gt_resolution

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler)

    def _seeds(self, indices: np.ndarray) -> List[int]:
        """One derived augmentation seed per sequence."""
        epoch = self.sampler.epoch
        return [int(np.random.default_rng((self.seed, epoch, int(i))).integers(2**31))
                for i in indices]

    def _build(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return collate_sequences([self.dataset.get_item(int(i), seed=s)
                                  for i, s in zip(indices, self._seeds(indices))])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = list(self.sampler)
        if self.prefetch <= 0:
            for idx in batches:
                yield self._build(idx)
            return
        with ThreadPoolExecutor(max_workers=self.prefetch) as pool:
            pending: deque = deque()
            try:
                for idx in batches:
                    pending.append(pool.submit(self._build, idx))
                    if len(pending) >= self.prefetch:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for fut in pending:
                    fut.cancel()
