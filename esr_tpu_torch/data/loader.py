"""Datalists, concatenation, collation, the training loader and the
evaluation loader (counterpart of ``esr_tpu/data/loader.py``).

:class:`SequenceLoader` is the training loader: :class:`ShardedSampler`'s
epoch shuffle (``np.random.default_rng((seed, epoch))``), one derived
augmentation seed per sequence, and batches built in order by a thread pool
``prefetch`` deep, or with ``num_workers > 0`` by a pool of that many
spawned processes (each rebuilds the dataset once from the recordings and
the config); the batches and their augmentation seeds are the same either
way.
The evaluation loader is synchronous: batch 1, in order, non-overlapping
sequences. :class:`LanePackedChunks` packs recordings into lanes for the
streaming engine, and :class:`DevicePrefetcher` stages its chunks on a
thread.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from collections import deque
from concurrent.futures import Future, ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import resource_tracker, shared_memory
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from esr_tpu_torch.data.dataset import SequenceDataset
from esr_tpu_torch.data.np_encodings import activity_fraction_np, tile_activity_np
from esr_tpu_torch.data.records import recording_name


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
        self.recordings = list(recordings)
        self.config = config
        self.datasets = [SequenceDataset(r, config) for r in self.recordings]
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


# The dataset of a worker process, built once by _worker_init: recordings
# with open HDF5 handles cannot be sent to a process, their paths can.
_WORKER_DATASET: Optional[ConcatSequenceDataset] = None


def _worker_init(recordings: Sequence, config: Dict) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = ConcatSequenceDataset(recordings, config)


# (key, shape, dtype, byte offset) of each array of a batch in its block
Layout = List[Tuple[str, Tuple[int, ...], str, int]]


def _worker_build(indices: np.ndarray, seeds: List[int]) -> Tuple[str, Layout]:
    """Build a batch into a new shared-memory block and return the block's
    name and layout: through the pool's pipe a B=32 flagship batch (66 MB)
    took longer to pickle, send and unpickle than a worker took to build
    it. The parent copies it out and unlinks the block
    (:func:`_read_shared`); a block whose batch is never read (the parent
    killed first) stays in ``/dev/shm``."""
    batch = collate_sequences([_WORKER_DATASET.get_item(int(i), seed=s)
                               for i, s in zip(indices, seeds)])
    shm = shared_memory.SharedMemory(create=True,
                                     size=max(1, sum(v.nbytes for v in batch.values())))
    try:
        layout: Layout = []
        offset = 0
        for key, v in batch.items():
            np.ndarray(v.shape, v.dtype, buffer=shm.buf, offset=offset)[...] = v
            layout.append((key, v.shape, v.dtype.str, offset))
            offset += v.nbytes
    except BaseException:
        shm.close()
        shm.unlink()
        raise
    # the parent unlinks the block; this process's tracker must not at exit
    resource_tracker.unregister(shm._name, "shared_memory")
    shm.close()
    return shm.name, layout


def _read_shared(result: Tuple[str, Layout]) -> Dict[str, np.ndarray]:
    """The batch in a worker's block, copied out; the block unlinked."""
    name, layout = result
    shm = shared_memory.SharedMemory(name=name)
    try:
        return {key: np.ndarray(shape, np.dtype(dtype), buffer=shm.buf, offset=off).copy()
                for key, shape, dtype, off in layout}
    finally:
        shm.close()
        shm.unlink()


def _discard_shared(fut: Future) -> None:
    """Unlink the block of a worker's batch that nobody will read."""
    if not fut.cancelled() and fut.exception() is None:
        name, _ = fut.result()
        shm = shared_memory.SharedMemory(name=name)
        shm.close()
        shm.unlink()


class SequenceLoader:
    """Collated ``{key: (B, L, ...)}`` training batches with epoch semantics.

    Batches come in the sampler's order; ``prefetch`` > 0 builds that many
    ahead on a thread pool, ``num_workers`` > 0 at least ``num_workers``
    ahead on a pool of spawned processes (the consumer still receives them
    in order). :meth:`close` shuts the process pool down.
    """

    def __init__(self, dataset: ConcatSequenceDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 prefetch: int = 2, num_workers: int = 0):
        # the stateful hot-pixel filter gathers its statistics across
        # get_item calls: split over workers it would mask other pixels,
        # batch by batch (the reference refuses the pair too)
        if num_workers > 0 and (dataset.config.get("hot_filter") or {}).get("enabled"):
            raise ValueError("num_workers > 0 is incompatible with the stateful hot_filter "
                             "(each worker would gather its own hot-pixel statistics); "
                             "use num_workers=0")
        self.dataset = dataset
        self.sampler = ShardedSampler(len(dataset), batch_size, shuffle, drop_last, seed)
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.seed = seed
        self.inp_resolution = dataset.inp_resolution
        self.gt_resolution = dataset.gt_resolution
        self._pool: Optional[ProcessPoolExecutor] = None

    def _get_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            # spawn: the parent holds a CUDA context and threads, which a
            # forked child must not inherit
            self._pool = ProcessPoolExecutor(
                self.num_workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init,
                initargs=(self.dataset.recordings, self.dataset.config))
        return self._pool

    def close(self) -> None:
        """Shut the worker pool down (nothing to do without workers)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler)

    def _seeds(self, indices: np.ndarray) -> List[int]:
        """One derived augmentation seed per sequence."""
        epoch = self.sampler.epoch
        return [int(np.random.default_rng((self.seed, epoch, int(i))).integers(2**31))
                for i in indices]

    def first_sequence(self, n: int) -> Tuple[int, int]:
        """The dataset index and augmentation seed of the first sequence of
        the current epoch's ``n``-th batch."""
        index = int(list(self.sampler)[n][0])
        return index, self._seeds(np.array([index]))[0]

    def _build(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        return collate_sequences([self.dataset.get_item(int(i), seed=s)
                                  for i, s in zip(indices, self._seeds(indices))])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = list(self.sampler)
        if self.num_workers > 0:
            yield from self._in_order(self._get_pool(), max(self.prefetch, self.num_workers),
                                      batches, lambda pool, idx: pool.submit(
                                          _worker_build, idx, self._seeds(idx)),
                                      read=_read_shared, discard=_discard_shared)
            return
        if self.prefetch <= 0:
            for idx in batches:
                yield self._build(idx)
            return
        with ThreadPoolExecutor(max_workers=self.prefetch) as pool:
            yield from self._in_order(pool, self.prefetch, batches,
                                      lambda pool, idx: pool.submit(self._build, idx))

    @staticmethod
    def _in_order(pool, depth: int, batches, submit, read=None,
                  discard=None) -> Iterator[Dict[str, np.ndarray]]:
        """Up to ``depth`` batches in flight on ``pool``, yielded in order
        (``read`` turns a task's result into the batch; ``discard`` is
        called on the tasks left unread when the iteration stops early)."""
        pending: deque = deque()
        read = read or (lambda result: result)
        try:
            for idx in batches:
                pending.append(submit(pool, idx))
                if len(pending) >= depth:
                    yield read(pending.popleft().result())
            while pending:
                yield read(pending.popleft().result())
        finally:
            for fut in pending:
                if not fut.cancel() and discard is not None:
                    fut.add_done_callback(discard)


def window_activity(inp_window: np.ndarray, tile: int = 8) -> float:
    """Active-tile fraction of one model-input window ``[seqn, H, W, C]``
    (or ``[H, W, C]``): the frames are summed, so a tile is active iff any
    frame touched it."""
    counts = np.asarray(inp_window, np.float32)
    if counts.ndim > 3:
        counts = counts.reshape((-1,) + counts.shape[-3:]).sum(axis=0)
    return activity_fraction_np(tile_activity_np(counts, tile))


def engine_windows(recording, config: Dict) -> InferenceSequenceLoader:
    """The evaluation loader of one recording with ``item_keys`` set to the
    three streams the engine reads (the values are the same)."""
    cfg = dict(config)
    cfg.setdefault("item_keys", ["inp_scaled_cnt", "gt_cnt", "inp_cnt"])
    return InferenceSequenceLoader(recording, cfg)


def window_tuple(batch: Dict[str, np.ndarray], seqn: int) -> tuple:
    """``(inp_scaled [seqn,h,w,c], gt_mid, inp_mid)`` of one ``(1, L, ...)``
    batch: the sequential harness's ``inputs_seq[0]`` window."""
    mid = (seqn - 1) // 2
    return (
        np.asarray(batch["inp_scaled_cnt"][0, :seqn], np.float32),
        np.asarray(batch["gt_cnt"][0, mid], np.float32),
        np.asarray(batch["inp_cnt"][0, mid], np.float32),
    )


class LanePackedChunks:
    """Lane-packed window chunks for the streaming engine (counterpart of
    ``esr_tpu/data/loader.py:LanePackedChunks``).

    ``lanes`` recordings stream at once, one per lane, ``chunk_windows``
    consecutive windows per lane stacked into one ``{key: (W, B, ...)}``
    chunk. Each recording rides one lane in window order; lanes refill only
    at chunk boundaries (``reset_keep = 0`` there: the engine zeroes that
    lane's state); a lane whose recording ends mid-chunk is zero-padded with
    ``valid = 0``; a full chunk looks one window ahead, so a recording whose
    length is a multiple of ``chunk_windows`` frees its lane at once. Every
    recording must share one resolution ladder.

    Each chunk: ``windows`` (``inp_scaled (W,B,seqn,h,w,c)``, ``gt``,
    ``inp_mid``, ``valid (W,B)``), ``activity (W,B)`` (the window's
    active fraction of 8x8 tiles, 0 on padding; host-side only), ``reset_keep (B,)``
    and ``meta`` (per lane ``{"recording", "path", "windows"}`` or None).
    """

    def __init__(self, recordings: Sequence, config: Dict, lanes: int = 4,
                 chunk_windows: int = 8):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if chunk_windows < 1:
            raise ValueError(f"chunk_windows must be >= 1, got {chunk_windows}")
        if not recordings:
            raise ValueError("empty recording list")
        self.recordings = list(recordings)
        self.config = dict(config)
        self.lanes = int(lanes)
        self.chunk_windows = int(chunk_windows)
        self.seqn = int(config["sequence"].get("seqn", 3))
        probe = ConcatSequenceDataset([self.recordings[0]], self.config)
        self.inp_resolution = probe.inp_resolution
        self.gt_resolution = probe.gt_resolution

    def _windows(self, recording) -> Iterator[tuple]:
        loader = engine_windows(recording, self.config)
        if (tuple(loader.gt_resolution) != tuple(self.gt_resolution)
                or tuple(loader.inp_resolution) != tuple(self.inp_resolution)):
            raise ValueError(
                f"recording {recording_name(recording)} resolution "
                f"{loader.inp_resolution}->{loader.gt_resolution} does not match "
                f"the pack's {self.inp_resolution}->{self.gt_resolution}; "
                "lane-packing needs a homogeneous datalist (run ragged "
                "datalists in sequential mode)"
            )
        for batch in loader:
            yield window_tuple(batch, self.seqn)

    def __iter__(self) -> Iterator[Dict]:
        W, B = self.chunk_windows, self.lanes
        pending = deque(self.recordings)
        lanes: List[Optional[Dict]] = [None] * B
        shapes = None
        while True:
            reset_keep = np.ones(B, np.float32)
            for i in range(B):
                if lanes[i] is None:
                    reset_keep[i] = 0.0  # refill or idle: zero the state
                    if pending:
                        rec = pending.popleft()
                        lanes[i] = {"path": rec, "name": recording_name(rec),
                                    "it": self._windows(rec)}
            per_lane: List[List[tuple]] = [[] for _ in range(B)]
            meta: List[Optional[Dict]] = [None] * B
            for i in range(B):
                lane = lanes[i]
                if lane is None:
                    continue
                wins = per_lane[i]
                while len(wins) < W:
                    if "peek" in lane:
                        wins.append(lane.pop("peek"))
                        continue
                    try:
                        wins.append(next(lane["it"]))
                    except StopIteration:
                        lanes[i] = None  # refilled at the next boundary
                        break
                else:
                    try:
                        lane["peek"] = next(lane["it"])
                    except StopIteration:
                        lanes[i] = None
                meta[i] = {"recording": lane["name"], "path": lane["path"],
                           "windows": len(wins)}
            if sum(len(w) for w in per_lane) == 0:
                if not pending and all(lane is None for lane in lanes):
                    return
                continue  # every assigned recording was empty; refill
            if shapes is None:
                shapes = tuple(a.shape for a in next(w[0] for w in per_lane if w))
            arrays = [np.zeros((W, B) + sh, np.float32) for sh in shapes]
            valid = np.zeros((W, B), np.float32)
            activity = np.zeros((W, B), np.float32)
            for i, wins in enumerate(per_lane):
                for t, win in enumerate(wins):
                    for arr, a in zip(arrays, win):
                        arr[t, i] = a
                    valid[t, i] = 1.0
                    activity[t, i] = window_activity(win[0])
            yield {
                "windows": {"inp_scaled": arrays[0], "gt": arrays[1],
                            "inp_mid": arrays[2], "valid": valid},
                "activity": activity,
                "reset_keep": reset_keep,
                "meta": meta,
            }


class DevicePrefetcher:
    """Stages items of ``source`` on a thread ``depth`` ahead of the
    consumer: ``stage_fn`` (pinned host copies and non-blocking uploads to
    the card) runs while the card computes the previous item. Yields
    ``(item, staged)`` in order; a producer exception re-raises in the
    consumer; ``close`` (or leaving the ``with`` block) stops the thread.
    """

    _DONE = object()

    def __init__(self, source, stage_fn: Callable, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._source = source
        self._stage = stage_fn
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for item in self._source:
                if self._stop.is_set() or not self._put((item, self._stage(item))):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            self._put(e)
            return
        self._put(self._DONE)

    def __iter__(self):
        while True:
            got = self._queue.get()
            if got is self._DONE:
                return
            if isinstance(got, BaseException):
                raise got
            yield got

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
