"""Datalists, concatenation, collation, the training loader and the
evaluation loader (counterpart of ``esr_tpu/data/loader.py``).

:class:`SequenceLoader` is the training loader: :class:`ShardedSampler`'s
epoch shuffle (``np.random.default_rng((seed, epoch))``), one derived
augmentation seed per sequence, and batches built in order by a thread pool
``prefetch`` deep, or with ``num_workers > 0`` by a pool of that many
spawned processes (each rebuilds the dataset once from the recordings and
the config); the batches and their augmentation seeds are the same either
way. The stateful hot-pixel filter takes no workers, and its batches are
built by one prefetch thread, in the sampler's order.
The evaluation loader is synchronous: batch 1, in order, non-overlapping
sequences. :class:`LanePackedChunks` packs recordings into lanes for the
streaming engine, and :class:`DevicePrefetcher` stages the engine's chunks
and the trainer's batches on a thread, with the stall watchdog and the
``prefetch`` fault site.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
import time
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


def group_batches(source, k: int) -> Iterator[List]:
    """Lists of ``k`` consecutive batches of ``source``, in order; the
    epoch's tail (``len(source) % k`` batches) is a last, shorter group.
    The trainer's super-steps: its cadences are taken per group."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    group: List = []
    for batch in source:
        group.append(batch)
        if len(group) == k:
            yield group
            group = []
    if group:
        yield group


def collate_megabatch(batches: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """``[k batch dicts of (B, L, ...)] -> {key: (k, B, L, ...)}``, a numpy
    stack: the megabatch of a super-step (``training.multistep``). All
    ``k`` batches share their shapes (a full group of the loader's)."""
    keys = batches[0].keys()
    return {k_: np.stack([b[k_] for b in batches]) for k_ in keys}


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
        # the stateful hot-pixel filter must see the windows in the
        # sampler's order: then one thread builds ahead, in turn
        hot = (self.dataset.config.get("hot_filter") or {}).get("enabled", False)
        with ThreadPoolExecutor(max_workers=1 if hot else self.prefetch) as pool:
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


def _corrupt_item(item):
    """Enact a ``prefetch``/``corrupt`` fault on what the source yields: a
    batch dict or a group (list) of them."""
    from esr_tpu_torch.resilience.faults import corrupt_batch

    if isinstance(item, dict):
        corrupt_batch(item)
    elif isinstance(item, (list, tuple)):
        for b in item:
            if isinstance(b, dict):
                corrupt_batch(b)
    return item


class DevicePrefetcher:
    """Stages items of ``source`` on a thread ``depth`` ahead of the
    consumer (counterpart of ``esr_tpu/data/loader.py:DevicePrefetcher``):
    ``stage_fn`` (the host->device copies) runs while the card computes the
    previous item. Yields ``(item, staged)`` in order; a producer exception
    re-raises in the consumer; ``close`` (or leaving the ``with`` block)
    stops the thread.

    Health: with a process-active telemetry sink, a ``prefetch_queue_depth``
    gauge every ``gauge_every`` items, a ``prefetch_stall`` counter whenever
    the consumer waited on an empty queue, a ``prefetch_close`` event at
    teardown, and the ``device_prefetch`` ``/healthz`` source while open.

    Stall watchdog (``stall_timeout``): a consumer wait longer than it is a
    hung producer. The first abandons the producer thread and starts a
    replacement (``recovery_prefetch_restart``); a second degrades to
    staging on the consumer thread (``recovery_prefetch_degrade``). The
    source is pulled under a lock after a generation check, so an abandoned
    producer that wakes up exits without taking an item: no item is lost or
    duplicated when the stall struck between items. None (the default)
    waits without bound.

    Fault plane: the producer fires the ``prefetch`` site once per item
    ordinal; ``stall`` sleeps the producer ``arg`` seconds, ``corrupt``
    NaN-poisons the host item before staging.
    """

    def __init__(self, source, stage_fn: Callable, depth: int = 2,
                 join_timeout: float = 5.0, gauge_every: int = 32,
                 stall_timeout: Optional[float] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if join_timeout <= 0:
            raise ValueError(f"join_timeout must be > 0, got {join_timeout}")
        if gauge_every < 1:
            raise ValueError(f"gauge_every must be >= 1, got {gauge_every}")
        if stall_timeout is not None and stall_timeout <= 0:
            raise ValueError(f"stall_timeout must be > 0 (or None), got {stall_timeout}")
        from esr_tpu_torch.obs import trace
        from esr_tpu_torch.obs.http import register_health_source

        self._join_timeout = float(join_timeout)
        self._gauge_every = int(gauge_every)
        self._stall_timeout = float(stall_timeout) if stall_timeout is not None else None
        self.gets = 0
        self.stalls = 0
        self.stall_s = 0.0
        self.restarts = 0
        self.degraded = False
        self._reported_close = False
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._it = iter(source)
        self._stage_fn = stage_fn
        # _it_lock serialises the pulls from the source, taken with the
        # watchdog's timeout; _put_lock is never held across a wait: it
        # orders the generation, the item ordinal, each producer's (check,
        # enqueue) pair and the counters that health() reads from the live
        # plane's thread
        self._it_lock = threading.Lock()
        self._put_lock = threading.Lock()
        self._gen = 0
        self._item_idx = 0
        self._trace_ctx = trace.capture()
        self._thread = self._spawn_producer()
        register_health_source("device_prefetch", self.health)

    def health(self) -> dict:
        """The ``/healthz`` source: unhealthy once the watchdog fired. Runs
        on the live plane's thread, so it reads the counters under the lock
        their writers hold."""
        with self._put_lock:
            out = {"healthy": not self.degraded and self.restarts == 0, "gets": self.gets,
                   "stalls": self.stalls, "stall_s": round(self.stall_s, 6),
                   "restarts": self.restarts, "degraded": self.degraded}
        out["queue_depth"] = self._q.qsize()
        return out

    def _spawn_producer(self) -> threading.Thread:
        th = threading.Thread(target=self._produce, args=(self._gen,), daemon=True,
                              name=f"device-prefetch-g{self._gen}")
        th.start()
        return th

    def _produce(self, gen: int) -> None:
        from esr_tpu_torch.obs import trace

        with trace.adopt(self._trace_ctx):
            self._produce_inner(gen)

    def _abandoned(self, gen: int) -> bool:
        """Whether producer ``gen`` was stopped or replaced; called only
        with ``_put_lock`` held, the lock the watchdog bumps ``_gen``
        under."""
        return self._stop.is_set() or gen != self._gen

    def _acquire_source(self) -> bool:
        """The iterator lock, bounded by the watchdog's timeout when armed
        (a producer hung inside ``next`` holds it for good)."""
        if self._stall_timeout is None:
            self._it_lock.acquire()
            return True
        return self._it_lock.acquire(timeout=self._stall_timeout)

    def _pull_source(self, gen: int):
        """One generation-checked pull with the fault site fired:
        ``("item", x)``, ``("end", None)`` or ``("abandoned", None)``. The
        ordinal is consumed only by a successful pull, so the ordinal ->
        item mapping stays 1:1 across a restart."""
        if not self._acquire_source():
            return "abandoned", None
        try:
            with self._put_lock:
                if self._abandoned(gen):
                    return "abandoned", None
                idx = self._item_idx
        finally:
            self._it_lock.release()
        from esr_tpu_torch.resilience import faults

        specs = faults.fire("prefetch", idx)
        for spec in specs:
            if spec.kind == "stall":
                time.sleep(spec.arg)
        if not self._acquire_source():
            return "abandoned", None
        try:
            with self._put_lock:
                if self._abandoned(gen):
                    return "abandoned", None
            # outside _put_lock: a pull that hangs must leave the watchdog
            # free to bump the generation
            try:
                item = next(self._it)
            except StopIteration:
                return "end", None
            with self._put_lock:
                self._item_idx = idx + 1
        finally:
            self._it_lock.release()
        for spec in specs:
            if spec.kind == "corrupt":
                _corrupt_item(item)
        return "item", item

    def _produce_inner(self, gen: int) -> None:
        def put(entry) -> bool:
            while True:
                with self._put_lock:
                    if self._abandoned(gen):
                        return False
                    try:
                        self._q.put_nowait(entry)
                        return True
                    except queue.Full:
                        pass
                # wait for a free slot (a get notifies not_full at once),
                # waking every 50 ms to see whether the producer was abandoned
                with self._q.not_full:
                    if self._q._qsize() >= self._q.maxsize:
                        self._q.not_full.wait(timeout=0.05)

        try:
            while True:
                kind, item = self._pull_source(gen)
                if kind == "abandoned":
                    return
                if kind == "end":
                    put(("end", None))
                    return
                if not put(("item", (item, self._stage_fn(item)))):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            put(("error", e))

    def __iter__(self):
        return self

    def _watchdog_fire(self, waited: float) -> None:
        """A wait past ``stall_timeout``: restart the producer once, then
        degrade to staging on the consumer thread."""
        import warnings

        from esr_tpu_torch.resilience.recovery import emit_recovery

        if self.restarts == 0:
            with self._put_lock:
                self.restarts += 1
                self._gen += 1
            emit_recovery("recovery_prefetch_restart", site="prefetch",
                          waited_s=round(waited, 6), timeout_s=self._stall_timeout)
            warnings.warn(f"DevicePrefetcher producer stalled >{self._stall_timeout:g}s; "
                          "abandoned the thread and started a replacement", stacklevel=3)
            self._thread = self._spawn_producer()
        elif not self.degraded:
            with self._put_lock:
                self.degraded = True
                self._gen += 1
            emit_recovery("recovery_prefetch_degrade", site="prefetch",
                          waited_s=round(waited, 6), timeout_s=self._stall_timeout)
            warnings.warn("DevicePrefetcher stalled again after a producer restart; "
                          "degrading to synchronous (consumer-thread) staging", stacklevel=3)

    def _get_blocking(self):
        """A blocking get, counted as a stall (with the watchdog when armed)."""
        from esr_tpu_torch.obs import active_sink

        t0 = time.monotonic()
        if self._stall_timeout is None:
            kind, payload = self._q.get()
        else:
            while True:
                try:
                    kind, payload = self._q.get(timeout=self._stall_timeout)
                    break
                except queue.Empty:
                    self._watchdog_fire(time.monotonic() - t0)
                    if self.degraded:
                        # drain what a producer landed before the fence
                        try:
                            kind, payload = self._q.get_nowait()
                        except queue.Empty:
                            kind, payload = self._next_sync()
                        break
        waited = time.monotonic() - t0
        with self._put_lock:
            self.stalls += 1
            self.stall_s += waited
        sink = active_sink()
        if sink is not None:
            sink.counter("prefetch_stall", waited_s=round(waited, 6))
        return kind, payload

    def _next_sync(self):
        """Degraded mode: pull and stage on the consumer thread. A source
        wedged mid-pull cannot be resumed: that raises."""
        kind, item = self._pull_source(self._gen)
        if kind == "abandoned":
            raise RuntimeError("DevicePrefetcher source is wedged mid-pull (the hung producer "
                               "still holds the iterator lock); restart the run from the last "
                               "checkpoint")
        if kind != "item":
            return "end", None
        return "item", (item, self._stage_fn(item))

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        try:
            kind, payload = self._q.get_nowait()
        except queue.Empty:
            if self.degraded:
                kind, payload = self._next_sync()
            else:
                kind, payload = self._get_blocking()
        with self._put_lock:
            self.gets += 1
        if self.gets % self._gauge_every == 0:
            from esr_tpu_torch.obs import active_sink

            sink = active_sink()
            if sink is not None:
                sink.gauge("prefetch_queue_depth", self._q.qsize(), gets=self.gets,
                           stalls=self.stalls)
        if kind == "item":
            return payload
        self.close()
        if kind == "end":
            raise StopIteration
        raise payload

    def close(self) -> None:
        """Stop the producer and drop the staged items still queued."""
        import sys
        import warnings

        from esr_tpu_torch.obs import active_sink
        from esr_tpu_torch.obs.http import unregister_health_source

        unregister_health_source("device_prefetch")
        self._stop.set()

        def drain():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass

        drain()
        if sys.is_finalizing():
            return
        self._thread.join(timeout=self._join_timeout)
        drain()
        sink = active_sink()
        if self._thread.is_alive():
            if sink is not None:
                sink.counter("prefetch_join_timeout", timeout_s=self._join_timeout)
            warnings.warn(f"DevicePrefetcher producer thread did not stop within "
                          f"{self._join_timeout:g}s; it is daemonic and leaks only until "
                          "process exit", stacklevel=2)
        if sink is not None and not self._reported_close:
            self._reported_close = True
            sink.event("prefetch_close", gets=self.gets, stalls=self.stalls,
                       stall_s=round(self.stall_s, 6), joined=not self._thread.is_alive())

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
