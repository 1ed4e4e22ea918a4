"""The port's training data path against the JAX package's, on the shared
corpus: augmented sequences bit for bit for seeds that flip each axis and
the polarity (and seeds that flip nothing), the sampler's indices,
and the training loader's batches in order over two epochs with shuffle
and drop_last both ways, in-process and from two spawned workers.
"""

import random

import numpy as np
import pytest

from esr_tpu.data.dataset import SequenceDataset as RefSequenceDataset
from esr_tpu.data.loader import ConcatSequenceDataset as RefConcat
from esr_tpu.data.loader import SequenceLoader as RefLoader
from esr_tpu.data.loader import ShardedSampler as RefSampler
from esr_tpu_torch.data.dataset import SequenceDataset
from esr_tpu_torch.data.loader import ConcatSequenceDataset, SequenceLoader, ShardedSampler
from esr_tpu_torch.data.loader import read_datalist

KEYS = ["inp_cnt", "inp_scaled_cnt", "gt_cnt"]
DATASET = {
    "scale": 2, "ori_scale": "down8", "time_bins": 1, "mode": "events",
    "window": 512, "sliding_window": 256, "need_gt_events": True,
    "need_gt_frame": False, "item_keys": KEYS,
    "data_augment": {"enabled": True, "augment": ["Horizontal", "Vertical", "Polarity"],
                     "augment_prob": [0.5, 0.5, 0.5]},
    "sequence": {"sequence_length": 4, "seqn": 3, "step_size": None,
                 "pause": {"enabled": False}},
}


def _flips(seed):
    """Which of Horizontal, Vertical, Polarity a seed flips at p = 0.5."""
    return tuple(random.Random(seed + i).random() < 0.5 for i in range(3))


# seeds covering no flip, each flip alone, and all three
SEEDS = {}
for _s in range(200):
    SEEDS.setdefault(_flips(_s), _s)
CASES = [(False, False, False), (True, False, False), (False, True, False),
         (False, False, True), (True, True, True)]


@pytest.fixture(scope="module")
def datasets(shared_corpus_dir):
    rec = str(shared_corpus_dir / "rec1.h5")
    return {"ref": RefSequenceDataset(rec, DATASET), "port": SequenceDataset(rec, DATASET),
            "datalist": str(shared_corpus_dir / "datalist2.txt")}


@pytest.mark.parametrize("flips", CASES,
                         ids=lambda f: "".join(c for c, b in zip("hvp", f) if b) or "none")
def test_augmented_sequence_is_bitwise_the_reference(datasets, flips):
    seed = SEEDS[flips]
    ref, port = datasets["ref"], datasets["port"]
    assert len(port) == len(ref) > 2
    for i in (0, len(ref) - 1):
        a, b = port.get_item(i, seed=seed), ref.get_item(i, seed=seed)
        assert len(a) == len(b) == DATASET["sequence"]["sequence_length"]
        for wa, wb in zip(a, b):
            assert sorted(wa) == sorted(KEYS) == sorted(wb)
            for k in KEYS:
                np.testing.assert_array_equal(wa[k], wb[k])
    # the flips are real: an augmented item differs from the plain one
    plain = SequenceDataset(datasets["port"].dataset.recording,
                            {**DATASET, "data_augment": {"enabled": False}})
    changed = [not np.array_equal(w["gt_cnt"], p["gt_cnt"])
               for w, p in zip(port.get_item(0, seed=seed), plain.get_item(0))]
    assert any(changed) == any(flips)


@pytest.mark.parametrize("num_items,batch,shuffle,drop_last", [
    (10, 3, True, True), (10, 3, False, False), (7, 2, True, False),
    (2, 4, True, False), (9, 2, False, True)])
def test_sampler_deals_the_reference_indices(num_items, batch, shuffle, drop_last):
    # the reference's sampler at shard 0 of 1: the port has no data parallelism
    for epoch in (0, 1):
        port = ShardedSampler(num_items, batch, shuffle, drop_last, seed=4)
        ref = RefSampler(num_items, batch, 0, 1, shuffle, drop_last, seed=4)
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert len(port) == len(ref)
        assert [list(b) for b in port] == [list(b) for b in ref]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_yields_the_reference_batches_in_order(datasets, shuffle, drop_last):
    paths = read_datalist(datasets["datalist"])
    kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, seed=7, prefetch=2)
    port = SequenceLoader(ConcatSequenceDataset(paths, DATASET), **kw)
    ref = RefLoader(RefConcat(paths, DATASET), **kw)
    assert len(port) == len(ref) >= 2
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(ref)
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b) == sorted(KEYS)
            for k in KEYS:
                assert a[k].shape[:2] == (3, DATASET["sequence"]["sequence_length"])
                np.testing.assert_array_equal(a[k], b[k])
    # process workers (refused until they were ported) give the same batches
    workers = SequenceLoader(port.dataset, num_workers=2, **kw)
    try:
        workers.set_epoch(1)
        for a, b in zip(list(workers), want):
            for k in KEYS:
                np.testing.assert_array_equal(a[k], b[k])
    finally:
        workers.close()
