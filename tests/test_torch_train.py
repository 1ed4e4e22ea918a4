"""The port's training against the JAX package's, on the CPU: the training
data path (augmented sequences bit for bit for seeds that flip each axis
and the polarity, and seeds that flip nothing; the sampler's indices; the
training loader's batches in order over two epochs with shuffle and
drop_last both ways, in-process and from two spawned workers), the gated LR
schedule, the optimizers, three BPTT train steps and the eval step on the
same converted weights and seeded batches, the YAML reader against
``yaml.safe_load``, and the port's trainer end to end (checkpoint commit
with its digest, inference load, ``-r auto`` resume, the flagship config
as written with its writer and visualizations, the keys it takes up and
the ones it refuses), the super-step (``training.multistep``) against the
reference's ``make_multi_step``, and fused validation against the
reference trainer's. The second shipped recipe
(``configs/train_srunet_2x.yml``, ``SRUNetRecurrentSeq``): two train steps
against the reference's (losses, gradients and parameters after
Adam-amsgrad within 1e-5 of each leaf's scale; measured ~1e-7), and its
trainer on the CPU with remat, ``k_steps``, the anomaly guard and async
checkpoints.

The JAX train step runs ``DeepRecurrNet(dcn_impl="jnp")``: what
``train=True`` resolves to off-TPU, and the oracle the fused Pallas
backward is pinned to (``tests/test_dcn_pallas.py``).

Tolerances (measured envelope in brackets): train losses, per-window
losses and grad norms rtol 1e-5 [4e-7, 5.7e-7 rel]; the last prediction
atol 1e-6 [3.6e-7]; params after 3 Adam steps rtol 2e-3 + atol 1e-6
[1.6e-7 abs] (the bound MIGRATION.md:113-115 records between the JAX and
the original torch trainers over 5 iterations); eval losses rtol 1e-5
[3e-7]; schedule rtol 1e-6 (the reference computes it in f32); optimizer
updates atol 1e-7 + rtol 1e-6.
"""

import json
import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from esr_tpu.config import parser as J_parser
from esr_tpu.data.dataset import SequenceDataset as RefSequenceDataset
from esr_tpu.data.loader import ConcatSequenceDataset as RefConcat
from esr_tpu.data.loader import SequenceLoader as RefLoader
from esr_tpu.data.loader import ShardedSampler as RefSampler
from esr_tpu.data.loader import collate_megabatch as ref_collate_megabatch
from esr_tpu.config.build import build_model as j_build_model
from esr_tpu.models.esr import DeepRecurrNet as FlaxNet
from esr_tpu.models.registry import get_model as j_get_model
from esr_tpu.training import multistep as J_multi
from esr_tpu.training import optim as J_optim
from esr_tpu.training import schedule as J_schedule
from esr_tpu.training.train_step import TrainState
from esr_tpu.training.train_step import make_eval_step as j_make_eval_step
from esr_tpu.training.train_step import make_train_step as j_make_train_step
from esr_tpu_torch import train as T_train
from esr_tpu_torch.config import parser as T_parser
from esr_tpu_torch.data.dataset import SequenceDataset
from esr_tpu_torch.data.loader import ConcatSequenceDataset, SequenceLoader, ShardedSampler
from esr_tpu_torch.data.loader import collate_megabatch, read_datalist
from esr_tpu_torch.device import resolve_device
from esr_tpu_torch.inference.checkpoint import load_checkpoint, read_params
from esr_tpu_torch.models import convert
from esr_tpu_torch.models.adapters import FrameRecurrentSR
from esr_tpu_torch.models.esr import DeepRecurrNet
from esr_tpu_torch.models.registry import get_model as t_get_model
from esr_tpu_torch.resilience.faults import FaultPlan, FaultSpec, installed
from esr_tpu_torch.training import multistep as T_multi
from esr_tpu_torch.training import optim as T_optim
from esr_tpu_torch.training import schedule as T_schedule
from esr_tpu_torch.training import train_step as T_step
from esr_tpu_torch.training.checkpoint import find_latest_checkpoint
from esr_tpu_torch.training.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
CONFIGS = ["train_esr_2x.yml", "train_esr_4x.yml", "train_srunet_2x.yml"]
B, L, H, W, STEPS = 2, 5, 16, 20, 3
SCHEDULE = dict(gamma=0.5, change_rate=1, floor=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work in one intra-op thread: at these sizes a
    thread team gains nothing, and beside other busy processes its
    spinning workers slow every op by orders of magnitude (the trainer runs
    of this module most of all)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the training data path -----------------------------------------------

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


PAUSE_CASES = {"always": (1.0, 1.0), "never": (0.0, 0.0), "shipped": (0.05, 0.9),
               "flaky": (0.4, 0.5)}


@pytest.mark.parametrize("case", PAUSE_CASES)
def test_paused_sequence_is_bitwise_the_reference(datasets, case):
    """Sensor pauses (``sequence.pause``) over sequences with augmentation,
    noise and the hot filter: the chain's draws, which windows pause
    (zero input events, no noise, the GT unaffected, the index repeated)
    and every item bitwise the reference's SequenceDataset, for several
    seeds (``tests/test_data_pipeline.py``'s pause cases)."""
    run_p, paused_p = PAUSE_CASES[case]
    cfg = {**DATASET, "item_keys": KEYS + ["inp_stack"],
           "add_noise": {"enabled": True, "noise_level": 0.1},
           "hot_filter": {"enabled": True, "min_obvs": 2, "max_rate": 0.5},
           "sequence": {**DATASET["sequence"], "sequence_length": 6,
                        "pause": {"enabled": True, "proba_pause_when_running": run_p,
                                  "proba_pause_when_paused": paused_p}}}
    rec = datasets["port"].dataset.recording
    ref, port = RefSequenceDataset(rec.path, cfg), SequenceDataset(rec, cfg)
    assert len(port) == len(ref) > 1
    n_paused = 0
    for i in range(len(ref)):
        for seed in (3, 9, 40):
            a, b = port.get_item(i, seed=seed), ref.get_item(i, seed=seed)
            assert len(a) == len(b) == 6
            for wa, wb in zip(a, b):
                assert sorted(wa) == sorted(wb)
                for k in wa:
                    np.testing.assert_array_equal(wa[k], wb[k], err_msg=k)
                if wa["inp_cnt"].sum() == 0:
                    n_paused += 1
                    assert wa["inp_scaled_cnt"].sum() == 0 and wa["gt_cnt"].sum() > 0
            assert a[0]["inp_cnt"].sum() > 0
    windows = len(ref) * 3 * 5
    assert {"always": n_paused == windows, "never": n_paused == 0,
            "shipped": n_paused < windows, "flaky": 0 < n_paused < windows}[case]


@pytest.mark.parametrize("shard_id,num_shards", [(0, 1), (0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("num_items,batch,shuffle,drop_last", [
    (10, 3, True, True), (10, 3, False, False), (7, 2, True, False),
    (2, 4, True, False), (9, 2, False, True)])
def test_sampler_deals_the_reference_indices(num_items, batch, shuffle, drop_last, shard_id,
                                             num_shards):
    # each process's share of every global batch, as the reference deals it
    for epoch in (0, 1):
        port = ShardedSampler(num_items, batch, shuffle, drop_last, seed=4, shard_id=shard_id,
                              num_shards=num_shards)
        ref = RefSampler(num_items, batch, shard_id, num_shards, shuffle, drop_last, seed=4)
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


# -- schedule and optimizer -----------------------------------------------


def test_schedule_matches_reference_until_and_past_the_floor():
    for base in (1e-3, 5e-5):
        j = J_schedule.exponential_with_floor(base, gamma=0.5, change_rate=2, floor=1e-4)
        t = T_schedule.exponential_with_floor(base, gamma=0.5, change_rate=2, floor=1e-4)
        values = [t(s) for s in range(16)]
        np.testing.assert_allclose(values, [float(j(s)) for s in range(16)], rtol=1e-6)
    # 1e-3 halves at steps 2, 4, 6, 8 and then stops: 6.25e-5 is below the floor
    assert values[-1] == 5e-5  # base below the floor: never decays
    t = T_schedule.exponential_with_floor(1e-3, gamma=0.5, change_rate=2, floor=1e-4)
    assert [t(s) for s in (0, 1, 2, 7, 8, 100)] == [1e-3, 1e-3, 5e-4, 1.25e-4, 6.25e-5, 6.25e-5]


@pytest.mark.parametrize("name", ["Adam", "AdamW", "SGD"])
def test_optimizer_steps_match_reference(name):
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    kw = dict(weight_decay=1e-4, amsgrad=True)
    j_opt = J_optim.make_optimizer(
        name, lr=J_schedule.exponential_with_floor(1e-2, **SCHEDULE), **kw)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = j_opt.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    t_opt = T_optim.make_optimizer(
        name, list(t_params.values()),
        lr=T_schedule.exponential_with_floor(1e-2, **SCHEDULE), **kw)
    for g in grads:
        updates, j_state = j_opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                        j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k])
        t_opt.step()
        for k, p in t_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]),
                                       rtol=1e-6, atol=1e-7)
    assert t_opt.count == 5 and t_opt.lr == 1e-2 * 0.5 ** 5


# -- the train and eval steps ---------------------------------------------


@pytest.fixture(scope="module")
def parity():
    """Three train steps of both packages from the same weights, on the same
    seeded batches, then the eval step on the trained weights."""
    resolve_device("cpu")
    rng = np.random.default_rng(0)
    ref = FlaxNet(inch=2, basech=4, num_frame=3, dcn_impl="jnp")
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            np.zeros((1, 3, H, W, 2), np.float32), ref.init_states(1, H, W))

    def draw(leaf):
        # U(+-1/sqrt(fan_in)); biases U(+-0.3): the offset/mask conv is not
        # zero, so the fractional gather and its gradients are exercised
        bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 0.3
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    params = jax.tree.map(draw, shapes)
    batches = [{k: rng.poisson(0.7, (B, L, H, W, 2)).astype(np.float32) for k in ("inp", "gt")}
               for _ in range(STEPS + 1)]
    opt_kw = dict(weight_decay=1e-4, amsgrad=True)

    j_opt = J_optim.make_optimizer(
        "Adam", lr=J_schedule.exponential_with_floor(1e-3, **SCHEDULE), **opt_kw)
    j_step = jax.jit(j_make_train_step(ref, j_opt, seqn=3))
    state = TrainState.create(params, j_opt)
    j_metrics = []
    for batch in batches[:STEPS]:
        state, m = j_step(state, batch)
        j_metrics.append({k: np.asarray(v) for k, v in m.items()})
    j_eval = {k: float(v) for k, v in
              jax.jit(j_make_eval_step(ref, seqn=3))(state.params, batches[STEPS]).items()}

    port = DeepRecurrNet(inch=2, basech=4, num_frame=3)
    convert.load_flax_params(port, params)
    t_opt = T_optim.make_optimizer(
        "Adam", port.parameters(),
        lr=T_schedule.exponential_with_floor(1e-3, **SCHEDULE), **opt_kw)
    t_step = T_step.make_train_step(port, t_opt, seqn=3)
    t_metrics = []
    for batch in batches[:STEPS]:
        m = t_step({k: torch.from_numpy(v) for k, v in batch.items()})
        t_metrics.append({k: v.numpy() for k, v in m.items()})
    t_eval = {k: float(v) for k, v in T_step.make_eval_step(port, seqn=3)(
        {k: torch.from_numpy(v) for k, v in batches[STEPS].items()}).items()}

    # the same STEPS steps as one super-step of each package
    mega = ref_collate_megabatch(batches[:STEPS])
    j_multi = jax.jit(J_multi.make_multi_step(j_make_train_step(ref, j_opt, seqn=3), STEPS))
    j_state, j_stacked = j_multi(TrainState.create(params, j_opt), mega)
    super_port = DeepRecurrNet(inch=2, basech=4, num_frame=3)
    convert.load_flax_params(super_port, params)
    s_opt = T_optim.make_optimizer(
        "Adam", super_port.parameters(),
        lr=T_schedule.exponential_with_floor(1e-3, **SCHEDULE), **opt_kw)
    t_multi = T_multi.make_multi_step(T_step.make_train_step(super_port, s_opt, seqn=3),
                                      STEPS, optimizer=s_opt)
    t_stacked = t_multi({k: torch.from_numpy(v) for k, v in collate_megabatch(
        batches[:STEPS]).items()})
    return {"jax": j_metrics, "port": t_metrics, "jax_params": state.params,
            "port_params": convert.export_flax_params(port), "jax_eval": j_eval,
            "port_eval": t_eval, "start": params,
            "jax_super": {k: np.asarray(v) for k, v in j_stacked.items()},
            "jax_super_params": j_state.params,
            "port_super": {k: v.numpy() for k, v in t_stacked.items()},
            "port_super_params": convert.export_flax_params(super_port),
            "port_super_count": s_opt.count}


@pytest.mark.parametrize("key", ["loss", "loss_per_window", "grad_norm", "last_pred"])
def test_train_step_metrics_match_reference(parity, key):
    for j, t in zip(parity["jax"], parity["port"]):
        assert t[key].shape == j[key].shape
        np.testing.assert_allclose(t[key], j[key], rtol=1e-5, atol=1e-6)
    assert len(parity["port"][0]["loss_per_window"]) == L - 3 + 1


def test_params_after_three_steps_match_reference(parity):
    got = convert.flatten_tree(parity["port_params"])
    want = convert.flatten_tree(jax.tree.map(np.asarray, parity["jax_params"]))
    start = convert.flatten_tree(parity["start"])
    assert set(got) == set(want)
    moved = 0.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=1e-6, err_msg="/".join(k))
        moved = max(moved, float(np.abs(want[k] - start[k]).max()))
    assert moved > 1e-3  # three Adam steps at lr >= 2.5e-4 moved the weights


def test_eval_step_matches_reference(parity):
    assert sorted(parity["port_eval"]) == ["valid_loss", "valid_mse_loss"]
    for k, v in parity["jax_eval"].items():
        np.testing.assert_allclose(parity["port_eval"][k], v, rtol=1e-5)


# -- the super-step (training.multistep) -----------------------------------


@pytest.mark.parametrize("key", ["loss", "loss_per_window", "grad_norm", "last_pred"])
def test_super_step_metrics_are_the_steps_and_match_reference(parity, key):
    """The port's super-step gives its plain steps' metrics bit for bit,
    stacked (``last_pred`` the last step's), and the reference's
    ``make_multi_step`` within the step tolerances."""
    got, ref = parity["port_super"][key], parity["jax_super"][key]
    plain = [m[key] for m in parity["port"]]
    want = plain[-1] if key == "last_pred" else np.stack(plain)
    assert got.shape == ref.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_super_step_params_are_the_steps_and_match_reference(parity):
    got = convert.flatten_tree(parity["port_super_params"])
    plain = convert.flatten_tree(parity["port_params"])
    ref = convert.flatten_tree(jax.tree.map(np.asarray, parity["jax_super_params"]))
    assert set(got) == set(plain) == set(ref)
    assert parity["port_super_count"] == STEPS
    for k in ref:
        np.testing.assert_array_equal(got[k], plain[k], err_msg="/".join(k))
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-3, atol=1e-6, err_msg="/".join(k))


def _toy_steps():
    """One toy step each way: a running sum as the state, the metrics a
    scalar, a per-element vector and ``last_pred`` (small integers in f32,
    so both packages' sums are exact)."""
    def ref_step(state, batch):
        x = batch["x"]
        state = state + x.sum()
        return state, {"loss": state * 2.0, "per": x * state, "last_pred": x + state}

    store = {"s": torch.zeros(())}

    def port_step(batch):
        x = batch["x"]
        store["s"] = store["s"] + x.sum()
        s = store["s"]
        return {"loss": s * 2.0, "per": x * s, "last_pred": x + s}

    return ref_step, port_step


@pytest.mark.parametrize("k", [0, -2])
def test_multi_step_refuses_k_below_one_as_the_reference(k):
    ref_step, port_step = _toy_steps()
    with pytest.raises(ValueError, match="k must be >= 1"):
        J_multi.make_multi_step(ref_step, k)
    with pytest.raises(ValueError, match="k must be >= 1"):
        T_multi.make_multi_step(port_step, k)


def test_multi_step_names_the_leaf_without_the_leading_axis():
    ref_step, port_step = _toy_steps()
    bad = np.zeros((2, 4), np.float32)
    msg = r"megabatch leaf .*x.* has shape \(2, 4\); expected leading axis 3"
    with pytest.raises(ValueError, match=msg):
        J_multi.make_multi_step(ref_step, 3)(jnp.zeros(()), {"x": bad})
    with pytest.raises(ValueError, match=msg):
        T_multi.make_multi_step(port_step, 3)({"x": torch.from_numpy(bad)})


@pytest.fixture(scope="module")
def toy_super_steps():
    """Each package's toy super-step of 3 steps over a seeded megabatch, and
    with ``reuse_batch`` over one batch: their metrics."""
    rng = np.random.default_rng(7)
    out = {}
    for reuse_batch in (False, True):
        ref_step, port_step = _toy_steps()
        x = rng.integers(0, 5, (4,) if reuse_batch else (3, 4)).astype(np.float32)
        _, ref = J_multi.make_multi_step(ref_step, 3, reuse_batch=reuse_batch)(
            jnp.zeros(()), {"x": x})
        got = T_multi.make_multi_step(port_step, 3, reuse_batch=reuse_batch)(
            {"x": torch.from_numpy(x)})
        out[reuse_batch] = (ref, got)
    return out


@pytest.mark.parametrize("reuse_batch", [False, True])
def test_multi_step_stacks_metrics_as_the_reference(toy_super_steps, reuse_batch):
    """Metrics stacked on a leading k axis, ``last_pred`` the final step's;
    ``reuse_batch`` feeds one batch to every step."""
    ref, got = toy_super_steps[reuse_batch]
    assert sorted(got) == sorted(ref) == ["last_pred", "loss", "per"]
    assert got["loss"].shape == (3,) and got["per"].shape == (3, 4)
    assert got["last_pred"].shape == (4,)
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)


def test_collate_megabatch_is_the_references():
    rng = np.random.default_rng(11)
    batches = [{"inp": rng.standard_normal((2, 5, 4, 6, 2)).astype(np.float32),
                "gt": rng.poisson(0.5, (2, 5, 8, 12, 2)).astype(np.float32)}
               for _ in range(3)]
    got, want = collate_megabatch(batches), ref_collate_megabatch(batches)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == (3, *batches[0][k].shape)
        np.testing.assert_array_equal(got[k], want[k])


# -- the config reader -----------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_reader_equals_safe_load(name):
    path = REPO / "configs" / name
    with open(path) as f:
        want = yaml.safe_load(f)
    assert T_parser.load_config(str(path)) == want


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n",            # block sequence
    "a: {b: 1}\n",            # flow mapping
    "a: !!str 1\n",           # another tag
    "a: 0x1F\n",              # hex
    "a: 017\n",               # octal
    "a: |\n  text\n",         # literal block scalar
    "a: [1, [2]]\n",          # nested flow
    "a: *missing\n",          # alias before its anchor
    "a: b: c\n",              # a mapping in a plain scalar
    "---\na: 1\n",            # document marker
])
def test_reader_refuses_what_is_outside_the_subset(text):
    with pytest.raises(ValueError):
        T_parser.loads(text)


def test_overrides_match_reference():
    path = str(REPO / "configs" / "train_esr_2x.yml")
    overrides = ["trainer;tensorboard=false", "trainer;vis;enabled=off",
                 "trainer;iteration_based_train;iterations=4",
                 "optimizer;args;lr=1e-3", "optimizer;args;weight_decay=2.5e-5",
                 "trainer;monitor='min valid_loss'", "trainer;profile;trace_dir=null",
                 "train_dataloader;dataset;data_augment;augment=[Horizontal, 'Polarity']",
                 "new;block;key=some text", "model;args;basech=+4"]
    want = J_parser.apply_overrides(J_parser.load_config(path), overrides)
    got = T_parser.apply_overrides(T_parser.load_config(path), overrides)
    assert got == want
    with pytest.raises(ValueError):
        T_parser.apply_overrides({}, ["no_equals_sign"])


# -- the trainer end to end -----------------------------------------------

TINY = [
    "trainer;tensorboard=false", "trainer;vis;enabled=false", "model;args;basech=4",
    "train_dataloader;batch_size=2", "valid_dataloader;batch_size=2",
    "trainer;iteration_based_train;iterations=4",
    "trainer;iteration_based_train;valid_step=2",
    "trainer;iteration_based_train;save_period=2",
    "trainer;iteration_based_train;train_log_step=1",
    # steps one group each (the flagship groups 8): these runs pin the
    # per-step cadences; test_k_steps_groups_the_cadences_as_the_reference
    # pins the grouped ones
    "trainer;k_steps=1",
] + [f"{block};dataset;{k}={v}" for block in ("train_dataloader", "valid_dataloader")
     for k, v in (("ori_scale", "down8"), ("window", 512), ("sliding_window", 256),
                  ("sequence;sequence_length", 5))]


def _overrides(out, corpus, extra=()):
    return TINY + [
        f"trainer;output_path={out}",
        f"train_dataloader;path_to_datalist_txt={corpus / 'datalist2.txt'}",
        f"valid_dataloader;path_to_datalist_txt={corpus / 'datalist1.txt'}",
        *extra]


def _run(out, corpus, extra=(), **kw):
    return T_parser.RunConfig.from_args(str(REPO / "configs" / "train_esr_2x.yml"),
                                        _overrides(out, corpus, extra), runid="run0", seed=5,
                                        **kw)


@pytest.fixture(scope="module")
def trained(shared_corpus_dir, tmp_path_factory):
    """The flagship config cut to a tiny size, trained 4 iterations on the
    CPU; then the same run resumed with ``-r auto``."""
    out = tmp_path_factory.mktemp("torch_train")
    run = _run(out, shared_corpus_dir)
    trainer = Trainer(run, device="cpu")
    result = trainer.train()
    resumed = Trainer(_run(out, shared_corpus_dir, resume="auto"), device="cpu")
    return {"out": out, "run": run, "trainer": trainer, "result": result,
            "resumed": resumed, "corpus": shared_corpus_dir}


def test_trainer_logs_finite_losses_and_validates(trained):
    result = trained["result"]
    assert sorted(result) == ["train_loss", "train_mse_loss"]
    assert all(np.isfinite(v) for v in result.values())
    with open(trained["trainer"].log_path) as f:
        log = [json.loads(line) for line in f]
    steps = [r for r in log if "train_loss" in r]
    valid = [r for r in log if "valid_stamp" in r]
    assert [r["iteration"] for r in steps] == [0, 1, 2, 3]
    assert all(np.isfinite(r[k]) for r in steps for k in ("train_loss", "grad_norm", "lr"))
    assert [(r["iteration"], r["valid_stamp"]) for r in valid] == [(2, 1)]
    assert np.isfinite(valid[0]["valid_loss"])


def test_checkpoints_are_committed_with_the_marker_last(trained):
    save_dir = Path(trained["run"].save_dir)
    names = sorted(p.name for p in save_dir.iterdir() if p.is_dir())
    assert names == ["checkpoint-iteration2", "checkpoint-iteration3",
                     "model_best_until_iteration2"]
    latest = find_latest_checkpoint(str(save_dir.parent))
    assert latest == str(save_dir / "checkpoint-iteration3")
    for name in names:
        files = {p.name: p.stat().st_mtime_ns for p in (save_dir / name).iterdir()}
        assert sorted(files) == ["config.json", "digest.json", "meta.json", "optimizer.pt",
                                 "params.npz"]
        assert files["meta.json"] >= max(files.values())
        # the digest is the saved state's
        from esr_tpu_torch.resilience.recovery import validate_restored
        from esr_tpu_torch.training.checkpoint import restore_state
        assert validate_restored(str(save_dir / name), restore_state(str(save_dir / name))) \
            == (True, "ok")
    with open(save_dir / "checkpoint-iteration3" / "meta.json") as f:
        meta = json.load(f)
    assert meta["trainer"]["iteration"] == 3 and meta["model"]["name"] == "DeepRecurrNet"
    # an uncommitted directory (no marker) is never picked
    torn = save_dir / "checkpoint-iteration9"
    torn.mkdir()
    try:
        assert find_latest_checkpoint(str(save_dir.parent)) == latest
    finally:
        torn.rmdir()


def test_checkpoint_loads_for_inference_with_the_trainers_outputs(trained):
    trainer = trained["trainer"]
    model, config = load_checkpoint(str(Path(trained["run"].save_dir) / "checkpoint-iteration3"))
    assert config["model"]["args"]["basech"] == 4
    batch = next(iter(trainer.valid_loader))
    inp = torch.from_numpy(batch["inp_scaled_cnt"][:, :3])
    states = model.init_states(*inp.shape[:1], *inp.shape[2:4])
    with torch.no_grad():
        got, _ = model.eval()(inp, states)
        want, _ = trainer.model.eval()(inp, states)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_resume_auto_restores_and_runs_nothing_more(trained, capsys):
    resumed, trainer = trained["resumed"], trained["trainer"]
    assert resumed.start_iteration == 4
    assert resumed.mnt_best == trainer.mnt_best
    assert resumed.optimizer.count == trainer.optimizer.count == 4
    for (n, p), q in zip(resumed.model.named_parameters(), trainer.model.parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), q.detach().numpy(), err_msg=n)
    assert resumed.train() == {}
    # the command line does the same and prints the (empty) final log
    out, corpus = trained["out"], trained["corpus"]
    args = ["-c", str(REPO / "configs" / "train_esr_2x.yml"), "-id", "run0", "-seed", "5",
            "--device", "cpu", "-r", "auto"]
    for ov in TINY + [f"trainer;output_path={out}",
                      f"train_dataloader;path_to_datalist_txt={corpus / 'datalist2.txt'}",
                      f"valid_dataloader;path_to_datalist_txt={corpus / 'datalist1.txt'}"]:
        args += ["-o", ov]
    assert T_train.main(args) == {}
    assert capsys.readouterr().out.strip().splitlines()[-1] == "{}"


@pytest.fixture(scope="module")
def trained_as_written(shared_corpus_dir, tmp_path_factory):
    """The flagship config with its writer and visualizations on (no
    ``tensorboard`` or ``vis`` override), cut to a tiny size: 2 iterations,
    images every iteration."""
    out = tmp_path_factory.mktemp("torch_train_as_written")
    drop = ("trainer;tensorboard=false", "trainer;vis;enabled=false")
    overrides = [o for o in TINY if o not in drop] + [
        "trainer;iteration_based_train;iterations=2",
        "trainer;vis;train_img_writer_num=1",
        f"trainer;output_path={out}",
        f"train_dataloader;path_to_datalist_txt={shared_corpus_dir / 'datalist2.txt'}",
        f"valid_dataloader;path_to_datalist_txt={shared_corpus_dir / 'datalist1.txt'}"]
    run = T_parser.RunConfig.from_args(str(REPO / "configs" / "train_esr_2x.yml"), overrides,
                                       runid="run0", seed=5)
    trainer = Trainer(run, device="cpu")
    return {"run": run, "trainer": trainer, "result": trainer.train()}


def test_flagship_as_written_writes_metrics_and_images(trained_as_written):
    run, trainer = trained_as_written["run"], trained_as_written["trainer"]
    assert trainer.tensorboard and trainer.vis_enabled and trainer.writer is None
    with open(Path(run.log_dir) / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    tags = [(r["step"], r["tag"]) for r in records]
    images = ["train_inp_events_cnt", "train_inp_scaled_events_cnt", "train_esr_events_cnt",
              "train_gt_events_cnt", "train_gt_frame"]
    for it in (0, 1):
        for key in ["train_mse_loss", "train_loss", "learning_rate"] + images:
            assert (it, f"{key}/train") in tags, (it, key)
    # emitted on the advance to step 1, stamped with the step it leaves
    assert (0, "steps_per_sec/train") in tags
    assert sum(1 for r in records if r.get("image")) == 2 * len(images)
    assert all(np.isfinite(r["value"]) for r in records if "value" in r)
    losses = [r["value"] for r in records if r["tag"] == "train_loss/train"]
    assert np.mean(losses) == pytest.approx(trained_as_written["result"]["train_loss"])
    # TensorBoard is importable here, so its event file is written too
    assert any(p.name.startswith("events.out.tfevents") for p in Path(run.log_dir).iterdir())



# -- k_steps: the cadences taken on groups ---------------------------------

GROUPED = ["trainer;k_steps=4", "trainer;iteration_based_train;iterations=9",
           "trainer;iteration_based_train;valid_step=3",
           "trainer;iteration_based_train;save_period=5", "trainer;max_bad_steps=1",
           "trainer;compile_cache=false", "trainer;async_checkpoint=false",
           # datalist1 deals 3 validation batches: a fused chunk of 2, and 1
           # through the single-batch accumulator
           "trainer;validate;chunk_windows=2"]
# datalist2 deals 6 batches an epoch, so the groups are [0-3] [4 5] | [6-9]:
# validation is due inside [0-3] (3) and [6-9] (6 and 9), a save inside
# [4 5], and the last group trains past iteration 8. The faults poison the
# epoch's tail group [4 5] (skipped) and then [6-9], the second bad group
# in a row (a rollback to checkpoint 5, then the replay)
NAN_AT = (4, 6)


def _record_grouped_run(trainer, plan, installed, both_ways=False):
    """Train under the fault ``plan``; each validation's iteration (the
    writer's step when it starts), each save, the checkpoints, the
    ``train_loss`` records and the guard's count. ``both_ways``: each
    validation also runs the other way (``validate.fused`` flipped) on the
    same state, and both ways' averages and readbacks are kept."""
    valids, saves, passes = [], [], []
    valid, save = trainer._valid, trainer._save

    def recorded_valid(*args):
        valids.append(trainer.writer.step)
        if not both_ways:
            return valid(*args)
        ways = {}
        for fused in (not trainer.valid_fused, trainer.valid_fused):
            trainer.valid_fused = fused
            ways["fused" if fused else "sequential"] = (dict(valid(*args)),
                                                        trainer.last_valid_readbacks)
        passes.append(ways)
        return ways["fused" if trainer.valid_fused else "sequential"][0]

    def recorded_save(iteration, best):
        saves.append((iteration, best))
        return save(iteration, best)

    trainer._valid, trainer._save = recorded_valid, recorded_save
    staged = []
    if hasattr(trainer, "_stage_item_timed"):
        # the port's prefetcher: what it stages at a time
        stage = trainer._stage_item_timed

        def recorded_stage(item):
            staged.append(item[:2])
            return stage(item)
        trainer._stage_item_timed = recorded_stage
    with installed(plan):
        trainer.train()
    with open(Path(trainer.run.log_dir) / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    return {"valids": valids, "saves": saves,
            "checkpoints": sorted(p.name for p in Path(trainer.run.save_dir).iterdir()
                                  if p.name.startswith(("checkpoint-", "model_best"))),
            "losses": [(r["step"], r["value"]) for r in records
                       if r["tag"] == "train_loss/train"],
            "skipped": sorted(set(trainer._guard.skipped_iterations)),
            "rollbacks": trainer._guard.rollbacks, "staged": staged, "passes": passes}


@pytest.fixture(scope="module")
def grouped(shared_corpus_dir, tmp_path_factory):
    """``k_steps`` 4 through the reference's trainer and the port's, from
    the reference's initial weights, clean and with ``nan_loss`` faults;
    then the port clean at ``k_steps`` 1."""
    from esr_tpu.parallel.mesh import make_mesh
    from esr_tpu.resilience import faults as J_faults
    from esr_tpu.training.trainer import Trainer as RefTrainer
    from esr_tpu_torch.resilience import faults as T_faults
    from esr_tpu_torch.training.checkpoint import snapshot_state

    out = tmp_path_factory.mktemp("torch_k_steps")
    config = str(REPO / "configs" / "train_esr_2x.yml")

    def port_trainer(path, extra, params):
        trainer = Trainer(_run(path, shared_corpus_dir, extra), device="cpu")
        convert.load_flax_params(trainer.model, params)
        trainer._init_state = snapshot_state(trainer.model, trainer.optimizer)
        return trainer

    runs, mesh, first = {}, make_mesh(jax.devices()[:1]), None
    for case, at in (("clean", ()), ("nan", NAN_AT)):
        ref = RefTrainer(J_parser.RunConfig.from_args(
            config, _overrides(out / case / "ref", shared_corpus_dir, GROUPED), runid="run0",
            seed=5), mesh=mesh)
        if first is not None:
            # the same config on the same mesh: the first trainer's compiled
            # programs, so the second compiles none again
            for name in ("train_step", "multi_step", "eval_step", "_eval_chunk",
                         "_eval_accum"):
                setattr(ref, name, getattr(first, name))
        first = ref
        params = jax.tree.map(np.asarray, ref.state.params)
        port = port_trainer(out / case / "port", GROUPED, params)
        runs[case] = {
            "ref": _record_grouped_run(ref, J_faults.FaultPlan(
                [J_faults.FaultSpec("train_step", i, "nan_loss") for i in at]),
                J_faults.installed, both_ways=case == "clean"),
            "port": _record_grouped_run(port, T_faults.FaultPlan(
                [T_faults.FaultSpec("train_step", i, "nan_loss") for i in at]),
                T_faults.installed, both_ways=case == "clean")}
    one = port_trainer(out / "k1", GROUPED + ["trainer;k_steps=1"], params)
    runs["k1"] = _record_grouped_run(one, T_faults.FaultPlan(), T_faults.installed)
    return runs


@pytest.mark.parametrize("case", ["clean", "nan"])
def test_k_steps_groups_the_cadences_as_the_reference(grouped, case):
    ref, port = grouped[case]["ref"], grouped[case]["port"]
    for key in ("valids", "saves", "checkpoints", "skipped", "rollbacks"):
        assert port[key] == ref[key], key
    assert [i for i, _ in port["losses"]] == [i for i, _ in ref["losses"]]
    np.testing.assert_allclose([v for _, v in port["losses"]], [v for _, v in ref["losses"]],
                               rtol=1e-5)
    if case == "clean":
        # validated after the groups covering 3 and 6, 9; the last group
        # trained past iteration 8 and the final checkpoint says so
        assert ref["valids"] == [3, 9] and ref["saves"][-1][0] == 9
        assert [i for i, _ in ref["losses"]] == list(range(10))
        # the port's prefetcher stages one batch at a time (its place in the
        # group, the group's length), never a whole group; it may have run
        # ahead into the next epoch's first group when the run stopped
        assert port["staged"][:10] == [(j, 4) for j in range(4)] + [(0, 2), (1, 2)] + [
            (j, 4) for j in range(4)]
    else:
        assert ref["skipped"] == [4, 5, 6, 7, 8, 9] and ref["rollbacks"] == 1


@pytest.mark.parametrize("way", ["fused", "sequential"])
def test_validation_reads_back_as_the_reference(grouped, way):
    """``validate.fused`` true and false at ``k_steps`` 4, each validation
    of the clean run both ways on the same state: the port's readbacks a
    pass are the reference's (1 fused, one a batch per batch), its averages
    the reference's within the reference's own 1e-5, and each package's two
    ways agree within 1e-5."""
    ref, port = grouped["clean"]["ref"]["passes"], grouped["clean"]["port"]["passes"]
    assert len(port) == len(ref) == 2
    for r, p in zip(ref, port):
        got, got_readbacks = p[way]
        want, want_readbacks = r[way]
        assert got_readbacks == want_readbacks == (1 if way == "fused" else 3)
        assert sorted(got) == sorted(want) == ["valid_loss", "valid_mse_loss"]
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-5), key
            assert p["fused"][0][key] == pytest.approx(p["sequential"][0][key], rel=1e-5)


def test_k_steps_one_keeps_the_per_step_cadences(grouped):
    one, four = grouped["k1"], grouped["clean"]["port"]
    assert one["valids"] == [3, 6]
    assert [i for i, _ in one["saves"]][-1] == 8 and (5, False) in one["saves"]
    assert [i for i, _ in one["losses"]] == list(range(9))
    # the steps run one by one either way: the same losses, bit for bit
    assert [v for _, v in one["losses"]] == [v for _, v in four["losses"]][:9]

# keys this test pinned as unported until the port took them up: each such
# case now checks that the key takes effect
NOW_PORTED = {
    "trainer;device_rasterize=true": lambda t: (
        t.device_rasterize and "inp_norm_events" in t.train_loader.dataset.config["item_keys"]),
    "trainer;tensorboard=true": lambda t: t.tensorboard,
    "trainer;vis;enabled=true": lambda t: (
        t.vis_enabled and "gt_img" in t.vis_dataset.config["item_keys"]),
    "train_dataloader;num_workers=2": lambda t: t.train_loader.num_workers == 2,
    "trainer;remat=true": lambda t: t.remat,
    "trainer;transfer_dtype=bf16": lambda t: t.transfer_dtype == torch.bfloat16,
    "trainer;numerics=true": lambda t: t.numerics and t.model.numerics,
    "trainer;live_telemetry=0": lambda t: t.live_cfg["port"] == 0,
    "trainer;profile;enabled=true": lambda t: t.profile_cfg["enabled"],
    "trainer;max_bad_steps=2": lambda t: t._guard.max_bad_steps == 2,
    "train_dataloader;dataset;add_noise;enabled=true": lambda t: _one_finite_step(
        t, lambda ds: all(d.dataset.add_noise["enabled"] for d in ds)),
    "train_dataloader;dataset;hot_filter;enabled=true": lambda t: _one_finite_step(
        t, lambda ds: all(d.dataset.hot_filter is not None for d in ds)
        and any(d.dataset.hot_filter.hot_idx > 0 for d in ds)),
    "train_dataloader;dataset;sequence;pause;enabled=true": lambda t: _one_finite_step(
        t, lambda ds: all(d.pause_enabled for d in ds)),
}


# what a case of NOW_PORTED needs beside its key (the reference reads a
# noise level whenever noise is on)
NOW_PORTED_WITH = {"train_dataloader;dataset;add_noise;enabled=true": [
    "train_dataloader;dataset;add_noise;noise_level=0.1"]}


def _one_finite_step(trainer, took):
    """The trainer takes one step on the option's batch: finite losses, and
    the option took effect in the recordings' datasets (``took``)."""
    metrics = trainer.train_step(trainer._select(next(iter(trainer.train_loader))))
    return (all(np.isfinite(metrics[k].numpy()).all() for k in ("loss", "grad_norm"))
            and took(trainer.train_loader.dataset.datasets))
# keys the reference itself refuses: the port raises its error
REFUSED_AS_REFERENCE = {
    "trainer;epoch_based_train;enabled=true": "epoch_based_train is not supported",
}


@pytest.mark.parametrize("override,named", [
    ("trainer;precision=bf16", "trainer;precision=f32"),
    ("trainer;device_rasterize=true", "trainer;device_rasterize=false"),
    ("trainer;remat=true", "trainer;remat=false"),
    ("trainer;transfer_dtype=bf16", "trainer;transfer_dtype=f32"),
    ("trainer;numerics=true", "trainer;numerics=false"),
    ("trainer;live_telemetry=0", "trainer;live_telemetry=false"),
    ("trainer;profile;enabled=true", "trainer;profile;enabled=false"),
    ("trainer;tensorboard=true", "trainer;tensorboard=false"),
    ("trainer;vis;enabled=true", "trainer;vis;enabled=false"),
    ("trainer;epoch_based_train;enabled=true", "trainer;epoch_based_train;enabled=false"),
    ("trainer;max_bad_steps=2", "trainer;max_bad_steps=null"),
    ("train_dataloader;dataset;add_noise;enabled=true", "add_noise"),
    ("train_dataloader;dataset;hot_filter;enabled=true", "hot_filter"),
    ("train_dataloader;dataset;sequence;pause;enabled=true", "sequence.pause"),
    ("train_dataloader;num_workers=2", "num_workers to 0"),
])
def test_unported_keys_raise_naming_the_override(trained, override, named):
    run = _run(trained["out"], trained["corpus"], extra=[override, *NOW_PORTED_WITH.get(
        override, ())], make_dirs=False)
    if override in NOW_PORTED:
        assert NOW_PORTED[override](Trainer(run, device="cpu"))
        return
    if override in REFUSED_AS_REFERENCE:
        with pytest.raises(ValueError, match=REFUSED_AS_REFERENCE[override]):
            Trainer(run, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=re.escape(named)):
        Trainer(run, device="cpu")


def test_trainer_refuses_the_int8_rung(trained):
    """int8 is post-training quantization, not a training rung: the
    trainer's first check (``_refuse_unported``) raises the reference's
    ``ValueError`` for every spelling. bf16 is refused as not ported (no
    oracle while the reference's bf16 backward is red), through ``Trainer``,
    above; a misspelled rung raises too."""
    from esr_tpu_torch.training.trainer import _refuse_unported

    for spelling in ("int8", "w8a8"):
        run = _run(trained["out"], trained["corpus"],
                   extra=[f"trainer;precision={spelling}"], make_dirs=False)
        with pytest.raises(ValueError, match="not a training rung"):
            _refuse_unported(run.config)
    run = _run(trained["out"], trained["corpus"], extra=["trainer;precision=fp8"],
               make_dirs=False)
    with pytest.raises(ValueError, match="unknown precision"):
        _refuse_unported(run.config)


@pytest.mark.gpu
def test_train_step_is_bitwise_run_to_run_on_card():
    """Two train steps of a basech-4 model from the same weights and batch
    on the card: the losses, every gradient and the updated parameters are
    the same bits (the fixed-point gx of ``dcn_bwd``, the upsampling's
    matrix backward, deterministic cuDNN and cuBLAS)."""
    import copy

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the DCN kernels have no CPU mode "
                    "(chip_smoke.py runs the same check at the flagship on the H100)")
    dev = resolve_device("cuda")
    torch.manual_seed(0)
    base = DeepRecurrNet(inch=2, basech=4, num_frame=3).to(dev)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.poisson(0.5, (4, 5, 32, 48, 2)).astype(np.float32)).to(dev)
             for k in ("inp", "gt")}
    runs = []
    for _ in range(2):
        model = copy.deepcopy(base).train()
        opt = torch.optim.Adam(model.parameters(), lr=1e-3, amsgrad=True, weight_decay=1e-4)
        per_window, _ = T_step.window_losses(model, batch, 3)
        per_window.sum().backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        opt.step()
        torch.cuda.synchronize()
        runs.append((per_window.detach(), grads,
                     {n: p.detach().clone() for n, p in model.named_parameters()}))

    def same(a, b):
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))

    assert same(runs[0][0], runs[1][0])
    for i in (1, 2):
        bad = [n for n in runs[0][i] if not same(runs[0][i][n], runs[1][i][n])]
        assert not bad, bad


@pytest.fixture(scope="module")
def card_option_runs(shared_corpus_dir, tmp_path_factory):
    """On the card: the flagship config cut to size with ``add_noise``,
    ``hot_filter`` and ``sequence.pause`` on, ``k_steps`` 2 over 4
    iterations (an eager group, then a replay), run twice; each run's
    logged losses, its graph's replays and its parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the DCN kernels have no CPU mode (chip_smoke.py "
                    "phase 8f runs the same check at the flagship on the H100)")
    extra = ["train_dataloader;dataset;add_noise;enabled=true",
             "train_dataloader;dataset;add_noise;noise_level=0.1",
             "train_dataloader;dataset;hot_filter;enabled=true",
             "train_dataloader;dataset;sequence;pause;enabled=true",
             "trainer;k_steps=2", "trainer;iteration_based_train;valid_step=1000000000"]
    out = tmp_path_factory.mktemp("card_options")
    runs = []
    for name in ("a", "b"):
        trainer = Trainer(_run(out / name, shared_corpus_dir, extra=extra), device="cuda")
        trainer.train()
        with open(trainer.log_path) as f:
            losses = [json.loads(line)["train_loss"] for line in f if "train_loss" in line]
        runs.append((losses, trainer.multi_step.graph.replays,
                     [p.detach().cpu() for p in trainer.model.parameters()]))
    return runs


@pytest.mark.gpu
def test_options_group_is_bitwise_run_to_run_on_card(card_option_runs):
    """The two runs with the data options on: a replayed group each, the
    same losses and parameters, bit for bit."""
    (losses_a, replays_a, params_a), (losses_b, replays_b, params_b) = card_option_runs
    assert replays_a >= 1 and replays_b >= 1
    assert len(losses_a) == 4 and np.isfinite(losses_a).all()
    assert losses_a == losses_b
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(params_a, params_b))


@pytest.fixture(scope="module")
def card_groups():
    """On the card: a basech-4 model trained 3 groups of 3 steps twice from
    the same state, step by step and as super-steps (the first group eager,
    the second captured and replayed, the third replayed); then the
    super-step's model rolled back to its state after group 1 (Adam's
    moments reloaded by ``load_state_dict``: the next group is the warm-up
    again, and the one after captures again) and groups 2 and 3 run again. The losses, parameters and moments
    after each group."""
    import copy

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the DCN kernels and CUDA graphs have no CPU mode "
                    "(chip_smoke.py runs the same checks at the flagship on the H100)")
    from esr_tpu_torch.training.checkpoint import snapshot_state

    dev = resolve_device("cuda")
    torch.manual_seed(0)
    base = DeepRecurrNet(inch=2, basech=4, num_frame=3).to(dev)
    rng = np.random.default_rng(0)
    k = 3
    batches = [{key: torch.from_numpy(rng.poisson(0.5, (4, 5, 32, 48, 2)).astype(np.float32))
                .to(dev) for key in ("inp", "gt")} for _ in range(3 * k)]

    def state(model, opt, losses):
        moments = [{n: v.detach().cpu().clone() for n, v in st.items() if n != "step"}
                   for st in opt.optimizer.state.values()]
        return (losses.detach().cpu().clone(),
                {n: p.detach().cpu().clone() for n, p in model.named_parameters()}, moments)

    def fresh():
        model = copy.deepcopy(base).train()
        opt = T_optim.make_optimizer(
            "Adam", model.parameters(), lr=T_schedule.exponential_with_floor(1e-3, **SCHEDULE),
            weight_decay=1e-4, amsgrad=True)
        return model, opt, T_step.make_train_step(model, opt, seqn=3)

    # the same steps through torch's own Adam (not capturable, a float lr
    # set from the schedule before each update): the capturable form's lr
    # must be the schedule's
    model = copy.deepcopy(base).train()
    schedule = T_schedule.exponential_with_floor(1e-3, **SCHEDULE)
    plain_opt = torch.optim.Adam(model.parameters(), lr=schedule(0), weight_decay=1e-4,
                                 amsgrad=True)
    for i, b in enumerate(batches):
        for group in plain_opt.param_groups:
            group["lr"] = schedule(i)
        plain_opt.zero_grad()
        T_step.window_losses(model, b, 3)[0].sum().backward()
        plain_opt.step()
    plain = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}

    model, opt, step = fresh()
    eager = []
    for g in range(3):
        losses = torch.stack([step(b)["loss"] for b in batches[g * k:(g + 1) * k]])
        eager.append(state(model, opt, losses))
    model, opt, step = fresh()
    multi = T_multi.make_multi_step(step, k, optimizer=opt)

    def group(g):
        for j, b in enumerate(batches[g * k:(g + 1) * k]):
            multi.load(j, b)
        return state(model, opt, multi()["loss"])

    captured, after_first = [], None
    for g in range(3):
        captured.append(group(g))
        if g == 0:
            after_first = snapshot_state(model, opt)
    replays = multi.graph.replays
    convert.load_flax_params(model, after_first[0])
    opt.load_state_dict(after_first[1])
    first_graph = multi.graph
    rolled = [group(1), group(2)]
    return {"eager": eager, "captured": captured, "rolled": rolled, "replays": replays,
            "recaptured": multi.graph is not first_graph, "count": opt.count,
            "plain": plain}


def _same_state(a, b):
    def same(x, y):
        return torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))

    assert same(a[0], b[0])
    assert not [n for n in a[1] if not same(a[1][n], b[1][n])]
    assert len(a[2]) == len(b[2]) == 68
    assert all(same(x[n], y[n]) for x, y in zip(a[2], b[2]) for n in x)


@pytest.mark.gpu
def test_captured_group_is_the_eager_loop_bitwise_on_card(card_groups):
    """Each group's losses, parameters and Adam moments bit for bit those of
    the same steps run one by one; groups 2 and 3 were graph replays."""
    assert card_groups["replays"] == 2
    for eager, captured in zip(card_groups["eager"], card_groups["captured"]):
        _same_state(eager, captured)
    # and the capturable form follows the schedule as torch's float-lr Adam
    # does: the two round differently, so 9 steps apart by f32 rounding only
    # (a stuck lr would be ~1e-4 off)
    for n, p in card_groups["captured"][-1][1].items():
        np.testing.assert_allclose(p.numpy(), card_groups["plain"][n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


@pytest.mark.gpu
def test_replay_after_a_rollback_is_the_eager_loop_bitwise_on_card(card_groups):
    """After the rollback the super-step ran group 2 eagerly, captured again
    and replayed group 3, to the eager loop's bits."""
    assert card_groups["recaptured"] and card_groups["count"] == 9
    for eager, rolled in zip(card_groups["eager"][1:], card_groups["rolled"]):
        _same_state(eager, rolled)


# -- the second shipped recipe: configs/train_srunet_2x.yml -----------------

SR_ARGS = dict(num_frame=3, num_bins=2, num_output_channels=2, base_num_channels=4,
               num_encoders=2, num_residual_blocks=1, skip_type="sum",
               recurrent_block_type="convlstm", kernel_size=5)
SR_H, SR_W = 12, 14  # the model emits 24x28, resized by bicubic to 12x14
SR_STEPS = 2


def _leaf_close(got, want, what, rtol=1e-5):
    """``got`` within ``rtol`` of the scale (max |.|) of ``want``, leaf by
    leaf (flat flax trees or arrays)."""
    if not isinstance(want, dict):
        got, want = {(): got}, {(): want}
    assert set(got) == set(want), what
    for k in want:
        w = np.asarray(want[k], np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(got[k], np.float64) - w).max())
        assert err <= rtol * scale, f"{what} {'/'.join(k)}: {err:.3e} of {scale:.3e}"


@pytest.fixture(scope="module")
def srunet_parity():
    """Two train steps of a small SRUNetRecurrentSeq in both packages from
    the same weights on the same seeded batches (Adam-amsgrad, weight decay
    1e-4, the gated schedule), and the first step's gradients: the
    reference's by ``jax.grad`` of its BPTT loss (the window losses its
    ``make_train_step`` sums), the port's by the backward of
    ``window_losses``."""
    import copy

    resolve_device("cpu")
    rng = np.random.default_rng(3)
    ref = j_get_model("SRUNetRecurrentSeq", **SR_ARGS)
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            np.zeros((1, 3, SR_H, SR_W, 2), np.float32),
                            ref.init_states(1, SR_H, SR_W))

    def draw(leaf):
        bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 0.3
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    params = jax.tree.map(draw, shapes)
    batches = [{k: rng.poisson(0.7, (B, L, SR_H, SR_W, 2)).astype(np.float32)
                for k in ("inp", "gt")} for _ in range(SR_STEPS)]
    opt_kw = dict(weight_decay=1e-4, amsgrad=True)

    def bptt_loss(p, batch):
        states = ref.init_states(B, SR_H, SR_W)
        total = 0.0
        for i in range(L - 2):
            pred, states = ref.apply(p, batch["inp"][:, i:i + 3], states, True)
            total = total + jnp.mean((pred - batch["gt"][:, i + 1]) ** 2)
        return total

    j_grads = jax.jit(jax.grad(bptt_loss))(params, batches[0])
    j_opt = J_optim.make_optimizer(
        "Adam", lr=J_schedule.exponential_with_floor(1e-3, **SCHEDULE), **opt_kw)
    j_step = jax.jit(j_make_train_step(ref, j_opt, seqn=3))
    state = TrainState.create(params, j_opt)
    j_metrics, j_params = [], []
    for batch in batches:
        state, m = j_step(state, batch)
        j_metrics.append({k: np.asarray(v) for k, v in m.items()})
        j_params.append(jax.tree.map(np.asarray, state.params))

    port = t_get_model("SRUNetRecurrentSeq", **SR_ARGS)
    convert.load_flax_params(port, params)
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    graded = copy.deepcopy(port)
    T_step.window_losses(graded, tb[0], 3)[0].sum().backward()
    for p in graded.parameters():
        p.data = p.grad
    t_grads = convert.export_flax_params(graded)
    t_opt = T_optim.make_optimizer(
        "Adam", port.parameters(), lr=T_schedule.exponential_with_floor(1e-3, **SCHEDULE),
        **opt_kw)
    t_step = T_step.make_train_step(port, t_opt, seqn=3)
    t_metrics, t_params = [], []
    for batch in tb:
        t_metrics.append({k: v.numpy() for k, v in t_step(batch).items()})
        t_params.append(convert.export_flax_params(port))
    return {"jax": j_metrics, "port": t_metrics, "jax_params": j_params,
            "port_params": t_params, "jax_grads": j_grads, "port_grads": t_grads,
            "start": params}


@pytest.mark.parametrize("key", ["loss", "loss_per_window", "grad_norm", "last_pred"])
def test_srunet_train_steps_match_reference(srunet_parity, key):
    for j, t in zip(srunet_parity["jax"], srunet_parity["port"]):
        assert t[key].shape == j[key].shape
        _leaf_close(t[key], j[key], key)
    assert srunet_parity["port"][0]["last_pred"].shape == (B, SR_H, SR_W, 2)


def test_srunet_gradients_match_reference(srunet_parity):
    got = convert.flatten_tree(srunet_parity["port_grads"])
    want = convert.flatten_tree(jax.tree.map(np.asarray, srunet_parity["jax_grads"]))
    _leaf_close(got, want, "grad")
    assert len(want) == 26


@pytest.mark.parametrize("step", range(SR_STEPS))
def test_srunet_params_after_adam_match_reference(srunet_parity, step):
    got = convert.flatten_tree(srunet_parity["port_params"][step])
    want = convert.flatten_tree(srunet_parity["jax_params"][step])
    _leaf_close(got, want, f"params after step {step + 1}")
    start = convert.flatten_tree(srunet_parity["start"])
    assert max(float(np.abs(want[k] - start[k]).max()) for k in want) > 1e-4


SR_TINY = [
    "trainer;tensorboard=false", "model;args;base_num_channels=4",
    "model;args;num_encoders=2", "train_dataloader;batch_size=2",
    "valid_dataloader;batch_size=2", "trainer;iteration_based_train;iterations=4",
    "trainer;iteration_based_train;valid_step=2",
    "trainer;iteration_based_train;save_period=2",
    "trainer;iteration_based_train;train_log_step=1",
] + [f"{block};dataset;{k}={v}" for block in ("train_dataloader", "valid_dataloader")
     for k, v in (("ori_scale", "down8"), ("window", 512), ("sliding_window", 256),
                  ("sequence;sequence_length", 5))]

# the same four iterations each way: the plain run, the trainer's runtime
# options together (model-agnostic: they must give the plain run's bits on
# the CPU), and a run whose guard rolls back a NaN group
SR_RUNS = {
    "plain": ["trainer;k_steps=1", "trainer;async_checkpoint=false"],
    "runtime": ["trainer;k_steps=2", "trainer;remat=true", "trainer;async_checkpoint=true",
                "trainer;max_bad_steps=1"],
    "rollback": ["trainer;k_steps=1", "trainer;max_bad_steps=0"],
}


def _sr_run(out, corpus, extra=(), **kw):
    return T_parser.RunConfig.from_args(
        str(REPO / "configs" / "train_srunet_2x.yml"),
        SR_TINY + [f"trainer;output_path={out}",
                   f"train_dataloader;path_to_datalist_txt={corpus / 'datalist2.txt'}",
                   f"valid_dataloader;path_to_datalist_txt={corpus / 'datalist1.txt'}",
                   *extra], runid="run0", seed=5, **kw)


@pytest.fixture(scope="module")
def srunet_trained(shared_corpus_dir, tmp_path_factory):
    """``configs/train_srunet_2x.yml`` cut to base 4, 2 encoders and batch 2,
    trained 4 iterations on the CPU each way of ``SR_RUNS`` (the rollback
    run with a ``nan_loss`` at iteration 2)."""
    out = {}
    for name, extra in SR_RUNS.items():
        run = _sr_run(tmp_path_factory.mktemp(f"srunet_{name}"), shared_corpus_dir, extra)
        trainer = Trainer(run, device="cpu")
        if name == "rollback":
            with installed(FaultPlan([FaultSpec("train_step", 2, "nan_loss")])):
                result = trainer.train()
        else:
            result = trainer.train()
        with open(trainer.log_path) as f:
            log = [json.loads(line) for line in f]
        out[name] = {"run": run, "trainer": trainer, "result": result, "log": log}
    # trainer.numerics: true puts `numerics` into the model's args
    run = _sr_run(tmp_path_factory.mktemp("srunet_numerics"), shared_corpus_dir,
                  ["trainer;numerics=true"])
    out["numerics"] = {"run": run}
    for side, build in (("ref", lambda: j_build_model({
            "name": run.config["model"]["name"],
            "args": {**run.config["model"]["args"], "numerics": True}})),
                        ("port", lambda: Trainer(run, device="cpu"))):
        try:
            build()
            out["numerics"][side] = None
        except TypeError as e:  # the refusal under test, raised in a fixture
            out["numerics"][side] = e
    return out


def test_srunet_recipe_trains_and_its_checkpoint_loads(srunet_trained):
    plain = srunet_trained["plain"]
    trainer, run = plain["trainer"], plain["run"]
    assert isinstance(trainer.model, FrameRecurrentSR)
    assert all(np.isfinite(v) for v in plain["result"].values())
    steps = [r for r in plain["log"] if "train_loss" in r]
    assert [r["iteration"] for r in steps] == [0, 1, 2, 3]
    assert all(np.isfinite(r[k]) for r in steps for k in ("train_loss", "grad_norm"))
    valid = [r for r in plain["log"] if "valid_stamp" in r]
    assert [r["iteration"] for r in valid] == [2] and np.isfinite(valid[0]["valid_loss"])
    ckpt = find_latest_checkpoint(str(Path(run.save_dir).parent))
    assert ckpt.endswith("checkpoint-iteration3")
    model, config = load_checkpoint(ckpt)
    assert config["model"]["name"] == "SRUNetRecurrentSeq"
    assert isinstance(model, FrameRecurrentSR) and model.model.base_num_channels == 4
    batch = next(iter(trainer.valid_loader))
    inp = torch.from_numpy(batch["inp_scaled_cnt"][:, :3])
    states = model.init_states(inp.shape[0], *inp.shape[2:4])
    with torch.no_grad():
        got, _ = model.eval()(inp, states)
        want, _ = trainer.model.eval()(inp, states)
    assert got.shape == inp.shape[:1] + inp.shape[2:]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_srunet_runtime_options_are_the_plain_run(srunet_trained):
    """remat, ``k_steps: 2``, async checkpoints and an armed guard run the
    recipe to the plain run's losses, parameters and checkpoints, bit for
    bit (on the CPU a group is its steps in a loop)."""
    plain, rt = srunet_trained["plain"], srunet_trained["runtime"]
    assert rt["trainer"].remat and rt["trainer"].k_steps == 2
    assert rt["trainer"]._async_ckpt is not None and rt["trainer"]._guard is not None
    losses = [[r["train_loss"] for r in x["log"] if "train_loss" in r] for x in (plain, rt)]
    assert losses[0] == losses[1]
    for (n, p), q in zip(plain["trainer"].model.named_parameters(),
                         rt["trainer"].model.parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), q.detach().numpy(), err_msg=n)
    # the final checkpoints (k_steps 2 saves on its groups: iteration 3
    # covers the save due at 2) hold the same parameters
    a, b = (convert.flatten_tree(read_params(str(Path(x["run"].save_dir)
                                                 / "checkpoint-iteration3")))
            for x in (plain, rt))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_srunet_guard_rolls_back_a_nan_group(srunet_trained):
    rb = srunet_trained["rollback"]
    assert rb["trainer"]._guard.rollbacks == 1
    assert all(np.isfinite(v) for v in rb["result"].values())
    for p in rb["trainer"].model.parameters():
        assert bool(torch.isfinite(p).all())


def test_srunet_numerics_refused_as_the_reference(srunet_trained):
    """``trainer.numerics: true`` puts ``numerics`` into the model's args;
    the reference's UNets have no probe taps and raise ``TypeError`` there
    (its trainer builds the model the same way), and so does the port's
    trainer."""
    errors = srunet_trained["numerics"]
    for side in ("ref", "port"):
        assert isinstance(errors[side], TypeError), (side, errors[side])
        assert "numerics" in str(errors[side])


@pytest.mark.gpu
def test_srunet_bicubic_backward_is_bitwise_run_to_run_on_card():
    """The adapter's bicubic resize (180x320 -> 90x160 at batch 8) through
    ``ops.resize.resize``: its backward on the card the same bits twice,
    and within 1e-6 of the CPU's."""
    from esr_tpu_torch.ops.resize import resize

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the recipe's step on the H100)")
    dev = resolve_device("cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 2, 180, 320)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((8, 2, 90, 160)).astype(np.float32))
    grads = []
    for d in (dev, dev, torch.device("cpu")):
        xt = x.to(d).requires_grad_(True)
        (resize(xt, (90, 160), "bicubic") * g.to(d)).sum().backward()
        grads.append(xt.grad.cpu())
    assert torch.equal(grads[0].view(torch.int32), grads[1].view(torch.int32))
    np.testing.assert_allclose(grads[0].numpy(), grads[2].numpy(), atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def srunet_card_groups():
    """On the card: a small SRUNetRecurrentSeq trained 3 groups of 3 steps
    step by step and as super-steps (the first eager, then captured and
    replayed): each group's losses, parameters and Adam moments."""
    import copy

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode (chip_smoke.py runs "
                    "the recipe's k_steps 8 group on the H100)")
    dev = resolve_device("cuda")
    torch.manual_seed(0)
    base = t_get_model("SRUNetRecurrentSeq", **SR_ARGS).to(dev)
    rng = np.random.default_rng(0)
    k = 3
    batches = [{key: torch.from_numpy(rng.poisson(0.5, (4, 5, 32, 48, 2))
                                      .astype(np.float32)).to(dev) for key in ("inp", "gt")}
               for _ in range(3 * k)]

    def fresh():
        model = copy.deepcopy(base).train()
        opt = T_optim.make_optimizer(
            "Adam", model.parameters(), lr=T_schedule.exponential_with_floor(1e-3, **SCHEDULE),
            weight_decay=1e-4, amsgrad=True)
        return model, opt, T_step.make_train_step(model, opt, seqn=3)

    def state(model, opt, losses):
        return ([losses.detach().clone()] + [p.detach().clone() for p in model.parameters()]
                + [v.detach().clone() for st in opt.optimizer.state.values()
                   for n, v in sorted(st.items()) if n != "step"])

    model, opt, step = fresh()
    eager = [state(model, opt, torch.stack([step(b)["loss"] for b in batches[g * k:(g + 1) * k]]))
             for g in range(3)]
    model, opt, step = fresh()
    multi = T_multi.make_multi_step(step, k, optimizer=opt)
    captured = []
    for g in range(3):
        for j, b in enumerate(batches[g * k:(g + 1) * k]):
            multi.load(j, b)
        captured.append(state(model, opt, multi()["loss"]))
    return {"eager": eager, "captured": captured, "replays": multi.graph and multi.graph.replays,
            "n_params": len(list(base.parameters()))}


@pytest.mark.gpu
def test_srunet_captured_group_is_the_eager_loop_bitwise_on_card(srunet_card_groups):
    """Each group's losses, parameters and Adam moments bit for bit those of
    the same steps run one by one; groups 2 and 3 were graph replays."""
    g = srunet_card_groups
    assert g["replays"] == 2
    for e, c in zip(g["eager"], g["captured"]):
        # the losses, the parameters, Adam-amsgrad's three moments of each
        assert len(e) == len(c) == 1 + 4 * g["n_params"]
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(e, c))


# -- data parallelism (train --multihost) ------------------------------------
#
# configs/train_srunet_2x.yml cut as SR_TINY, with norm BN (its moments are
# the global batch's) and async checkpoints (the recipe's), from the
# reference trainer's initial weights: two gloo processes of the port's
# trainer at batch 2 each (`torch.distributed.run ... --multihost --device
# cpu`: 2 steps, a validation, a checkpoint, then `-r auto` one step more)
# against the port in one process at the global batch of 4 and the
# reference's Trainer on a 2-device mesh at 4. Losses, validation losses
# and grad norms within rtol 1e-5; parameters and running statistics after
# Adam within 1e-5 of each leaf's scale against the port (`_leaf_close`) and
# rtol 2e-3 + atol 1e-6 against the reference; the processes' states the
# same bits at every save (the trainer's gathered digest).

DP = ["model;args;norm=BN", "trainer;k_steps=1", "train_dataloader;batch_size=4",
      "valid_dataloader;batch_size=4", "trainer;iteration_based_train;iterations=2",
      "trainer;iteration_based_train;valid_step=1",
      "trainer;iteration_based_train;save_period=1"]
DP_TIMEOUT_S = 120


def _torchrun(nproc, run_args, timeout=DP_TIMEOUT_S):
    """``python -m torch.distributed.run --standalone`` of the port's
    trainer in ``nproc`` gloo processes, one torch thread each; the launcher
    and its workers are killed together on a timeout."""
    import os
    import signal
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", "esr_tpu_torch.train", *run_args,
           "--multihost", "--device", "cpu"]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
    assert proc.returncode == 0, err[-4000:]
    return out, err


def _sr_args(out, corpus, extra):
    args = ["-c", str(REPO / "configs" / "train_srunet_2x.yml"), "-id", "run0", "-seed", "5"]
    for ov in SR_TINY + [f"trainer;output_path={out}",
                         f"train_dataloader;path_to_datalist_txt={corpus / 'datalist2.txt'}",
                         f"valid_dataloader;path_to_datalist_txt={corpus / 'datalist1.txt'}",
                         *extra]:
        args += ["-o", ov]
    return args


def _ckpt(run_dir, iteration):
    path = Path(run_dir) / f"checkpoint-iteration{iteration}"
    return {"params": convert.flatten_tree(read_params(str(path))),
            "optimizer": torch.load(path / "optimizer.pt")}


def _train_log(log_dir):
    with open(Path(log_dir) / "train_log.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def dp_runs(shared_corpus_dir, tmp_path_factory):
    from esr_tpu.parallel.mesh import make_mesh
    from esr_tpu.training.trainer import Trainer as RefTrainer
    from esr_tpu_torch.training.checkpoint import save_checkpoint as t_save_checkpoint

    out = tmp_path_factory.mktemp("dp")
    corpus = shared_corpus_dir
    ref = RefTrainer(J_parser.RunConfig.from_args(
        str(REPO / "configs" / "train_srunet_2x.yml"),
        SR_TINY + DP + [f"trainer;output_path={out / 'ref'}",
                        f"train_dataloader;path_to_datalist_txt={corpus / 'datalist2.txt'}",
                        f"valid_dataloader;path_to_datalist_txt={corpus / 'datalist1.txt'}"],
        runid="run0", seed=5), mesh=make_mesh(jax.devices()[:2]))
    start = jax.tree.map(np.asarray, ref.state.params)
    ref.train()
    with open(Path(ref.run.log_dir) / "metrics.jsonl") as f:
        ref_losses = [r["value"] for r in map(json.loads, f) if r["tag"] == "train_loss/train"]

    # the port in one process at the global batch, from the same weights;
    # its fresh state is also the two processes' starting checkpoint
    one = Trainer(_sr_run(out / "one", corpus, DP), device="cpu")
    convert.load_flax_params(one.model, start)
    init = t_save_checkpoint(str(out / "init"), one.model, one.optimizer, one.run.config, 0,
                             float("inf"))
    one.train()
    one_resumed = Trainer(_sr_run(out / "one", corpus, DP + [
        "trainer;iteration_based_train;iterations=3"], resume="auto"), device="cpu")
    one_resumed.train()

    # batch_size is per process: 2 each, the global batch 4
    two = DP + ["train_dataloader;batch_size=2", "valid_dataloader;batch_size=2"]
    first = _torchrun(2, _sr_args(out / "two", corpus, two) + ["-r", init, "--reset"])
    second = _torchrun(2, _sr_args(out / "two", corpus, two + [
        "trainer;iteration_based_train;iterations=3"]) + ["-r", "auto"])
    two_dir = out / "two" / "models" / "SRUNetRecurrent2x" / "run0"
    return {"ref": {"losses": ref_losses,
                    "params": convert.flatten_tree(jax.tree.map(np.asarray, ref.state.params))},
            "one": {"log": _train_log(one.run.log_dir), "run": Path(one.run.save_dir)},
            "two": {"log": _train_log(out / "two" / "logs" / "SRUNetRecurrent2x" / "run0"),
                    "run": two_dir, "runs": (first, second)}}


def test_data_parallel_metrics_are_the_global_batchs(dp_runs):
    one, two = dp_runs["one"]["log"], dp_runs["two"]["log"]
    keys = ("train_loss", "train_mse_loss", "grad_norm")
    steps = [[r for r in log if "train_loss" in r] for log in (one, two)]
    assert [r["iteration"] for r in steps[1]] == [r["iteration"] for r in steps[0]] == [0, 1, 2]
    for a, b in zip(*steps):
        for k in keys:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    # the resumed step's loss aside, the first two against the reference's
    np.testing.assert_allclose([r["train_loss"] for r in steps[1][:2]],
                               dp_runs["ref"]["losses"], rtol=1e-5)
    valid = [[r for r in log if "valid_stamp" in r] for log in (one, two)]
    assert [r["iteration"] for r in valid[1]] == [1, 2]
    for a, b in zip(*valid):
        for k in ("valid_loss", "valid_mse_loss"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("iteration", [1, 2])
def test_data_parallel_state_is_one_process_at_the_global_batch(dp_runs, iteration):
    two = _ckpt(dp_runs["two"]["run"], iteration)
    one = _ckpt(dp_runs["one"]["run"], iteration)
    _leaf_close(two["params"], one["params"], f"params at {iteration}")
    assert any(k[0] == "batch_stats" for k in two["params"])
    moments = lambda s: {(i, m): np.asarray(v[m]) for i, v in s["state"].items()
                         for m in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")}
    _leaf_close(moments(two["optimizer"]["optimizer"]), moments(one["optimizer"]["optimizer"]),
                "Adam moments")
    if iteration == 1:
        ref = dp_runs["ref"]["params"]
        assert set(two["params"]) == set(ref)
        for k in ref:
            np.testing.assert_allclose(two["params"][k], ref[k], rtol=2e-3, atol=1e-6,
                                       err_msg="/".join(k))


def test_data_parallel_ranks_agree_and_rank_zero_writes_once(dp_runs):
    run_dir = dp_runs["two"]["run"]
    for (out, err), iters in zip(dp_runs["two"]["runs"], ([1], [2])):
        # one final line, rank 0's
        assert len([line for line in out.splitlines() if line.startswith("{")]) == 1
        for it in iters:
            assert len(re.findall(rf"replicas' states agree at iteration {it} ", err)) == 1
            assert len(re.findall(rf"Saved checkpoint: \S+checkpoint-iteration{it}\n",
                                  err)) == 1
        assert "dispatch_retries disabled under data parallelism" in err
    assert sorted(p.name for p in run_dir.iterdir() if p.is_dir()) == [
        "checkpoint-iteration1", "checkpoint-iteration2", "model_best_until_iteration1",
        "model_best_until_iteration2"]


def test_world_one_group_is_the_no_group_step_bitwise(tmp_path):
    """A gloo group of one (``train --multihost`` at world 1) runs every
    collective of the step, the gradient all-reduce and the metrics' and
    probes' reductions among them, to the same bits as no group: the
    flagship with its numerics probes, and the SR recipe's model with BN."""
    import torch.distributed as dist

    from esr_tpu_torch.parallel import mesh

    rng = np.random.default_rng(21)
    batches = [{k: torch.from_numpy(rng.poisson(0.7, (B, L, SR_H, SR_W, 2)).astype(np.float32))
                for k in ("inp", "gt")} for _ in range(2)]
    builds = {"flagship": lambda: DeepRecurrNet(inch=2, basech=2, num_frame=3, numerics=True),
              "srunet_bn": lambda: t_get_model("SRUNetRecurrentSeq", **SR_ARGS, norm="BN")}

    def run(build):
        torch.manual_seed(0)
        model = build()
        opt = T_optim.make_optimizer("Adam", model.parameters(), lr=lambda step: 1e-3,
                                     weight_decay=1e-4, amsgrad=True)
        step = T_step.make_train_step(model, opt, seqn=3, numerics=True)
        metrics = [step(b) for b in batches]
        return metrics, convert.export_flax_params(model)

    def same(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                same(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    alone = {name: run(build) for name, build in builds.items()}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        assert mesh.process_shard_info() == (0, 1) and mesh.is_distributed()
        grouped = {name: run(build) for name, build in builds.items()}
    finally:
        dist.destroy_process_group()
    for name in builds:
        for a, b in zip(alone[name][0], grouped[name][0]):
            same(a, b)
        same(alone[name][1], grouped[name][1])
    assert "batch_stats" in alone["srunet_bn"][1]


@pytest.fixture(scope="module")
def bn_remat():
    """Two BPTT steps of the SR recipe's model with BN under ``remat`` in
    both packages from the same variables (running statistics drawn away
    from their defaults), and the port's without remat."""
    ref = j_get_model("SRUNetRecurrentSeq", **SR_ARGS, norm="BN")
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            np.zeros((1, 3, SR_H, SR_W, 2), np.float32),
                            ref.init_states(1, SR_H, SR_W))
    rng = np.random.default_rng(5)

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if key.endswith("['var']") or key.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 0.3
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    batches = [{k: rng.poisson(0.7, (B, L, SR_H, SR_W, 2)).astype(np.float32)
                for k in ("inp", "gt")} for _ in range(SR_STEPS)]
    j_opt = J_optim.make_optimizer("Adam", lr=1e-3, weight_decay=1e-4, amsgrad=True)
    j_step = jax.jit(j_make_train_step(ref, j_opt, seqn=3, remat=True))
    state = TrainState.create(variables, j_opt)
    for batch in batches:
        state, _ = j_step(state, batch)
    out = {"jax": convert.flatten_tree(jax.tree.map(np.asarray, state.params)),
           "start": convert.flatten_tree(variables)}
    for remat in (True, False):
        port = t_get_model("SRUNetRecurrentSeq", **SR_ARGS, norm="BN")
        convert.load_flax_params(port, variables)
        t_opt = T_optim.make_optimizer("Adam", port.parameters(), lr=lambda step: 1e-3,
                                       weight_decay=1e-4, amsgrad=True)
        t_step = T_step.make_train_step(port, t_opt, seqn=3, remat=remat)
        for batch in batches:
            t_step({k: torch.from_numpy(v) for k, v in batch.items()})
        out[remat] = convert.flatten_tree(convert.export_flax_params(port))
    return out


def test_bn_remat_updates_the_running_stats_once_as_the_reference(bn_remat):
    """``remat`` recomputes each window's forward in the backward; the
    running statistics are updated by the forward alone (the reference's
    ``jax.checkpoint`` is pure): the port's statistics and parameters after
    two steps are the reference's, and bitwise the port's without remat."""
    got, want = bn_remat[True], bn_remat["jax"]
    stats = [k for k in want if k[0] == "batch_stats"]
    assert len(stats) >= 8
    _leaf_close({k: got[k] for k in stats}, {k: want[k] for k in stats}, "batch_stats")
    assert any(not np.array_equal(want[k], bn_remat["start"][k]) for k in stats)
    params = [k for k in want if k[0] == "params"]
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=1e-6, err_msg="/".join(k))
    for k in want:
        np.testing.assert_array_equal(got[k], bn_remat[False][k], err_msg="/".join(k))


# -- tensor parallelism (parallel.tensor) -----------------------------------
#
# The flagship at tests/test_tensor_parallel.py's size (inch 2, basech 8,
# num_frame 3; B 8, L 4, 16x16; Adam-amsgrad lr 1e-3, wd 1e-4; seqn 3) from
# the reference's own initial weights: four gloo processes, one torch
# thread each, run the port's tensor-parallel step at (data 2, model 2) and
# (data 1, model 4), two steps each on the same global batch, against the
# reference's single-device step (the JAX test pins its tensor-parallel
# step to the replicated one at rtol 1e-5). Losses rtol 1e-5, parameters
# gathered from the shards rtol 2e-3 + atol 1e-6 (this file's bound).

TP_MESHES = ["2x2", "1x4"]
TP_B, TP_L, TP_H, TP_W = 8, 4, 16, 16
TP_TIMEOUT_S = 180
TP_WORKER = '''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

from esr_tpu_torch.models import convert
from esr_tpu_torch.models.esr import DeepRecurrNet
from esr_tpu_torch.parallel import tensor as tp
from esr_tpu_torch.training import optim

torch.set_num_threads(1)
root = sys.argv[1]
dist.init_process_group("gloo")
rank = dist.get_rank()
tree = {}
for key, arr in np.load(root + "/params.npz").items():
    node = tree
    *parents, leaf = key.split("/")
    for name in parents:
        node = node.setdefault(name, {})
    node[leaf] = arr
batch = {k: torch.from_numpy(v) for k, v in np.load(root + "/batch.npz").items()}
report = {}
for data in (2, 1):
    mesh = tp.make_tp_mesh(data=data, device="cpu")
    model = DeepRecurrNet(inch=2, basech=8, num_frame=3)
    convert.load_flax_params(model, tree)
    opt = optim.make_optimizer("Adam", model.parameters(), lr=1e-3, weight_decay=1e-4,
                               amsgrad=True)
    step = tp.make_tp_train_step(model, opt, mesh, seqn=3)
    losses = [float(step(batch)["loss"]) for _ in range(2)]
    state = opt.optimizer.state
    shapes = {n: [list(p.shape)] + [list(state[p][k].shape)
                                    for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")]
              for n, p in model.named_parameters()}
    full = tp.gather_params(model)
    key = f"{mesh.data}x{mesh.model}"
    report[key] = {"losses": losses, "shapes": shapes,
                   "coords": [mesh.data_index, mesh.model_index]}
    if rank == 0:
        whole = DeepRecurrNet(inch=2, basech=8, num_frame=3)
        whole.load_state_dict(full)
        flat = convert.flatten_tree(convert.export_flax_params(whole))
        np.savez(f"{root}/params_{key}.npz", **{"/".join(k): v for k, v in flat.items()})
with open(f"{root}/rank{rank}.json", "w") as f:
    json.dump(report, f)
dist.destroy_process_group()
'''


def _torchrun_script(nproc, script, args, timeout):
    """``python -m torch.distributed.run --standalone`` of ``script`` in
    ``nproc`` processes, one torch thread each; killed together on a
    timeout."""
    import os
    import signal
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(script), *args]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def join():
        try:
            out, err = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
        assert proc.returncode == 0, err[-4000:]
        return out, err

    return join


def _jax_flagship_tp_setup():
    """The reference's flagship, its initial parameters and the batch of
    tests/test_tensor_parallel.py."""
    model = FlaxNet(inch=2, basech=8, num_frame=3, dcn_impl="jnp")
    rng = np.random.default_rng(0)
    batch = {k: rng.random((TP_B, TP_L, TP_H, TP_W, 2)).astype(np.float32)
             for k in ("inp", "gt")}
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(batch["inp"][:, :3]),
                        model.init_states(TP_B, TP_H, TP_W))
    return model, jax.tree.map(np.asarray, params), batch


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    model, params, batch = _jax_flagship_tp_setup()
    np.savez(root / "params.npz", **{"/".join(k): v
                                     for k, v in convert.flatten_tree(params).items()})
    np.savez(root / "batch.npz", **batch)
    (root / "tp_worker.py").write_text(TP_WORKER)
    join = _torchrun_script(4, root / "tp_worker.py", [str(root)], TP_TIMEOUT_S)
    # the reference's replicated step, while the four processes run
    opt = J_optim.make_optimizer("Adam", lr=1e-3, weight_decay=1e-4, amsgrad=True)
    step = jax.jit(j_make_train_step(model, opt, seqn=3))
    state = TrainState.create(params, opt)
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    join()
    ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(4)]
    return {"ref": {"losses": losses,
                    "params": convert.flatten_tree(jax.tree.map(np.asarray, state.params))},
            "start": convert.flatten_tree(params), "ranks": ranks,
            "params": {m: {tuple(k.split("/")): v for k, v in np.load(root / f"params_{m}.npz").items()}
                       for m in TP_MESHES}}


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tensor_parallel_losses_are_the_replicated_steps(tp_runs, mesh):
    want = tp_runs["ref"]["losses"]
    for r in tp_runs["ranks"]:
        np.testing.assert_allclose(r[mesh]["losses"], want, rtol=1e-5)
    assert want[1] < want[0] and tp_runs["ranks"][0][mesh]["losses"][1] < want[0]


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tensor_parallel_parameters_gathered_after_two_steps(tp_runs, mesh):
    got, want = tp_runs["params"][mesh], tp_runs["ref"]["params"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=1e-6, err_msg="/".join(k))
    assert any(not np.array_equal(want[k], tp_runs["start"][k]) for k in want)


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tensor_parallel_state_stays_model_sharded(tp_runs, mesh):
    """Every rank holds its slice of a leaf the reference's rule splits
    (trailing flax axis divisible by the model axis), parameters and the
    three Adam moments alike, at its place on the grid; the rest whole."""
    data, model = map(int, mesh.split("x"))
    whole = DeepRecurrNet(inch=2, basech=8, num_frame=3)
    flat = convert.flatten_tree(convert.export_flax_params(whole))
    names = {id(p): n for n, p in whole.named_parameters()}
    flax_shape = {names[id(t)]: flat[path].shape for path, t, _ in convert.flax_leaves(whole)}
    split = 0
    for rank, r in enumerate(tp_runs["ranks"]):
        assert r[mesh]["coords"] == [rank // model, rank % model]
        for name, p in whole.named_parameters():
            want = list(p.shape)
            trailing = flax_shape[name][-1]
            if trailing % model == 0 and trailing >= model:
                dim = 3 if name.endswith("dcn_weight") else 0
                want[dim] //= model
                split += rank == 0
            assert r[mesh]["shapes"][name] == [want] * 4, name
    # the reference's plan splits 240 / 224 of the TrainState's leaves at
    # model 2 / 4: each parameter with its three Adam moments
    assert split == {2: 60, 4: 56}[model]


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_plan_names_the_references_sharded_leaves(tp):
    from esr_tpu.parallel.tensor import channel_shardings as j_channel_shardings
    from esr_tpu.parallel.tensor import make_tp_mesh as j_make_tp_mesh
    from esr_tpu_torch.parallel import tensor as T_tp

    model, params, _ = _jax_flagship_tp_setup()
    j_mesh = j_make_tp_mesh(jax.devices(), data=8 // tp)
    specs = jax.tree_util.tree_flatten_with_path(j_channel_shardings(params, j_mesh))[0]
    want = {tuple(getattr(k, "key", k) for k in path) for path, sh in specs
            if sh.spec and sh.spec[-1] == "model"}
    plan = T_tp.channel_shardings(DeepRecurrNet(inch=2, basech=8, num_frame=3),
                                  T_tp.TPMesh(8 // tp, tp, 0, 0))
    got = {leaf.flax_path for leaf in plan.values() if leaf.sharded}
    assert got == want
    assert (len(got) == 0) == (tp == 1)
    dims = {leaf.flax_path[-1]: leaf.dim for leaf in plan.values() if leaf.sharded}
    assert tp == 1 or dims == {"kernel": 0, "bias": 0, "dcn_weight": 3, "dcn_bias": 0}


def test_tp_refuses_unknown_layers_and_meshes_that_do_not_split():
    from esr_tpu_torch.parallel import tensor as T_tp

    mesh = T_tp.TPMesh(1, 2, 0, 0)
    for norm, layer in ((None, "Conv2d at params/"), ("BN", "TorchBatchNorm at params/")):
        model = t_get_model("SRUNetRecurrentSeq", **SR_ARGS, norm=norm)
        opt = T_optim.make_optimizer("Adam", model.parameters(), lr=1e-3)
        before = {n: p.shape for n, p in model.named_parameters()}
        with pytest.raises(NotImplementedError, match=layer) as err:
            T_tp.shard_state_tp(model, opt, mesh)
        assert "ConvLSTMCell_0" in str(err.value) or norm == "BN"
        assert {n: p.shape for n, p in model.named_parameters()} == before
    with pytest.raises(ValueError, match="data=3"):
        T_tp.make_tp_mesh(data=3, device="cpu")
    with pytest.raises(ValueError, match="2 processes"):
        T_tp.make_tp_mesh(world=2, data=1, device="cpu")


@pytest.fixture(scope="module")
def tp_without_a_group():
    """Two steps of the tensor-parallel step on one process (no group) and
    of the plain step, from the same weights and batch: the losses and the
    parameters of each."""
    from esr_tpu_torch.parallel import tensor as T_tp

    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.random((2, 4, 16, 16, 2)).astype(np.float32))
             for k in ("inp", "gt")}
    runs = []
    for tp_step in (True, False):
        torch.manual_seed(0)
        model = DeepRecurrNet(inch=2, basech=4, num_frame=3)
        opt = T_optim.make_optimizer("Adam", model.parameters(), lr=1e-3, weight_decay=1e-4)
        step = (T_tp.make_tp_train_step(model, opt, T_tp.make_tp_mesh(data=1, device="cpu"))
                if tp_step else T_step.make_train_step(model, opt))
        losses = [step(batch)["loss"] for _ in range(2)]
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    return runs


def test_tp_step_without_a_group_is_the_plain_step_bitwise(tp_without_a_group):
    """One process: the mesh is (1, 1), the plan splits nothing, and the
    tensor-parallel step is the plain step to the bit."""
    (tp_losses, tp_params), (losses, params) = tp_without_a_group
    for a, b in zip(tp_losses + tp_params, losses + params):
        assert torch.equal(a, b)
