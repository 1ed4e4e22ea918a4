"""The port's training against the JAX package's, on the CPU: the gated LR
schedule, the optimizers, three BPTT train steps and the eval step on the
same converted weights and seeded batches, the YAML reader against
``yaml.safe_load``, and the port's trainer end to end (checkpoint commit,
inference load, ``-r auto`` resume, the flagship config as written with
its writer and visualizations, refusals of unported keys).

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
from esr_tpu.models.esr import DeepRecurrNet as FlaxNet
from esr_tpu.training import optim as J_optim
from esr_tpu.training import schedule as J_schedule
from esr_tpu.training.train_step import TrainState
from esr_tpu.training.train_step import make_eval_step as j_make_eval_step
from esr_tpu.training.train_step import make_train_step as j_make_train_step
from esr_tpu_torch import train as T_train
from esr_tpu_torch.config import parser as T_parser
from esr_tpu_torch.device import resolve_device
from esr_tpu_torch.inference.checkpoint import load_checkpoint
from esr_tpu_torch.models import convert
from esr_tpu_torch.models.esr import DeepRecurrNet
from esr_tpu_torch.training import optim as T_optim
from esr_tpu_torch.training import schedule as T_schedule
from esr_tpu_torch.training import train_step as T_step
from esr_tpu_torch.training.checkpoint import find_latest_checkpoint
from esr_tpu_torch.training.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
CONFIGS = ["train_esr_2x.yml", "train_esr_4x.yml", "train_srunet_2x.yml"]
B, L, H, W, STEPS = 2, 5, 16, 20, 3
SCHEDULE = dict(gamma=0.5, change_rate=1, floor=1e-4)


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
    return {"jax": j_metrics, "port": t_metrics, "jax_params": state.params,
            "port_params": convert.export_flax_params(port), "jax_eval": j_eval,
            "port_eval": t_eval, "start": params}


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
] + [f"{block};dataset;{k}={v}" for block in ("train_dataloader", "valid_dataloader")
     for k, v in (("ori_scale", "down8"), ("window", 512), ("sliding_window", 256),
                  ("sequence;sequence_length", 5))]


def _run(out, corpus, extra=(), **kw):
    overrides = TINY + [
        f"trainer;output_path={out}",
        f"train_dataloader;path_to_datalist_txt={corpus / 'datalist2.txt'}",
        f"valid_dataloader;path_to_datalist_txt={corpus / 'datalist1.txt'}",
        *extra]
    return T_parser.RunConfig.from_args(str(REPO / "configs" / "train_esr_2x.yml"),
                                        overrides, runid="run0", seed=5, **kw)


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
        assert sorted(files) == ["config.json", "meta.json", "optimizer.pt", "params.npz"]
        assert files["meta.json"] >= max(files.values())
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


# keys this test pinned as unported until the port took them up: each such
# case now checks that the key takes effect
NOW_PORTED = {
    "trainer;device_rasterize=true": lambda t: (
        t.device_rasterize and "inp_norm_events" in t.train_loader.dataset.config["item_keys"]),
    "trainer;tensorboard=true": lambda t: t.tensorboard,
    "trainer;vis;enabled=true": lambda t: (
        t.vis_enabled and "gt_img" in t.vis_dataset.config["item_keys"]),
    "train_dataloader;num_workers=2": lambda t: t.train_loader.num_workers == 2,
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
    ("train_dataloader;num_workers=2", "num_workers to 0"),
])
def test_unported_keys_raise_naming_the_override(trained, override, named):
    run = _run(trained["out"], trained["corpus"], extra=[override], make_dirs=False)
    if override in NOW_PORTED:
        assert NOW_PORTED[override](Trainer(run, device="cpu"))
        return
    with pytest.raises(NotImplementedError, match=re.escape(named)):
        Trainer(run, device="cpu")
