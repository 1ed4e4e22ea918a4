"""The port stands alone: ``esr_tpu_torch`` imports no JAX, nothing of
``esr_tpu`` and no PyYAML, loads ``h5py`` only when a recording is opened,
and its entry points (evaluation and training) run on the card unless the
CPU is asked for by name. The reference's thread audit
(``esr_tpu.analysis.concurrency``, pure AST) finds nothing over it."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import esr_tpu_torch
from esr_tpu_torch import train
from esr_tpu_torch.device import resolve_device
from esr_tpu_torch.inference.harness import InferenceRunner
from esr_tpu_torch.models.esr import DeepRecurrNet

PKG = Path(esr_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "esr_tpu", "yaml")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_package_imports_no_jax_and_no_reference():
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    assert len(files) > 15
    # the serving tier and the engine are scanned too
    names = {str(f.relative_to(PKG)) for f in files if PKG in f.parents}
    assert {"serving/server.py", "serving/scheduler.py", "serving/wire.py",
            "serving/loadgen.py", "resilience/recovery.py", "inference/engine.py",
            "serving/fleet.py", "serving/replica.py", "resilience/faults.py",
            "resilience/chaos_fleet.py", "obs/sink.py", "obs/report.py", "obs/http.py",
            "obs/fleetview.py", "obs/aggregate.py",
            "serve.py", "native.py", "ops/encodings.py", "utils/writer.py",
            "utils/vis_events.py", "config/precision.py", "config/quantize.py",
            "ops/int8_cuda.py"} <= names
    bad = {str(f.relative_to(PKG.parent)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_thread_audit_over_the_port_is_clean_and_models_the_commit_writer():
    import ast as _ast

    from esr_tpu.analysis.concurrency import audit_concurrency, extract_module_model
    from esr_tpu.analysis.core import ModuleContext

    audit = audit_concurrency([str(PKG)], relative_to=str(PKG.parent))
    assert [f"{f.rule} {f.path}:{f.line} {f.message}" for f in audit.findings] == []
    model = audit.model
    assert model["files"] == len(list(PKG.rglob("*.py")))
    # the loader's two worker pools, the prefetcher's producer, the memory
    # watermark poller, the live plane's and the fleet view's HTTP servers,
    # the fleet supervisor, and the checkpoint writer
    assert model["threads_modeled"] == 8 and model["classes_modeled"] == 7
    path = PKG / "training" / "async_checkpoint.py"
    ctx = ModuleContext(str(path), path.read_text(), rel_path="training/async_checkpoint.py")
    writer = {m.name: m for m in extract_module_model(ctx)}["AsyncCheckpointer"]
    (spawn,) = writer.spawns
    name = next(k.value for k in spawn.node.keywords if k.arg == "name")
    assert (spawn.kind, spawn.target, spawn.daemon, spawn.store) == (
        "thread", "self._commit", True, "self._thread")
    assert isinstance(name, _ast.Constant) and name.value == "ckpt-commit"
    assert writer.entries == {"_commit": "thread:_commit"}


def test_importing_the_harness_loads_no_jax_and_no_h5py():
    code = (
        "import sys, esr_tpu_torch.inference.harness, esr_tpu_torch.infer, "
        "esr_tpu_torch.ops.dcn_cuda, esr_tpu_torch.train, "
        "esr_tpu_torch.training.trainer, esr_tpu_torch.config.build, "
        "esr_tpu_torch.serving.server, esr_tpu_torch.serving.wire, "
        "esr_tpu_torch.serving.loadgen, esr_tpu_torch.serve, "
        "esr_tpu_torch.inference.engine, esr_tpu_torch.native, "
        "esr_tpu_torch.ops.encodings, esr_tpu_torch.utils.writer, "
        "esr_tpu_torch.utils.vis_events, esr_tpu_torch.data.np_encodings, "
        "esr_tpu_torch.config.precision, esr_tpu_torch.config.quantize, "
        "esr_tpu_torch.ops.int8_cuda, esr_tpu_torch.obs, esr_tpu_torch.obs.report, "
        "esr_tpu_torch.obs.http, esr_tpu_torch.serving.fleet, esr_tpu_torch.serving.replica, "
        "esr_tpu_torch.resilience.chaos_fleet\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'esr_tpu', 'h5py', 'triton', 'yaml', "
        "'tensorboard', 'cv2', 'PIL', 'matplotlib')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(PKG.parent))
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card refusal cannot be shown")


def test_cuda_is_the_default_and_never_falls_back(no_card, tmp_path, monkeypatch):
    monkeypatch.chdir(PKG.parent)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        InferenceRunner(DeepRecurrNet(inch=2, basech=2, num_frame=3), 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["-c", "configs/train_esr_2x.yml", "-o", "trainer;tensorboard=false",
                    "-o", "trainer;vis;enabled=false", "-o", f"trainer;output_path={tmp_path}"])
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
