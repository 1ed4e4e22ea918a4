"""The hand-written CUDA DCNv2 forward kernel and its wrapper.

Replaces the TPU kernel ``esr_tpu/ops/dcn_pallas.py:_dcn_fwd_kernel``; the
source, its design and its bound are in ``esr_tpu_torch/csrc/dcn_fwd.cu``.

The kernel is compiled on first use with ``nvcc`` into a shared library with
a plain C interface under ``esr_tpu_torch/_build/`` (named by a hash of the
source and flags, so a changed source never meets a stale build) and bound
with ``ctypes``. Nothing is imported or built when this module is imported.

:data:`dcn_fwd` is the wrapper, and the one place where the device decides
the path. For CUDA tensors it launches the kernel on the current stream, or
raises; for CPU tensors it computes the plain PyTorch version
(``esr_tpu_torch.ops.dcn.deform_conv2d``); any other device raises.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from esr_tpu_torch.ops import dcn as _plain

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dcn_fwd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the default dynamic shared-memory limit, and the most a Hopper block can opt into
_SMEM_DEFAULT = 48 * 1024
_SMEM_MAX = 232448


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the DCN kernel cannot be built")
    return nvcc


class DcnFwdKernel:
    """Wrapper of the CUDA DCNv2 forward kernel (see module docstring)."""

    def __init__(self) -> None:
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self.library_path: Optional[Path] = None
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library; returns it."""
        if self._lib is not None:
            return self._lib
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"libdcn_fwd_{tag}.so"
        log_path = lib_path.with_suffix(".log")
        if not lib_path.exists():
            t0 = time.perf_counter()
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                    capture_output=True, text=True, timeout=600,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                    )
                log_path.write_text(proc.stdout + proc.stderr)
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            self.build_seconds = time.perf_counter() - t0
        self.build_log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(lib_path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dcn_fwd_f32.argtypes = [p] * 6 + [i] * 14 + [p]
        lib.dcn_fwd_f32.restype = i
        lib.dcn_fwd_threads.restype = i
        lib.dcn_fwd_acc_per_thread.restype = i
        self._max_outputs = lib.dcn_fwd_threads() * lib.dcn_fwd_acc_per_thread()
        self._threads = lib.dcn_fwd_threads()
        self.library_path = lib_path
        self._lib = lib
        return lib

    def _tile_pixels(self, cin: int, cout: int, dg: int, k: int) -> int:
        """Output pixels per block: enough to give every thread an output,
        within the register accumulator and shared memory."""
        self.load()
        tile_p = max(1, -(-self._threads // cout))
        tile_p = min(tile_p, self._max_outputs // cout)
        kc = k * (cin // dg)
        while tile_p > 1 and (tile_p * kc + kc * cout) * 4 > _SMEM_DEFAULT:
            tile_p //= 2
        if tile_p < 1 or (tile_p * kc + kc * cout) * 4 > _SMEM_MAX:
            raise ValueError(
                f"DCN shape (Cin {cin}, Cout {cout}, dg {dg}, K {k}) exceeds "
                "the kernel's register or shared-memory budget"
            )
        return tile_p

    def __call__(
        self,
        x: torch.Tensor,
        offsets: torch.Tensor,
        mask: torch.Tensor,
        weight: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        stride: int = 1,
        padding: int = 1,
        dilation: int = 1,
    ) -> torch.Tensor:
        tensors = [x, offsets, mask, weight] + ([bias] if bias is not None else [])
        devices = {t.device for t in tensors}
        if len(devices) != 1:
            raise ValueError(f"DCN inputs are on different devices: {devices}")
        if x.device.type == "cpu":
            return _plain.deform_conv2d(
                x, offsets, mask, weight, bias, stride, padding, dilation
            )
        if x.device.type != "cuda":
            raise ValueError(f"DCN kernel needs CUDA tensors, got {x.device}")
        for t in tensors:
            if t.dtype != torch.float32:
                raise TypeError(f"DCN kernel takes float32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError("DCN kernel takes contiguous tensors")
        if x.dim() != 4 or offsets.dim() != 6 or weight.dim() != 4:
            raise ValueError("DCN kernel takes x [B,H,W,C], offsets "
                             "[B,Ho,Wo,dg,K,2], weight [kh,kw,Cin,Cout]")
        b, h, w, cin = x.shape
        kh, kw, wcin, cout = weight.shape
        ob, ho, wo, dg, k, two = offsets.shape
        if (ob != b or two != 2 or wcin != cin or k != kh * kw or cin % dg
                or tuple(mask.shape) != (b, ho, wo, dg, k)
                or (bias is not None and tuple(bias.shape) != (cout,))):
            raise ValueError(
                f"DCN shapes disagree: x {tuple(x.shape)}, offsets "
                f"{tuple(offsets.shape)}, mask {tuple(mask.shape)}, weight "
                f"{tuple(weight.shape)}"
            )
        if max(t.numel() for t in tensors) >= 2**31 or b * ho * wo * cout >= 2**31:
            raise ValueError("DCN kernel indexes with 32-bit ints; input too large")
        lib = self.load()
        tile_p = self._tile_pixels(cin, cout, dg, k)
        out = torch.empty((b, ho, wo, cout), dtype=torch.float32, device=x.device)
        if out.numel() == 0:
            return out
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.dcn_fwd_f32(
                x.data_ptr(), offsets.data_ptr(), mask.data_ptr(),
                weight.data_ptr(), bias.data_ptr() if bias is not None else None,
                out.data_ptr(), b, h, w, cin, ho, wo, cout, dg, kh, kw,
                stride, padding, dilation, tile_p, stream,
            )
        if rc != 0:
            raise RuntimeError(f"dcn_fwd kernel launch failed: cudaError {rc}")
        self.launches += 1
        return out


dcn_fwd = DcnFwdKernel()
