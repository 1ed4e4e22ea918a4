"""The hand-written CUDA DCNv2 kernels, their wrappers, and the direction
dispatch of the model's DCN.

Two sources under ``esr_tpu_torch/csrc``, each compiled on first use with
``nvcc`` into a shared library with a plain C interface under
``esr_tpu_torch/_build/`` (named by a hash of the source, the shared
headers and the flags, so a changed source never meets a stale build) and
bound with ``ctypes``:

- ``dcn_fwd.cu``: :data:`dcn_fwd`, the forward kernel, which replaces the
  TPU kernel ``esr_tpu/ops/dcn_pallas.py:_dcn_fwd_kernel``, and
  :data:`dcn_fwd_masked`, its activity-predicated twin
  (``_dcn_fwd_kernel_masked``);
- ``dcn_train.cu``: :data:`dcn_train_fwd` (replaces ``_dcn_kernel``),
  :data:`dcn_train_fwd_masked` (``_dcn_kernel_masked``) and the two
  backward kernels :data:`dcn_bwd` (``gx``, ``goffsets``, ``gmask``) and
  :data:`dcn_wgrad` (``gW``), which together replace ``_dcn_bwd_kernel``.

The four forward wrappers compute the same output and run the same device
code (``dcn_common.cuh``, the masked ones with ``kMasked``), sized by the
same rule (:func:`fwd_config`); each has its own entry point
and launch count. The masked ones take the activity mask of
``esr_tpu_torch.ops.dcn`` (``[B]`` or ``[B, n_tiles]``, the tiles of
``fwd_tiling`` or ``train_tiling``) and pass it as an int32 bitmap.
:func:`bwd_config` picks the per-pixel backward's path: an image's x and
gx slices in shared memory when they fit (gx is then written once, so it
is allocated with ``torch.empty``), else a scatter into a zeroed gx in
global memory; above 32 channels per group its wide kernel, so it takes
any width. :func:`wgrad_config` tiles the weight gradient's output
over blocks, so it takes any width.

Nothing is imported or built when this module is imported; :func:`build`
starts every ``nvcc`` at once.

Every wrapper takes the plain PyTorch version (``esr_tpu_torch.ops.dcn``)
for CPU tensors; for CUDA tensors it launches its kernel on the current
stream, or raises (wrong device, type, layout or size, a failed build or
launch, or inputs that need a gradient the kernel's output cannot carry).
``launches`` counts kernel launches and nothing else.

:func:`dcn` is the model's DCN and the one place where the direction is
decided, as the reference's ``train`` flag does (``esr_tpu/models/
esr.py:267-277``): when grad mode is on and any input requires grad, the
train direction runs — on CUDA tensors the ``torch.autograd.Function``
:class:`DcnTrain`, whose forward launches ``dcn_train_fwd`` and whose
backward launches ``dcn_bwd`` and ``dcn_wgrad`` (``gbias`` is a sum of the
cotangent, outside the kernels as in the reference); on CPU tensors the
plain version under autograd. Otherwise the forward direction runs:
``dcn_fwd``. With a ``tile_mask`` the masked forwards run in their place
(``dcn_fwd_masked``; ``dcn_train_fwd_masked`` in ``DcnTrain.forward``,
whose backward stays the dense pair, as in the reference).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from esr_tpu_torch.ops import dcn as _plain

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the most dynamic shared memory a Hopper block can opt into
_SMEM_MAX = 232448
# the most threads a block of the DCN kernels has (kThreads in dcn_common.cuh)
_THREADS = 256
# about one block per SM of the H100 (132): the least grid the forward
# chooser wants
_TARGET_BLOCKS = 120
_SMS = 132


# -- launch configurations -------------------------------------------------
#
# Pure Python, so the CPU tests check them; the kernels validate what they
# are given and return cudaErrorInvalidValue on anything else.


@dataclass(frozen=True)
class FwdConfig:
    """The forward body's launch configuration (``FwdTile`` in
    ``csrc/dcn_common.cuh``): ``tm`` rows x ``tn`` out-channels per block,
    ``rm`` rows x 4 out-channels per thread. ``tn / 4`` is a multiple of
    ``rm``, so each row gets whole gather slots (``tn / (4 rm)`` threads)."""

    tm: int
    tn: int
    rm: int

    @property
    def threads(self) -> int:
        return (self.tm // self.rm) * (self.tn // 4)

    @property
    def stage_columns(self) -> int:
        """Columns of the column matrix per pipeline stage (4-channel items:
        4 per thread when ``rm`` is 1, else 2)."""
        return (4 if self.rm == 1 else 2) * 4 * (self.tn // (4 * self.rm))

    def blocks(self, rows: int, cout: int) -> int:
        return -(-rows // self.tm) * -(-cout // self.tn)


# (tm, tn, rm) from the most rows per block to the fewest; tn is cut to
# Cout rounded up to 4 (and rm to what divides tn / 4). Training's batch 32
# takes the first, validation's 8 the second, the engine's 4 lanes and
# evaluation's 1 image the last (a sweep over 45 configurations on an H100:
# splitting Cout across blocks lost at every batch, as each block then
# restages W for fewer outputs).
_FWD_TILES = ((32, 64, 2), (16, 64, 1), (16, 64, 2), (8, 64, 1))


def fwd_smem_bytes(cfg: FwdConfig) -> int:
    """Dynamic shared memory of the forward body (``fwd_smem_bytes`` in
    ``dcn_common.cuh``): two stages of columns and W."""
    return 4 * 2 * cfg.stage_columns * (cfg.tm + cfg.tn)


def fwd_config_ok(cfg: FwdConfig) -> bool:
    """What the kernel takes (``fwd_tile_ok`` in ``dcn_common.cuh``)."""
    return (cfg.rm in (1, 2, 4) and cfg.tm >= 4 and cfg.tm % 4 == 0
            and cfg.tn >= 4 and cfg.tn % 4 == 0 and (cfg.tn // 4) % cfg.rm == 0
            and cfg.threads <= _THREADS and fwd_smem_bytes(cfg) <= _SMEM_MAX)


def fwd_candidates(cout: int) -> Tuple[FwdConfig, ...]:
    """The chooser's candidates for ``cout`` out-channels, in its order of
    preference."""
    tn_cap = -(-cout // 4) * 4
    out = []
    for tm, tn, rm in _FWD_TILES:
        tn = min(tn, tn_cap)
        while (tn // 4) % rm:
            rm //= 2
        cfg = FwdConfig(tm, tn, rm)
        if fwd_config_ok(cfg) and cfg not in out:
            out.append(cfg)
    return tuple(out)


@functools.lru_cache(maxsize=256)
def fwd_config(rows: int, cout: int) -> FwdConfig:
    """The forward's launch configuration, the one rule that all four
    forward entry points size by (so the dense and masked launches of one
    shape get the same configuration): the first candidate whose grid
    covers about every SM (``_TARGET_BLOCKS``), else the one with the most
    blocks. Any two configurations give the same bits (each output is one
    FMA chain over the columns in a fixed order), so this rule decides
    speed only."""
    cands = fwd_candidates(cout)
    for cfg in cands:
        if cfg.blocks(rows, cout) >= _TARGET_BLOCKS:
            return cfg
    return max(cands, key=lambda c: c.blocks(rows, cout))


@dataclass(frozen=True)
class BwdConfig:
    """The per-pixel backward's launch configuration (``BwdTile`` in
    ``csrc/dcn_train.cu``): ``chunk_rows`` rows per block (one image when
    ``own``), ``tp`` cotangent rows per shared tile, ``kt`` taps per pass;
    ``own``: the image's x and gx slices live in shared memory and gx is
    written once (else scattered to global memory, which must be zeroed)."""

    chunk_rows: int
    tp: int
    kt: int
    own: bool
    # > 0: the wide kernel (``dcn_bwd_pixel_wide_kernel``), for more than
    # 32 channels per group or a tap of W^T too wide for the narrow one:
    # one (row, tap) item per thread (``chunk_rows == tp``, ``tp * kt <=
    # 256``), channel chunks of 32, W^T and the cotangent staged ``to``
    # out-channels at a time, gx scattered to global memory
    to: int = 0


# channels per chunk of the wide kernel (kWideCC in dcn_train.cu), and the
# most per group the narrow kernel takes (its MAXCG)
_BWD_WIDE_CC = 32


def bwd_smem_bytes(h: int, w: int, cg: int, cout: int, cfg: BwdConfig) -> int:
    """Dynamic shared memory of the per-pixel backward (``bwd_smem_bytes``
    and ``bwd_wide_smem_bytes`` in ``dcn_train.cu``)."""
    if cfg.to:
        return 4 * (cfg.kt * cfg.to * (_BWD_WIDE_CC + 4) + cfg.tp * (cfg.to + 4))
    cgp = -(-cg // 4) * 4
    coutp = -(-cout // 4) * 4
    nbuf = 2 if -(-cfg.chunk_rows // cfg.tp) > 1 else 1
    floats = cfg.kt * coutp * cgp + nbuf * cfg.tp * (coutp + 4)
    if cfg.own:
        floats += 2 * h * w * (cg + 1)
    return 4 * floats


def bwd_slices_fit(h: int, w: int, cg: int, cout: int, npix: int) -> bool:
    """Whether an image's x and gx slices fit shared memory beside the
    least staging (one tap of W^T, one tile of two cotangent rows)."""
    return bwd_smem_bytes(h, w, cg, cout, BwdConfig(npix, 2, 1, True)) <= _SMEM_MAX


# cotangent rows per shared tile: the most on the ownership path (the
# flagship's 240-row image in one tile: 0.126 ms against 0.141 in two on an
# H100), and the block of rows of the global path
_BWD_TILE_ROWS = 256
_BWD_GLOBAL_ROWS = 64


@functools.lru_cache(maxsize=256)
def bwd_config(h: int, w: int, ho: int, wo: int, cin: int, cout: int, dg: int,
               k: int) -> BwdConfig:
    """The per-pixel backward's configuration, for any width. Up to 32
    channels per group the narrow kernel: the ownership path exactly when
    an image's slices fit (:func:`bwd_slices_fit`), the cotangent in tiles
    of at most 256 rows split evenly over the image; else blocks of 64 rows
    scattering to global memory; taps per pass and rows per tile shrink
    until the staging fits. Wider groups, and a tap of W^T that does not
    fit beside two cotangent rows, take the wide kernel (:func:`_bwd_wide`)."""
    cg = cin // dg
    if cg > _BWD_WIDE_CC:
        return _bwd_wide(cout, k)
    npix = ho * wo
    own = bwd_slices_fit(h, w, cg, cout, npix)
    if own:
        n_tiles = -(-npix // _BWD_TILE_ROWS)
        tp = -(-npix // n_tiles)
    else:
        tp = _BWD_GLOBAL_ROWS
    tp += tp % 2
    while True:
        for kt in range(k, 0, -1):
            cfg = BwdConfig(npix if own else tp, tp, kt, own)
            if bwd_smem_bytes(h, w, cg, cout, cfg) <= _SMEM_MAX:
                return cfg
        if tp == 2:
            return _bwd_wide(cout, k)
        tp = max(2, tp // 2 + (tp // 2) % 2)


def _bwd_wide(cout: int, k: int) -> BwdConfig:
    """The wide kernel's configuration: blocks of 64 rows, the taps in the
    fewest passes of at most 256 / 64 = 4 (split evenly: 3 + 3 + 3 for
    K = 9), the out-channels in the fewest even pieces whose W^T and
    cotangent fit shared memory (always: a piece of 4 takes ~3 KB)."""
    tp = _BWD_GLOBAL_ROWS
    kt = _cdiv(k, _cdiv(k, _THREADS // tp))
    pieces = 1
    while True:
        cfg = BwdConfig(tp, tp, kt, False, _round_up(_cdiv(cout, pieces), 4))
        if cfg.to == 4 or bwd_smem_bytes(0, 0, 0, cout, cfg) <= _SMEM_MAX:
            return cfg
        pieces += 1


@dataclass(frozen=True)
class WgradConfig:
    """The weight gradient's launch configuration (``WgradTile`` in
    ``csrc/dcn_train.cu``): ``tj`` of a group's ``K * Cg`` columns x ``to``
    out-channels per block, each thread a micro-tile of 4 columns x ``mo``
    out-channels; ``chunk_rows`` rows per block, one partial of gW per
    chunk. A stage holds ``2 * to / mo`` rows (two 4-column gather items a
    thread)."""

    tj: int
    to: int
    mo: int
    chunk_rows: int

    @property
    def threads(self) -> int:
        return (self.tj // 4) * (self.to // self.mo)

    @property
    def stage_rows(self) -> int:
        return 2 * (self.to // self.mo)

    def chunks(self, rows: int) -> int:
        return _cdiv(rows, self.chunk_rows)

    def tiles(self, kc: int, cout: int) -> int:
        """Column tiles x out-channel tiles of one group (the grid's y)."""
        return _cdiv(kc, self.tj) * _cdiv(cout, self.to)


def wgrad_smem_bytes(cfg: WgradConfig) -> int:
    """Dynamic shared memory of the weight gradient (``wgrad_smem_bytes``
    in ``dcn_train.cu``): two stages of columns and cotangent rows."""
    return 4 * 2 * cfg.stage_rows * (cfg.tj + cfg.to)


def wgrad_config_ok(cfg: WgradConfig) -> bool:
    """What the kernel takes (``wgrad_tile_ok`` in ``dcn_train.cu``)."""
    return (cfg.mo in (4, 8) and cfg.tj >= 4 and cfg.tj % 4 == 0
            and cfg.to >= cfg.mo and cfg.to % cfg.mo == 0 and cfg.chunk_rows >= 1
            and cfg.threads <= _THREADS and wgrad_smem_bytes(cfg) <= _SMEM_MAX)


# the most blocks a grid's y (column x out-channel tiles) and z (groups) take
_GRID_YZ_MAX = 65535
# the weight gradient's grid aims at about two blocks per SM
_WGRAD_TARGET_BLOCKS = 2 * _SMS
# at most 16 threads along a block's out-channels, each with 2 quads of
# them above 32 out-channels (a 4 x 8 micro-tile), else 1
_WGRAD_MAX_NV = 16


@functools.lru_cache(maxsize=256)
def wgrad_config(rows: int, kc: int, cout: int, dg: int) -> WgradConfig:
    """The weight gradient's configuration for ``rows`` output pixels,
    ``kc = K * Cg`` columns and ``cout`` out-channels per group, any width:
    micro-tiles of 4 columns x 8 out-channels above 32 out-channels (else
    x 4), up to 128 out-channels per tile (16 threads); a group's columns
    split evenly into the fewest tiles that keep a block at 256 threads;
    the rows split into chunks of whole stages until the grid covers about
    two blocks per SM, or four times that when one chunk's blocks are more
    than a quarter of it (the last wave would be coarse). Each chunk's
    partial is an FMA chain over its rows in order; the chunks only change
    where the sums split. (A sweep on an H100: 4 x 16 micro-tiles with 256
    out-channels per tile, which gather once at 256 out-channels, lost to
    4 x 8 at 128 and 256 out-channels and tied at 64; 4 x 4 tied at 64 and
    lost above; at 256 out-channels 1120 blocks took 0.446 ms, 320 blocks
    0.542.)"""
    quads = _cdiv(cout, 4)
    n_o = 1 if quads <= 8 else 2
    nv = min(_WGRAD_MAX_NV, _cdiv(quads, n_o))
    to, mo = 4 * nv * n_o, 4 * n_o
    n_jt = _cdiv(kc, 4 * (_THREADS // nv))
    tj = _round_up(_cdiv(kc, n_jt), 4)
    tr = 2 * nv
    per_chunk = n_jt * _cdiv(cout, to) * dg
    target = _WGRAD_TARGET_BLOCKS * (4 if 4 * per_chunk > _WGRAD_TARGET_BLOCKS else 1)
    n_chunks = max(1, min(_cdiv(rows, tr), _cdiv(target, per_chunk)))
    return WgradConfig(tj, to, mo, _round_up(_cdiv(rows, n_chunks), tr))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, m: int) -> int:
    return _cdiv(a, m) * m


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the DCN kernels cannot be built")
    return nvcc


class CudaLibrary:
    """One ``csrc`` source built into a plain-C shared library and loaded
    with ``ctypes``. ``declare`` sets the argument and return types."""

    def __init__(self, source: Path, declare: Callable[[ctypes.CDLL], None]):
        self.source = source
        self.declare = declare
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self.library_path: Optional[Path] = None
        self._lib: Optional[ctypes.CDLL] = None
        self._pending: Optional[Tuple[subprocess.Popen, str, float]] = None

    def _path(self) -> Path:
        # the shared headers are part of every source
        headers = b"".join(p.read_bytes() for p in sorted(self.source.parent.glob("*.cuh")))
        tag = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{tag}.so"

    def start_build(self) -> None:
        """Start ``nvcc`` in the background unless the library is built."""
        if self._lib is not None or self._pending is not None or self._path().exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        self._pending = (proc, tmp, time.perf_counter())

    def _finish_build(self, lib_path: Path) -> None:
        proc, tmp, t0 = self._pending
        self._pending = None
        try:
            try:
                out, _ = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise RuntimeError(f"nvcc of {self.source.name} timed out")
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc of {self.source.name} failed ({proc.returncode}):\n{out}"
                )
            lib_path.with_suffix(".log").write_text(out)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.build_seconds = time.perf_counter() - t0

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library; returns it."""
        if self._lib is not None:
            return self._lib
        lib_path = self._path()
        if not lib_path.exists():
            self.start_build()
        if self._pending is not None:
            self._finish_build(lib_path)
        log_path = lib_path.with_suffix(".log")
        self.build_log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(lib_path))
        self.declare(lib)
        self.library_path = lib_path
        self._lib = lib
        return lib


_P, _I = ctypes.c_void_p, ctypes.c_int


def _declare_fwd(lib: ctypes.CDLL) -> None:
    lib.dcn_fwd_f32.argtypes = [_P] * 6 + [_I] * 16 + [_P]
    lib.dcn_fwd_f32.restype = _I
    lib.dcn_fwd_masked_f32.argtypes = [_P] * 7 + [_I] * 18 + [_P]
    lib.dcn_fwd_masked_f32.restype = _I


def _declare_train(lib: ctypes.CDLL) -> None:
    lib.dcn_train_fwd_f32.argtypes = [_P] * 6 + [_I] * 16 + [_P]
    lib.dcn_train_fwd_masked_f32.argtypes = [_P] * 7 + [_I] * 18 + [_P]
    lib.dcn_bwd_pixel_f32.argtypes = [_P] * 8 + [_I] * 18 + [_P]
    lib.dcn_wgrad_f32.argtypes = [_P] * 5 + [_I] * 17 + [_P]
    for fn in (lib.dcn_train_fwd_f32, lib.dcn_train_fwd_masked_f32,
               lib.dcn_bwd_pixel_f32, lib.dcn_wgrad_f32):
        fn.restype = _I


FWD_LIBRARY = CudaLibrary(_PKG / "csrc" / "dcn_fwd.cu", _declare_fwd)
TRAIN_LIBRARY = CudaLibrary(_PKG / "csrc" / "dcn_train.cu", _declare_train)
LIBRARIES = (FWD_LIBRARY, TRAIN_LIBRARY)


def build() -> None:
    """Build every DCN library, all ``nvcc`` runs started together."""
    for lib in LIBRARIES:
        lib.start_build()
    for lib in LIBRARIES:
        lib.load()


def _check_cuda(name: str, tensors: Sequence[torch.Tensor]) -> None:
    """Device, type, layout, size and autograd checks of a CUDA launch."""
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name} kernel needs CUDA tensors, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors")
    if max(t.numel() for t in tensors) >= 2**31:
        raise ValueError(f"{name} kernel indexes with 32-bit ints; input too large")
    if _plain.wants_grad(tensors):
        raise RuntimeError(
            f"{name}: inputs require grad, but the kernel's output would have "
            "no grad_fn; call esr_tpu_torch.ops.dcn_cuda.dcn, which routes "
            "grad-requiring calls to the train direction"
        )


def _shapes(x, offsets, mask, weight_shape, bias=None):
    """``(b, h, w, cin, ho, wo, cout, dg, kh, kw)``; raises on a mismatch."""
    if x.dim() != 4 or offsets.dim() != 6 or len(weight_shape) != 4:
        raise ValueError("DCN kernels take x [B,H,W,C], offsets "
                         "[B,Ho,Wo,dg,K,2], weight [kh,kw,Cin,Cout]")
    b, h, w, cin = x.shape
    kh, kw, wcin, cout = weight_shape
    ob, ho, wo, dg, k, two = offsets.shape
    if (ob != b or two != 2 or wcin != cin or k != kh * kw or cin % dg
            or tuple(mask.shape) != (b, ho, wo, dg, k)
            or (bias is not None and tuple(bias.shape) != (cout,))):
        raise ValueError(
            f"DCN shapes disagree: x {tuple(x.shape)}, offsets "
            f"{tuple(offsets.shape)}, mask {tuple(mask.shape)}, weight "
            f"{tuple(weight_shape)}"
        )
    return b, h, w, cin, ho, wo, cout, dg, kh, kw


def _same_device(tensors: Sequence[torch.Tensor]) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"DCN inputs are on different devices: {devices}")
    return tensors[0].device


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


class DcnFwdKernel:
    """Wrapper of the forward body (``csrc/dcn_common.cuh``) through the
    forward direction's entry point (``csrc/dcn_fwd.cu``)."""

    library = FWD_LIBRARY
    name = "dcn_fwd"
    entry = "dcn_fwd_f32"
    # None: dense; else the direction whose tiles the activity mask marks
    masked_direction: Optional[str] = None

    def __init__(self) -> None:
        self.launches = 0

    @staticmethod
    def launch_config(offsets: torch.Tensor, weight: torch.Tensor) -> FwdConfig:
        """The configuration a launch at these shapes gets: the same for all
        four forward wrappers, dense and masked."""
        b, ho, wo = offsets.shape[:3]
        return fwd_config(b * ho * wo, weight.shape[-1])

    def __call__(self, x, offsets, mask, weight, bias=None, stride=1, padding=1,
                 dilation=1, tile_mask=None) -> torch.Tensor:
        masked = self.masked_direction is not None
        if masked != (tile_mask is not None):
            raise ValueError(f"{self.name} {'needs' if masked else 'takes no'} tile_mask")
        tensors = [x, offsets, mask, weight] + ([bias] if bias is not None else [])
        if _same_device(tensors + ([tile_mask] if masked else [])).type == "cpu":
            if masked:
                return _plain.deform_conv2d_masked(
                    x, offsets, mask, weight, bias, tile_mask, stride, padding,
                    dilation, self.masked_direction)
            return _plain.deform_conv2d(
                x, offsets, mask, weight, bias, stride, padding, dilation
            )
        _check_cuda(self.name, tensors)
        b, h, w, cin, ho, wo, cout, dg, kh, kw = _shapes(
            x, offsets, mask, tuple(weight.shape), bias)
        if b * ho * wo * cout >= 2**31:
            raise ValueError(f"{self.name} kernel indexes with 32-bit ints; input too large")
        activity = []
        if masked:
            no_tile, n_tiles = _plain.output_tiling(x, offsets, self.masked_direction)
            am = _plain.tile_mask_grid(tile_mask, b, n_tiles)
            activity = [am.data_ptr()]
        lib = self.library.load()
        cfg = self.launch_config(offsets, weight)
        out = torch.empty((b, ho, wo, cout), dtype=torch.float32, device=x.device)
        if out.numel() == 0:
            return out
        _launch(self.name, getattr(lib, self.entry), x.device,
                x.data_ptr(), offsets.data_ptr(), mask.data_ptr(), weight.data_ptr(),
                bias.data_ptr() if bias is not None else None, out.data_ptr(),
                *activity, b, h, w, cin, ho, wo, cout, dg, kh, kw, stride, padding,
                dilation, cfg.tm, cfg.tn, cfg.rm,
                *([n_tiles, no_tile] if masked else []))
        self.launches += 1
        return out


class DcnFwdMaskedKernel(DcnFwdKernel):
    """The forward body predicated on activity (``kMasked``) through
    ``dcn_fwd_masked_f32``; its plain version is
    :func:`esr_tpu_torch.ops.dcn.deform_conv2d_masked` ('fwd' tiles)."""

    name = "dcn_fwd_masked"
    entry = "dcn_fwd_masked_f32"
    masked_direction = "fwd"


class DcnTrainFwdKernel(DcnFwdKernel):
    """The same forward body through the train direction's entry point
    (``csrc/dcn_train.cu``), launched and counted on its own from
    :class:`DcnTrain`. Its plain version is
    :func:`esr_tpu_torch.ops.dcn.deform_conv2d`."""

    library = TRAIN_LIBRARY
    name = "dcn_train_fwd"
    entry = "dcn_train_fwd_f32"


class DcnTrainFwdMaskedKernel(DcnTrainFwdKernel):
    """The train direction's forward predicated on activity, through
    ``dcn_train_fwd_masked_f32``, launched only from :class:`DcnTrain`; its
    plain version is ``deform_conv2d_masked`` ('train' tiles)."""

    name = "dcn_train_fwd_masked"
    entry = "dcn_train_fwd_masked_f32"
    masked_direction = "train"


class _TrainKernel:
    """Common checks and sizing of the ``csrc/dcn_train.cu`` kernels."""

    library = TRAIN_LIBRARY
    name = ""

    def __init__(self) -> None:
        self.launches = 0

    def _prepare(self, tensors, x, offsets, mask, weight_shape, bias=None):
        """CUDA checks; returns the loaded library and the shape tuple."""
        _check_cuda(self.name, tensors)
        dims = _shapes(x, offsets, mask, tuple(weight_shape), bias)
        b, _, _, _, ho, wo, cout, _, _, _ = dims
        if b * ho * wo * cout >= 2**31:
            raise ValueError(f"{self.name} kernel indexes with 32-bit ints; "
                             "input too large")
        return self.library.load(), dims


class DcnBwdKernel(_TrainKernel):
    """Wrapper of the per-pixel backward (``dcn_bwd_pixel_kernel``):
    ``(gx, goffsets, gmask)`` for the output cotangent ``g``. Its plain
    version is the first three of
    :func:`esr_tpu_torch.ops.dcn.deform_conv2d_backward`."""

    name = "dcn_bwd"

    def __call__(self, x, offsets, mask, weight, g, stride=1, padding=1,
                 dilation=1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        tensors = [x, offsets, mask, weight, g]
        if _same_device(tensors).type == "cpu":
            return _plain.deform_conv2d_backward(
                x, offsets, mask, weight, g, stride, padding, dilation)[:3]
        lib, (b, h, w, cin, ho, wo, cout, dg, kh, kw) = self._prepare(
            tensors, x, offsets, mask, weight.shape)
        if tuple(g.shape) != (b, ho, wo, cout):
            raise ValueError(f"{self.name}: cotangent {tuple(g.shape)} does not "
                             f"match the output {(b, ho, wo, cout)}")
        cfg = bwd_config(h, w, ho, wo, cin, cout, dg, kh * kw)
        goff = torch.empty_like(offsets)
        gmask = torch.empty_like(mask)
        if goff.numel() == 0:
            return torch.zeros_like(x), goff, gmask
        # the ownership path writes every element of gx once; the global
        # path scatters into it
        gx = torch.empty_like(x) if cfg.own else torch.zeros_like(x)
        _launch(self.name, lib.dcn_bwd_pixel_f32, x.device,
                x.data_ptr(), offsets.data_ptr(), mask.data_ptr(), weight.data_ptr(),
                g.data_ptr(), gx.data_ptr(), goff.data_ptr(), gmask.data_ptr(),
                b, h, w, cin, ho, wo, cout, dg, kh, kw, stride, padding,
                dilation, cfg.chunk_rows, cfg.tp, cfg.kt, int(cfg.own), cfg.to)
        self.launches += 1
        return gx, goff, gmask


class DcnWgradKernel(_TrainKernel):
    """Wrapper of the weight gradient (``dcn_wgrad_kernel``): ``gW``
    ``[kh, kw, Cin, Cout]`` at any width. The kernel writes one partial per
    chunk of rows (:func:`wgrad_config`); the partials are summed here in a
    fixed order, so gW is the same bits from run to run. Its plain version
    is the fourth of :func:`esr_tpu_torch.ops.dcn.deform_conv2d_backward`."""

    name = "dcn_wgrad"

    @staticmethod
    def launch_config(x: torch.Tensor, offsets: torch.Tensor,
                      weight_shape: Sequence[int]) -> WgradConfig:
        b, ho, wo, dg, k, _ = offsets.shape
        return wgrad_config(b * ho * wo, k * (x.shape[-1] // dg), weight_shape[-1], dg)

    def __call__(self, x, offsets, mask, weight_shape: Sequence[int], g, stride=1,
                 padding=1, dilation=1) -> torch.Tensor:
        weight_shape = tuple(weight_shape)
        tensors = [x, offsets, mask, g]
        if _same_device(tensors).type == "cpu":
            weight = torch.zeros(weight_shape, dtype=x.dtype)
            return _plain.deform_conv2d_backward(
                x, offsets, mask, weight, g, stride, padding, dilation)[3]
        lib, (b, h, w, cin, ho, wo, cout, dg, kh, kw) = self._prepare(
            tensors, x, offsets, mask, weight_shape)
        if tuple(g.shape) != (b, ho, wo, cout):
            raise ValueError(f"{self.name}: cotangent {tuple(g.shape)} does not "
                             f"match the output {(b, ho, wo, cout)}")
        rows = b * ho * wo
        if rows == 0:
            return torch.zeros(weight_shape, dtype=torch.float32, device=x.device)
        cfg = self.launch_config(x, offsets, weight_shape)
        kc = kh * kw * (cin // dg)
        if cfg.tiles(kc, cout) > _GRID_YZ_MAX or dg > _GRID_YZ_MAX:
            raise ValueError(f"{self.name}: {cfg.tiles(kc, cout)} column x out-channel "
                             f"tiles or {dg} groups exceed the grid's limit of "
                             f"{_GRID_YZ_MAX}")
        partial = torch.empty((cfg.chunks(rows), *weight_shape), dtype=torch.float32,
                              device=x.device)
        _launch(self.name, lib.dcn_wgrad_f32, x.device,
                x.data_ptr(), offsets.data_ptr(), mask.data_ptr(), g.data_ptr(),
                partial.data_ptr(), b, h, w, cin, ho, wo, cout, dg, kh, kw,
                stride, padding, dilation, cfg.tj, cfg.to, cfg.mo, cfg.chunk_rows)
        self.launches += 1
        return partial.sum(dim=0)


dcn_fwd = DcnFwdKernel()
dcn_train_fwd = DcnTrainFwdKernel()
dcn_bwd = DcnBwdKernel()
dcn_wgrad = DcnWgradKernel()
dcn_fwd_masked = DcnFwdMaskedKernel()
dcn_train_fwd_masked = DcnTrainFwdMaskedKernel()
KERNELS = (dcn_fwd, dcn_train_fwd, dcn_bwd, dcn_wgrad, dcn_fwd_masked,
           dcn_train_fwd_masked)


class DcnTrain(torch.autograd.Function):
    """The train direction on CUDA tensors: ``dcn_train_fwd`` forward
    (``dcn_train_fwd_masked`` with a ``tile_mask``), ``dcn_bwd`` +
    ``dcn_wgrad`` backward, dense either way (the counterpart of the
    reference's ``jax.custom_vjp`` at ``dcn_pallas.py:1190-1191,1413-1418``)."""

    @staticmethod
    def forward(ctx, x, offsets, mask, weight, bias, stride, padding, dilation,
                tile_mask=None):
        ctx.save_for_backward(x, offsets, mask, weight)
        ctx.geom = (stride, padding, dilation)
        ctx.has_bias = bias is not None
        if tile_mask is None:
            return dcn_train_fwd(x, offsets, mask, weight, bias, stride, padding, dilation)
        return dcn_train_fwd_masked(x, offsets, mask, weight, bias, stride, padding,
                                    dilation, tile_mask=tile_mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, offsets, mask, weight = ctx.saved_tensors
        g = g.contiguous()
        need = ctx.needs_input_grad
        gx = goff = gmask = gw = gb = None
        if any(need[:3]):
            gx, goff, gmask = dcn_bwd(x, offsets, mask, weight, g, *ctx.geom)
        if need[3]:
            gw = dcn_wgrad(x, offsets, mask, weight.shape, g, *ctx.geom)
        if ctx.has_bias and need[4]:
            gb = g.sum(dim=(0, 1, 2))
        return gx, goff, gmask, gw, gb, None, None, None, None


def dcn(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
        weight: torch.Tensor, bias: Optional[torch.Tensor] = None, stride: int = 1,
        padding: int = 1, dilation: int = 1,
        tile_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The model's DCN; the direction is decided here (module docstring).
    ``tile_mask`` (``[B]`` or ``[B, n_tiles]``) selects the masked forwards;
    ``None`` keeps the dense launches."""
    if not _plain.wants_grad([x, offsets, mask, weight, bias]):
        if tile_mask is None:
            return dcn_fwd(x, offsets, mask, weight, bias, stride, padding, dilation)
        return dcn_fwd_masked(x, offsets, mask, weight, bias, stride, padding, dilation,
                              tile_mask=tile_mask)
    if _same_device([x, offsets, mask, weight]).type == "cpu":
        if tile_mask is None:
            return _plain.deform_conv2d(x, offsets, mask, weight, bias, stride,
                                        padding, dilation)
        return _plain.deform_conv2d_masked(x, offsets, mask, weight, bias, tile_mask,
                                           stride, padding, dilation, "train")
    return DcnTrain.apply(x, offsets, mask, weight, bias, stride, padding, dilation,
                          tile_mask)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0
