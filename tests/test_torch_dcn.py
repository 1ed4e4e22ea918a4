"""The port's DCNv2: the plain PyTorch version (forward and backward)
against the jnp reference and against the Pallas kernels run in interpret
mode; the direction dispatch and the CUDA kernels' wrappers on CPU
tensors; the kernels themselves, and gradients through them, on a card.
The activity-masked DCN (``dcn_sparse``) against the reference's masked
kernels, to 1e-5 of max |ref| and exactly on masked-off rows. Every
hand-written kernel (the six DCN kernels, K1 and K2) is a ``torch.library``
op with a plain CPU and a fake implementation.

Bound: the reference's scale-normalized criterion (``dcn_parity_ok``
off-TPU), max|a - b| <= 1e-3 * max(max|ref|, 1), per output and per
cotangent. Measured on the CPU: forward ~1e-7; backward cotangents at most
4.7e-7 (jnp autodiff) and 5.6e-7 (fused Pallas backward) of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.ops import dcn as JD
from esr_tpu.ops.dcn_pallas import _tile_mask_grid as JD_tile_mask_grid
from esr_tpu.ops.dcn_pallas import dcn_image_activity as JD_activity
from esr_tpu.ops.dcn_pallas import deform_conv2d_pallas, deform_conv2d_pallas_fwd
from esr_tpu_torch.ops import dcn as TD
from esr_tpu_torch.ops import dcn_cuda
from esr_tpu_torch.ops.dcn_cuda import dcn_bwd, dcn_fwd, dcn_train_fwd, dcn_wgrad

TOL = 1e-3


def _inputs(seed, b, h, w, cin, cout, dg, ho=None, wo=None, offset_scale=3.0,
            with_mask=True, with_bias=False):
    rng = np.random.default_rng(seed)
    ho = h if ho is None else ho
    wo = w if wo is None else wo
    f32 = np.float32
    mask = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, ho, wo, dg, 9))))
            if with_mask else np.ones((b, ho, wo, dg, 9)))
    return dict(
        x=rng.standard_normal((b, h, w, cin)).astype(f32),
        offsets=(rng.standard_normal((b, ho, wo, dg, 9, 2)) * offset_scale).astype(f32),
        mask=mask.astype(f32),
        weight=(rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(f32),
        bias=rng.standard_normal(cout).astype(f32) if with_bias else None,
    )


def _torch(inp, device="cpu"):
    return {k: (torch.from_numpy(v).to(device) if v is not None else None)
            for k, v in inp.items()}


def _check(got, ref):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= TOL * max(float(np.abs(ref).max()), 1.0), err


@pytest.mark.parametrize("dg", [1, 2, 4])
@pytest.mark.parametrize("h,w", [(7, 9), (13, 5), (4, 150)])
@pytest.mark.parametrize("with_mask", [True, False])
def test_plain_matches_jnp_and_pallas(dg, h, w, with_mask):
    inp = _inputs(dg * 100 + h * 10 + w + with_mask, 2, h, w, 4 * dg, 8, dg,
                  with_mask=with_mask)
    got = TD.deform_conv2d(**_torch(inp)).numpy()
    j = {k: jnp.asarray(v) for k, v in inp.items() if v is not None}
    _check(got, JD.deform_conv2d(**j))
    _check(got, deform_conv2d_pallas_fwd(j["x"], j["offsets"], j["mask"],
                                         j["weight"], interpret=True))


@pytest.mark.parametrize("case", ["strided_dilated_bias", "large_offsets_bias",
                                  "large_offsets_no_bias"])
def test_plain_geometry_and_boundary(case):
    if case == "strided_dilated_bias":
        geom = dict(stride=2, padding=2, dilation=2)
        inp = _inputs(11, 1, 9, 11, 8, 6, 2, ho=5, wo=6, offset_scale=2.0,
                      with_bias=True)
    else:
        geom = {}
        # offsets large enough to leave the image: boundary zeros must agree
        inp = _inputs(1, 1, 6, 7, 16, 8, 2, offset_scale=10.0,
                      with_bias=case == "large_offsets_bias")
    got = TD.deform_conv2d(**_torch(inp), **geom).numpy()
    j = {k: (jnp.asarray(v) if v is not None else None) for k, v in inp.items()}
    _check(got, JD.deform_conv2d(**j, **geom))
    _check(got, deform_conv2d_pallas_fwd(
        j["x"], j["offsets"], j["mask"], j["weight"], j["bias"],
        geom.get("stride", 1), geom.get("padding", 1), geom.get("dilation", 1),
        interpret=True))


def test_zero_offsets_unit_mask_is_a_regular_conv():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, 8, 8)) * 0.1).astype(np.float32)
    out = TD.deform_conv2d(
        torch.from_numpy(x), torch.zeros(1, 8, 8, 1, 9, 2), torch.ones(1, 8, 8, 1, 9),
        torch.from_numpy(wt),
    )
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(wt).permute(3, 2, 0, 1), padding=1,
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), conv.numpy(), atol=1e-5, rtol=1e-5)


def test_offsets_from_conv_layout_matches_reference():
    rng = np.random.default_rng(3)
    raw = rng.standard_normal((2, 3, 4, 4 * 3 * 9)).astype(np.float32)
    off, mask = TD.dcn_offsets_from_conv(torch.from_numpy(raw), 4, 9)
    joff, jmask = JD.dcn_offsets_from_conv(jnp.asarray(raw), 4, 9)
    assert off.shape == (2, 3, 4, 4, 9, 2) and mask.shape == (2, 3, 4, 4, 9)
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    np.testing.assert_allclose(mask.numpy(), np.asarray(jmask), atol=1e-7)
    assert mask.is_contiguous() and off.is_contiguous()
    with pytest.raises(ValueError):
        TD.dcn_offsets_from_conv(torch.from_numpy(raw), 3, 9)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    inp = _torch(_inputs(5, 2, 6, 7, 16, 8, 2, with_bias=True))
    dcn_fwd.launches = 0
    out = dcn_fwd(**inp)
    auto = TD.deform_conv2d_auto(**inp)
    ref = TD.deform_conv2d(**inp)
    assert dcn_fwd.launches == 0
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    np.testing.assert_array_equal(auto.numpy(), ref.numpy())
    np.testing.assert_array_equal(
        TD.deform_conv2d_auto(**inp, impl="plain").numpy(), ref.numpy())
    with pytest.raises(ValueError):
        TD.deform_conv2d_auto(**inp, impl="jnp")
    with pytest.raises(ValueError):
        TD.deform_conv2d(inp["x"], inp["offsets"], inp["mask"], inp["weight"][:, :, :8])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the DCN kernel has no CPU mode "
                    "(chip_smoke.py runs it on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dg,h,w", [(8, 12, 20), (1, 7, 9), (4, 4, 150)])
def test_kernel_matches_plain_on_card(cuda_device, dg, h, w):
    cin = 64 if dg == 8 else 4 * dg
    inp = _torch(_inputs(7, 2, h, w, cin, cin if dg == 8 else 8, dg,
                         with_bias=True), cuda_device)
    before = dcn_fwd.launches
    out = dcn_fwd(**inp)
    torch.cuda.synchronize()
    assert dcn_fwd.launches == before + 1
    _check(out.cpu().numpy(), TD.deform_conv2d(**inp).cpu().numpy())
    with pytest.raises(ValueError):
        dcn_fwd(inp["x"].permute(0, 2, 1, 3), inp["offsets"], inp["mask"],
                inp["weight"], inp["bias"])


# -- the launch configurations (pure Python) --------------------------------

# (b, h, w, cin, cout, dg): the flagship bottleneck at the evaluation,
# engine, validation and training batches; train_esr_4x's bottleneck (a
# 180x320 HR grid padded to 192x320, /8) at its batch 8; the shapes of
# chip_smoke.py's kernel matrix; a 64x64 image of 32 channels per group;
# the bottlenecks of basech 16 and 32 at the training batch
CONFIG_SHAPES = (
    [(b, 12, 20, 64, 64, 8) for b in (1, 4, 8, 32)]
    + [(8, 24, 40, 64, 64, 8)]
    + [(2, h, w, 4 * dg, 8, dg) for dg in (1, 2, 4) for h, w in ((7, 9), (13, 5), (4, 150))]
    + [(1, 6, 7, 16, 8, 2), (1, 9, 11, 8, 6, 2), (2, 9, 13, 32, 6, 2), (2, 7, 9, 6, 5, 2),
       (1, 64, 64, 64, 64, 2)]
    + [(32, 12, 20, 128, 128, 8), (32, 12, 20, 256, 256, 8)]
)


def _fwd_cover(rows, cout, cfg):
    """How many threads write each (row, out-channel): the kernel's grid,
    thread and micro-tile mapping written out."""
    count = np.zeros((rows, cout), np.int64)
    nv = cfg.tn // 4
    for bx in range(-(-rows // cfg.tm)):
        for by in range(-(-cout // cfg.tn)):
            for t in range(cfg.threads):
                r = bx * cfg.tm + (t // nv) * cfg.rm + np.arange(cfg.rm)
                o = by * cfg.tn + (t % nv) * 4 + np.arange(4)
                r, o = r[r < rows], o[o < cout]
                count[np.ix_(r, o)] += 1
    return count


@pytest.mark.parametrize("b,h,w,cin,cout,dg", CONFIG_SHAPES)
def test_forward_config_fits_and_covers_every_output_once(b, h, w, cin, cout, dg):
    rows = b * h * w
    cfg = dcn_cuda.fwd_config(rows, cout)
    cands = dcn_cuda.fwd_candidates(cout)
    assert cfg in cands
    for c in cands:
        assert dcn_cuda.fwd_config_ok(c)
        assert dcn_cuda.fwd_smem_bytes(c) <= 232448 and 1 <= c.threads <= 256
        # each row gets whole gather slots: the block's threads are a
        # multiple of its rows
        assert c.threads % c.tm == 0 and c.tn % 4 == 0
    # the chooser's rule: the first candidate that covers about every SM,
    # else the most blocks
    full = [c for c in cands if c.blocks(rows, cout) >= 120]
    assert cfg == (full[0] if full else max(cands, key=lambda c: c.blocks(rows, cout)))
    if rows * cout <= 600_000:
        assert (_fwd_cover(rows, cout, cfg) == 1).all()


@pytest.mark.parametrize("b,h,w,cin,cout,dg", CONFIG_SHAPES[:5])
def test_dense_and_masked_forwards_get_one_configuration(b, h, w, cin, cout, dg):
    offsets = torch.zeros(b, h, w, dg, 9, 2)
    weight = torch.zeros(3, 3, cin, cout)
    wrappers = (dcn_fwd, dcn_train_fwd, dcn_cuda.dcn_fwd_masked, dcn_cuda.dcn_train_fwd_masked)
    cfgs = {wr.launch_config(offsets, weight) for wr in wrappers}
    assert cfgs == {dcn_cuda.fwd_config(b * h * w, cout)}


@pytest.mark.parametrize("b,h,w,cin,cout,dg", CONFIG_SHAPES)
def test_backward_config_owns_exactly_when_the_slices_fit(b, h, w, cin, cout, dg):
    cg = cin // dg
    cfg = dcn_cuda.bwd_config(h, w, h, w, cin, cout, dg, 9)
    smem = dcn_cuda.bwd_smem_bytes(h, w, cg, cout, cfg)
    assert smem <= 232448
    assert cfg.tp % 2 == 0 and 1 <= cfg.kt <= 9
    # the x slice (f32) and the gx slice (fixed-point accumulators of three
    # 32-bit words, a multiple of 4 words), rows padded to Cg + 1, beside one
    # tap of W^T and two cotangent rows, counted independently of the
    # chooser; and at most 65535 (row, tap) terms a pixel
    cgp, coutp = -(-cg // 4) * 4, -(-cout // 4) * 4
    n = h * w * (cg + 1)
    slices = 4 * n + 4 * (-(-3 * n // 4) * 4) + 4 * (coutp * cgp + 2 * 2 * (coutp + 4))
    assert cfg.own == (slices <= 232448 and h * w * 9 < 65536)
    if cfg.own:
        assert cfg.chunk_rows == h * w  # one image per block: gx has one writer
    else:
        assert cfg.chunk_rows == cfg.tp
    flagship = (h, w, cin, cout, dg) == (12, 20, 64, 64, 8)
    if flagship or (h, w) == (64, 64):
        assert cfg.own == flagship and cfg.kt == 9


@pytest.mark.parametrize("cout", [8, 64, 512, 1024, 2048])
@pytest.mark.parametrize("cg", [8, 16, 32, 48, 64, 128])
def test_backward_config_takes_every_width(cg, cout):
    """Any width gets a configuration within the shared-memory budget:
    the narrow kernel up to 32 channels per group while a tap of W^T fits,
    else the wide one, whose passes give every (row, tap) one thread."""
    for h, w in ((12, 20), (64, 64)):
        cfg = dcn_cuda.bwd_config(h, w, h, w, 8 * cg, cout, 8, 9)
        assert dcn_cuda.bwd_smem_bytes(h, w, cg, cout, cfg) <= 232448
        assert (cfg.to > 0) == (cg > 32 or (cg, cout) == (32, 2048))
        if cfg.to:
            assert not cfg.own and cfg.chunk_rows == cfg.tp
            assert cfg.tp * cfg.kt <= 256 and cfg.to % 4 == 0
            passes = [list(range(k0, min(9, k0 + cfg.kt))) for k0 in range(0, 9, cfg.kt)]
            assert sum(passes, []) == list(range(9))
            # W^T and the cotangent, counted independently of the chooser
            assert 4 * (cfg.kt * cfg.to * 36 + cfg.tp * (cfg.to + 4)) <= 232448
            # the fewest pieces of out-channels that fit
            pieces = -(-cout // cfg.to)
            if pieces > 1:
                per_piece = -(-cout // (pieces - 1))
                to = -(-per_piece // 4) * 4
                assert 4 * (cfg.kt * to * 36 + cfg.tp * (to + 4)) > 232448


def _wgrad_cover(kc, cin, cout, dg, cfg):
    """How many threads write each (tap, in-channel, out-channel) of one
    chunk's partial of gW: the kernel's grid (column x out-channel tiles,
    groups), thread and 4 x mo micro-tile mapping written out."""
    cg = cin // dg
    count = np.zeros((kc // cg, cin, cout), np.int64)
    nv = cfg.to // cfg.mo
    n_jt = -(-kc // cfg.tj)
    t = np.arange(cfg.threads)
    jj = ((t // nv)[:, None] * 4 + np.arange(4))[:, :, None]  # [thread, i, 1]
    # out-channel quad m of thread t: 4 (t % nv) + 4 nv m + l
    oo = (4 * (t % nv)[:, None, None] + 4 * nv * np.arange(cfg.mo // 4)[:, None]
          + np.arange(4)).reshape(cfg.threads, 1, cfg.mo)
    for y in range(cfg.tiles(kc, cout)):
        j, o = np.broadcast_arrays((y % n_jt) * cfg.tj + jj, (y // n_jt) * cfg.to + oo)
        keep = (j < kc) & (o < cout)
        j, o = j[keep], o[keep]
        for g in range(dg):
            np.add.at(count, (j // cg, g * cg + j % cg, o), 1)
    return count


@pytest.mark.parametrize("b,h,w,cin,cout,dg", CONFIG_SHAPES)
def test_wgrad_config_fits_and_covers_every_weight_once(b, h, w, cin, cout, dg):
    rows, kc = b * h * w, 9 * (cin // dg)
    cfg = dcn_cuda.wgrad_config(rows, kc, cout, dg)
    assert dcn_cuda.wgrad_config_ok(cfg)
    assert dcn_cuda.wgrad_smem_bytes(cfg) <= 232448 and 1 <= cfg.threads <= 256
    # out-channel tiles of up to 128, micro-tiles of 4 columns x mo
    # out-channels, whole stages per chunk
    assert cfg.to >= min(cout, 128) and cfg.to < min(cout, 128) + cfg.mo
    assert cfg.mo == (8 if cout > 32 else 4) and cfg.chunk_rows % cfg.stage_rows == 0
    assert cfg.tiles(kc, cout) <= 65535
    # every weight has one writer in each chunk's partial
    assert (_wgrad_cover(kc, cin, cout, dg, cfg) == 1).all()
    # the chunks cover every row once
    rows_seen = np.zeros(rows, np.int64)
    for c in range(cfg.chunks(rows)):
        rows_seen[c * cfg.chunk_rows:(c + 1) * cfg.chunk_rows] += 1
    assert (rows_seen == 1).all() and cfg.chunks(rows) * cfg.chunk_rows >= rows
    # a stage's gather items: thread t takes rows t // nqj and t // nqj + nv
    # at column quad t % nqj, every (row, quad) of the stage once
    nqj, nv = cfg.tj // 4, cfg.to // cfg.mo
    items = np.zeros((cfg.stage_rows, nqj), np.int64)
    for t in range(cfg.threads):
        for u in range(2):
            items[t // nqj + u * nv, t % nqj] += 1
    assert (items == 1).all()


# -- the backward ---------------------------------------------------------

GEOMETRIES = [(1, 1, 1), (2, 1, 1), (1, 2, 2)]  # (stride, padding, dilation)


def _bwd_case(stride, padding, dilation, with_bias):
    """The reference's fused-backward case (tests/test_dcn_pallas.py:
    test_fused_backward_matches_jnp_backward): B 2, 9x11, Cin = Cout = 8,
    dg 2, offsets * 1.5, sigmoid mask, a seeded output cotangent."""
    rng = np.random.default_rng(9)
    b, h, w, cin, cout, dg = 2, 9, 11, 8, 8, 2
    ho = (h + 2 * padding - (dilation * 2 + 1)) // stride + 1
    wo = (w + 2 * padding - (dilation * 2 + 1)) // stride + 1
    f32 = np.float32
    inp = dict(
        x=rng.standard_normal((b, h, w, cin)).astype(f32),
        offsets=(rng.standard_normal((b, ho, wo, dg, 9, 2)) * 1.5).astype(f32),
        mask=(1 / (1 + np.exp(-rng.standard_normal((b, ho, wo, dg, 9))))).astype(f32),
        weight=(rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(f32),
        bias=rng.standard_normal(cout).astype(f32) if with_bias else None,
    )
    cot = rng.standard_normal((b, ho, wo, cout)).astype(f32)
    return inp, cot, dict(stride=stride, padding=padding, dilation=dilation)


def _jax_grads(fn, inp, cot, geom):
    """Cotangents of (x, offsets, mask, weight[, bias]) by ``jax.grad``."""
    args = [jnp.asarray(inp[k]) for k in ("x", "offsets", "mask", "weight")]
    with_bias = inp["bias"] is not None
    if with_bias:
        args.append(jnp.asarray(inp["bias"]))

    def loss(*a):
        bias = a[4] if with_bias else None
        return (fn(*a[:4], bias, **geom) * jnp.asarray(cot)).sum()

    return jax.grad(loss, argnums=tuple(range(len(args))))(*args)


def _pallas_train(x, offsets, mask, weight, bias, stride, padding, dilation):
    # the train-direction op: _dcn_kernel forward, _dcn_bwd_kernel backward
    return deform_conv2d_pallas(x, offsets, mask, weight, bias, stride, padding,
                                dilation, True)


@pytest.mark.parametrize("stride,padding,dilation", GEOMETRIES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_backward_matches_jnp_autodiff(stride, padding, dilation, with_bias):
    inp, cot, geom = _bwd_case(stride, padding, dilation, with_bias)
    t = _torch(inp)
    got = TD.deform_conv2d_backward(t["x"], t["offsets"], t["mask"], t["weight"],
                                    torch.from_numpy(cot), **geom)
    ref = _jax_grads(JD.deform_conv2d, inp, cot, geom)
    for a, r in zip(got, ref):  # gbias only when there is a bias
        assert a.shape == r.shape
        _check(a.numpy(), r)


@pytest.mark.parametrize("stride,padding,dilation", GEOMETRIES)
def test_plain_backward_matches_fused_pallas_backward(stride, padding, dilation):
    """Against the fused Pallas backward ``_dcn_bwd_kernel`` in interpret
    mode (with the bias: its cotangent is summed outside the kernel)."""
    inp, cot, geom = _bwd_case(stride, padding, dilation, True)
    t = _torch(inp)
    got = TD.deform_conv2d_backward(t["x"], t["offsets"], t["mask"], t["weight"],
                                    torch.from_numpy(cot), **geom)
    ref = _jax_grads(_pallas_train, inp, cot, geom)
    for a, r in zip(got, ref):
        _check(a.numpy(), r)


@pytest.mark.parametrize("cg,cout", [(16, 128), (32, 256)])
def test_plain_backward_matches_fused_pallas_backward_wide_groups(cg, cout):
    """The widths of basech 16 and 32 (dg 8, Cin = 8 Cg): the plain
    backward, gW and the other cotangents, against the interpret-mode fused
    Pallas backward, which accumulates gW for any Cg and Cout, and jnp
    autodiff, at B 1 on a 6x7 image."""
    rng = np.random.default_rng(cg)
    b, h, w, dg = 1, 6, 7, 8
    cin = dg * cg
    f32 = np.float32
    inp = dict(
        x=rng.standard_normal((b, h, w, cin)).astype(f32),
        offsets=(rng.standard_normal((b, h, w, dg, 9, 2)) * 1.5).astype(f32),
        mask=(1 / (1 + np.exp(-rng.standard_normal((b, h, w, dg, 9))))).astype(f32),
        weight=(rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(f32),
        bias=rng.standard_normal(cout).astype(f32),
    )
    cot = rng.standard_normal((b, h, w, cout)).astype(f32)
    geom = dict(stride=1, padding=1, dilation=1)
    t = _torch(inp)
    got = TD.deform_conv2d_backward(t["x"], t["offsets"], t["mask"], t["weight"],
                                    torch.from_numpy(cot), **geom)
    for fn in (_pallas_train, JD.deform_conv2d):
        ref = _jax_grads(fn, inp, cot, geom)
        assert len(got) == len(ref) == 5
        for a, r in zip(got, ref):
            assert a.shape == r.shape
            _check(a.numpy(), r)


def test_cpu_train_direction_is_the_plain_version_under_autograd():
    """On the CPU the model's DCN runs the plain version with autograd in
    the train direction, and every train kernel wrapper computes its plain
    version without a launch."""
    inp, cot, geom = _bwd_case(1, 1, 1, True)
    t = _torch(inp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in t.items()}
    dcn_cuda.reset_launches()
    out = dcn_cuda.dcn(**leaves, **geom)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(cot))
    ref = TD.deform_conv2d_backward(t["x"], t["offsets"], t["mask"], t["weight"],
                                    torch.from_numpy(cot), **geom)
    for name, r in zip(("x", "offsets", "mask", "weight", "bias"), ref):
        np.testing.assert_array_equal(leaves[name].grad.numpy(), r.numpy())
    np.testing.assert_array_equal(dcn_train_fwd(**t, **geom).numpy(),
                                  TD.deform_conv2d(**t, **geom).numpy())
    gx, goff, gmask = dcn_bwd(t["x"], t["offsets"], t["mask"], t["weight"],
                              torch.from_numpy(cot), **geom)
    gw = dcn_wgrad(t["x"], t["offsets"], t["mask"], t["weight"].shape,
                   torch.from_numpy(cot), **geom)
    for a, r in zip((gx, goff, gmask, gw), ref):
        np.testing.assert_array_equal(a.numpy(), r.numpy())
    with torch.no_grad():
        assert dcn_cuda.dcn(**leaves, **geom).grad_fn is None
    assert [k.launches for k in dcn_cuda.KERNELS] == [0, 0, 0, 0, 0, 0]


@pytest.mark.gpu
def test_autograd_through_the_kernels_on_card(cuda_device):
    """The repair of the DCN under autograd on the card: a loss through the
    model's DCN reaches x, offsets, mask, weight and bias through the train
    kernels, with the plain path's gradients; the forward kernel refuses
    inputs that need a gradient instead of cutting them off the graph."""
    inp = _torch(_inputs(8, 2, 12, 20, 64, 64, 8, with_bias=True), cuda_device)
    grads = {}
    for path in ("kernel", "plain"):
        leaves = {k: v.clone().requires_grad_(True) for k, v in inp.items()}
        dcn_cuda.reset_launches()
        fn = dcn_cuda.dcn if path == "kernel" else TD.deform_conv2d
        out = fn(**leaves)
        (out ** 2).sum().backward()
        torch.cuda.synchronize()
        if path == "kernel":
            assert out.grad_fn is not None
            assert [k.launches for k in dcn_cuda.KERNELS] == [0, 1, 1, 1, 0, 0]
        grads[path] = {k: v.grad for k, v in leaves.items()}
    for k, ref in grads["plain"].items():
        assert grads["kernel"][k] is not None, k
        _check(grads["kernel"][k].cpu().numpy(), ref.cpu().numpy())
    with pytest.raises(RuntimeError, match="require grad"):
        dcn_fwd(**{k: v.clone().requires_grad_(True) for k, v in inp.items()})


@pytest.mark.gpu
@pytest.mark.parametrize("dg,h,w,cin,cout", [(8, 12, 20, 64, 64), (1, 7, 9, 4, 8),
                                             (4, 4, 150, 16, 8), (2, 64, 64, 64, 64),
                                             (8, 12, 20, 128, 128), (8, 12, 20, 384, 384),
                                             (8, 12, 20, 512, 512), (8, 12, 20, 1024, 1024)])
def test_train_kernels_match_plain_on_card(cuda_device, dg, h, w, cin, cout):
    """The flagship, the basech-16 bottleneck and small shapes take the
    backward's ownership path; a 64x64 image of 32 channels per group its
    global vector-red path; the basech-48, -64 and -128 bottlenecks (Cg 48,
    64, 128) its wide kernel. The weight gradient takes every width."""
    cfg = dcn_cuda.bwd_config(h, w, h, w, cin, cout, dg, 9)
    assert cfg.own == (h != 64 and cin // dg <= 32)
    assert (cfg.to > 0) == (cin // dg > 32)
    inp = _torch(_inputs(9, 2, h, w, cin, cout, dg, with_bias=True), cuda_device)
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, h, w, cout)).astype(np.float32)).to(cuda_device)
    x, off, mask, wt = inp["x"], inp["offsets"], inp["mask"], inp["weight"]
    out = dcn_train_fwd(**inp)
    gx, goff, gmask = dcn_bwd(x, off, mask, wt, g)
    gw = dcn_wgrad(x, off, mask, wt.shape, g)
    torch.cuda.synchronize()
    ref = TD.deform_conv2d_backward(x, off, mask, wt, g)
    _check(out.cpu().numpy(), TD.deform_conv2d(**inp).cpu().numpy())
    for a, r in zip((gx, goff, gmask, gw), ref):
        _check(a.cpu().numpy(), r.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [4, 32])
def test_forward_batch_invariant_on_card(cuda_device, b):
    """Every image of a B=4 and a B=32 call is bitwise the same image alone
    at B=1, though the batches get other launch configurations."""
    inp = _torch(_inputs(12, b, 12, 20, 64, 64, 8, with_bias=True), cuda_device)
    assert dcn_cuda.fwd_config(b * 240, 64) != dcn_cuda.fwd_config(240, 64)
    out = dcn_fwd(**inp)
    for i in range(b):
        alone = dcn_fwd(**{k: (v[i:i + 1].contiguous() if k in ("x", "offsets", "mask") else v)
                           for k, v in inp.items()})
        assert torch.equal(alone.view(torch.int32), out[i:i + 1].view(torch.int32)), i


# -- activity masking (dcn_sparse) -----------------------------------------

MASK_TOL = 1e-5  # masked DCN vs the reference's masked kernels, of max |ref|


def _masked_case(case, b=3, h=7, w=9):
    """Inputs with image 1 all zero (a truthful inactive image), or with a
    NaN in image 0 (the case ``dcn_image_activity`` keeps active)."""
    inp = _inputs(21, b, h, w, 8, 8, 2, with_bias=True)
    inp["x"][1] = 0.0
    if case == "nan_image":
        inp["x"][0, 2, 3, 1] = np.nan
    return inp


def _ref_masked(direction, inp, tm):
    fn = deform_conv2d_pallas_fwd if direction == "fwd" else deform_conv2d_pallas
    j = [jnp.asarray(inp[k]) for k in ("x", "offsets", "mask", "weight", "bias")]
    return np.asarray(fn(*j, 1, 1, 1, True, jnp.asarray(tm)))


@pytest.mark.parametrize("direction", ["fwd", "train"])
@pytest.mark.parametrize("form", ["per_image", "per_tile"])
@pytest.mark.parametrize("case", ["zero_image", "nan_image"])
def test_masked_plain_matches_pallas_masked_kernels(direction, form, case):
    """``deform_conv2d_masked`` (and ``deform_conv2d_auto(sparse=True)``)
    against ``deform_conv2d_pallas_fwd`` / ``deform_conv2d_pallas`` with a
    ``tile_mask``, in interpret mode: masked-off rows are exactly the bias,
    the rest within 1e-5 of max |ref|; a NaN image stays NaN."""
    inp = _masked_case(case)
    t = _torch(inp)
    act = TD.dcn_image_activity(t["x"])
    np.testing.assert_array_equal(act.numpy(), np.asarray(JD_activity(jnp.asarray(inp["x"]))))
    _, n_tiles = TD.output_tiling(t["x"], t["offsets"], direction)
    tm = act.numpy() if form == "per_image" else np.repeat(act.numpy()[:, None], n_tiles, 1)
    ref = _ref_masked(direction, inp, tm)
    got = TD.deform_conv2d_masked(**t, tile_mask=torch.from_numpy(tm),
                                  direction=direction).numpy()
    if direction == "fwd":
        auto = TD.deform_conv2d_auto(**t, sparse=True).numpy()
        np.testing.assert_array_equal(auto, got)
    np.testing.assert_array_equal(got[1], np.broadcast_to(inp["bias"], got[1].shape))
    np.testing.assert_array_equal(ref[1], got[1])
    live = [i for i in range(3) if i != 1 and not (case == "nan_image" and i == 0)]
    assert np.abs(got[live] - ref[live]).max() <= MASK_TOL * np.abs(ref[live]).max()
    if case == "nan_image":
        assert np.isnan(got[0]).any() and np.isnan(ref[0]).any()


@pytest.mark.parametrize("direction", ["fwd", "train"])
def test_explicit_multi_tile_mask_matches_pallas(direction):
    """A ``[B, n_tiles]`` mask over a 40x40 output (13 forward tiles of 128
    pixels, 7 train tiles of 256): the port's tiles are the reference's."""
    rng = np.random.default_rng(22)
    inp = _inputs(23, 2, 40, 40, 4, 4, 1, with_bias=True)
    t = _torch(inp)
    no_tile, n_tiles = TD.output_tiling(t["x"], t["offsets"], direction)
    assert (no_tile, n_tiles) == ((128, 13) if direction == "fwd" else (256, 7))
    tm = (rng.random((2, n_tiles)) < 0.5).astype(np.float32)
    ref = _ref_masked(direction, inp, tm)
    got = TD.deform_conv2d_masked(**t, tile_mask=torch.from_numpy(tm),
                                  direction=direction).numpy()
    off = ~(tm[:, np.arange(1600) // no_tile] > 0).reshape(2, 40, 40)
    assert off.any() and (~off).any()
    np.testing.assert_array_equal(got[off], ref[off])
    np.testing.assert_array_equal(got[off], np.broadcast_to(inp["bias"], got[off].shape))
    assert np.abs(got[~off] - ref[~off]).max() <= MASK_TOL * np.abs(ref[~off]).max()


def test_mask_shape_error_and_activity_or():
    inp = _torch(_masked_case("zero_image"))
    with pytest.raises(ValueError, match="does not match the kernel grid") as port_err:
        TD.tile_mask_grid(torch.ones(3, 2), 3, 1)
    with pytest.raises(ValueError, match="does not match the kernel grid") as ref_err:
        JD_tile_mask_grid(jnp.ones((3, 2)), 3, 1)
    assert str(port_err.value) == str(ref_err.value)
    # the caller's activity can only keep an image, never skip a live one
    dense = TD.deform_conv2d(**inp).numpy()
    kept = TD.deform_conv2d_auto(**inp, sparse=True,
                                 activity=torch.tensor([0.0, 1.0, 0.0])).numpy()
    np.testing.assert_array_equal(kept, dense)
    assert np.abs(dense[1]).max() > 0  # the bias
    with pytest.raises(ValueError, match="takes no tile_mask"):
        dcn_fwd(**inp, tile_mask=torch.ones(3))
    with pytest.raises(ValueError, match="needs tile_mask"):
        dcn_cuda.dcn_fwd_masked(**inp)


def test_masked_wrappers_on_cpu_take_the_plain_version():
    """On CPU tensors the masked wrappers compute ``deform_conv2d_masked``
    and launch nothing; under grad the masked train direction is the plain
    masked version with autograd."""
    inp = _torch(_masked_case("zero_image"))
    tm = torch.tensor([1.0, 0.0, 1.0])
    dcn_cuda.reset_launches()
    for wrapper, direction in ((dcn_cuda.dcn_fwd_masked, "fwd"),
                               (dcn_cuda.dcn_train_fwd_masked, "train")):
        np.testing.assert_array_equal(
            wrapper(**inp, tile_mask=tm).numpy(),
            TD.deform_conv2d_masked(**inp, tile_mask=tm, direction=direction).numpy())
    leaves = {k: v.clone().requires_grad_(True) for k, v in inp.items()}
    out = dcn_cuda.dcn(**leaves, tile_mask=tm)
    out.sum().backward()
    assert leaves["x"].grad is not None and leaves["weight"].grad is not None
    assert [k.launches for k in dcn_cuda.KERNELS] == [0, 0, 0, 0, 0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("direction", ["fwd", "train"])
def test_masked_kernels_bitwise_to_dense_on_card(cuda_device, direction):
    """On truthful masks the masked kernel equals its dense kernel bitwise,
    also at B=32 where a block's 32 rows straddle two images (240 % 32 != 0);
    a NaN image stays NaN."""
    masked = dcn_cuda.dcn_fwd_masked if direction == "fwd" else dcn_cuda.dcn_train_fwd_masked
    dense = dcn_fwd if direction == "fwd" else dcn_train_fwd
    inp = _torch(_inputs(24, 32, 12, 20, 64, 64, 8, with_bias=True), cuda_device)
    inp["x"][1::2] = 0.0
    inp["x"][0, 1, 2, 3] = float("nan")
    tm = TD.dcn_image_activity(inp["x"])
    assert tm.tolist() == [1.0, 0.0] * 16
    out = masked(**inp, tile_mask=tm)
    ref = dense(**inp)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert bool(torch.isnan(out[0]).any())


@pytest.mark.gpu
@pytest.mark.parametrize("dg,h,w,cin,cout", [(8, 12, 20, 64, 64), (2, 64, 64, 64, 64),
                                             (8, 12, 20, 512, 512)])
def test_backward_gx_is_bitwise_run_to_run_and_across_paths_on_card(
        cuda_device, dg, h, w, cin, cout):
    """gx is summed in 64-bit fixed point: the same bits from run to run, and
    on the ownership path the same bits as the global path (the flagship
    forced off its slices); the wide kernel (Cg 64) repeats itself too."""
    inp = _torch(_inputs(12, 2, h, w, cin, cout, dg, with_bias=False), cuda_device)
    g = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (2, h, w, cout)).astype(np.float32)).to(cuda_device)
    x, off, mask, wt = inp["x"], inp["offsets"], inp["mask"], inp["weight"]
    first = dcn_bwd(x, off, mask, wt, g)
    again = dcn_bwd(x, off, mask, wt, g)
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    cfg = dcn_cuda.bwd_config(h, w, h, w, cin, cout, dg, 9)
    if cfg.own:
        lib = dcn_cuda.TRAIN_LIBRARY.load()
        glob = dcn_cuda.BwdConfig(64, 64, 9, False)
        gx = torch.empty_like(x)
        goff, gmask = torch.empty_like(off), torch.empty_like(mask)
        scratch = dcn_cuda.bwd_scratch(x, glob)
        rc = lib.dcn_bwd_pixel_f32(
            x.data_ptr(), off.data_ptr(), mask.data_ptr(), wt.data_ptr(), g.data_ptr(),
            gx.data_ptr(), goff.data_ptr(), gmask.data_ptr(), scratch.data_ptr(),
            2, h, w, cin, h, w, cout, dg, 3, 3, 1, 1, 1, glob.chunk_rows, glob.tp,
            glob.kt, 0, 0, torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        torch.cuda.synchronize()
        assert torch.equal(gx.view(torch.int32), first[0].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("b,cin,cout,hw,k,stride", [
    (3, 2, 8, (96, 160), 3, 1), (3, 8, 16, (96, 160), 3, 2), (1, 64, 216, (12, 20), 3, 1),
    (4, 192, 192, (12, 20), 3, 1), (4, 64, 2, (12, 20), 1, 1), (1, 64, 32, (1, 1), 1, 1),
    (17, 64, 128, (1, 1), 1, 1)])
def test_int8_kernels_match_plain_on_card(cuda_device, b, cin, cout, hw, k, stride):
    """K2 (the per-tensor quantization) and K1 (the int8 convolution) are
    bitwise their plain versions at the flagship's kinds of shapes: the head
    conv (Cin 2), a stride-2 conv, the offset/mask conv (216), the local
    residual (192), 1x1 convs and the channel MLP as a 1x1 conv."""
    from esr_tpu_torch.ops import int8_cuda

    rng = np.random.default_rng(cin + cout)
    x = torch.from_numpy(rng.standard_normal((b, cin, *hw)).astype(np.float32)).to(cuda_device)
    wgt = torch.from_numpy((rng.standard_normal((cout, cin, k, k)) * 0.1).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(cuda_device)
    packed = int8_cuda.pack_weight(wgt.to(cuda_device))
    int8_cuda.reset_launches()
    xq, sx = int8_cuda.quantize_per_tensor(x)
    out = int8_cuda.int8_conv(xq, sx, packed, bias, stride, k // 2)
    torch.cuda.synchronize()
    assert [kk.launches for kk in int8_cuda.KERNELS] == [1, 1]
    pq, psx = int8_cuda.quantize_per_tensor_plain(x)
    assert torch.equal(xq, pq) and torch.equal(sx, psx)
    ref = int8_cuda.int8_conv_plain(pq, psx, packed, bias, stride, k // 2)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


# -- the kernels as torch.library custom ops ----------------------------------

def _op_args(name):
    """Arguments of the op ``esr_tpu_torch::<name>`` at a small CPU shape,
    and a copy with one shape broken."""
    from esr_tpu_torch.ops import int8_cuda

    inp = _torch(_inputs(11, 2, 6, 7, 16, 8, 2, with_bias=True))
    x, off, mask, wt, bias = (inp[k] for k in ("x", "offsets", "mask", "weight", "bias"))
    g = torch.from_numpy(np.random.default_rng(12).standard_normal((2, 6, 7, 8)).astype(np.float32))
    geom = (1, 1, 1)
    if name in ("dcn_fwd", "dcn_train_fwd"):
        return (x, off, mask, wt, bias, *geom), (x, off[:, :5], mask, wt, bias, *geom)
    if name in ("dcn_fwd_masked", "dcn_train_fwd_masked"):
        tm = torch.tensor([1.0, 0.0])
        return (x, off, mask, wt, bias, tm, *geom), (x, off, mask, wt, bias, tm[:1], *geom)
    if name == "dcn_bwd":
        return (x, off, mask, wt, g, *geom), (x, off, mask, wt, g[:, :5], *geom)
    if name == "dcn_wgrad":
        return (x, off, mask, list(wt.shape), g, *geom), (x, off, mask, [3, 3, 8, 8], g, *geom)
    xc = torch.from_numpy(np.random.default_rng(13).standard_normal((2, 6, 5, 7)).astype(np.float32))
    if name == "quantize_per_tensor":
        return (xc,), (xc[0],)
    w = int8_cuda.pack_weight(torch.from_numpy(
        np.random.default_rng(14).standard_normal((10, 6, 3, 3)).astype(np.float32)))
    xq, sx = int8_cuda.quantize_per_tensor_plain(xc)
    return ((xq, sx, w.q, w.scale, w.wq, torch.zeros(10), 1, 1, w.nt),
            (xq, sx, w.q, w.scale, w.wq, torch.zeros(9), 1, 1, w.nt))


@pytest.mark.parametrize("name", ["dcn_fwd", "dcn_fwd_masked", "dcn_train_fwd",
                                  "dcn_train_fwd_masked", "dcn_bwd", "dcn_wgrad",
                                  "quantize_per_tensor", "int8_conv"])
def test_kernels_are_custom_ops_with_plain_and_fake_impls(name):
    """Each hand-written kernel is the op ``esr_tpu_torch::<name>`` that its
    wrapper calls: the CPU implementation is the plain version (launching
    nothing), the fake implementation gives the real outputs' shapes and
    types (``torch.library.opcheck``: schema and fake tensors) and refuses a
    shape the kernel would refuse, so a bad call fails at export."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from esr_tpu_torch.ops import int8_cuda

    kernel = {k.name: k for k in dcn_cuda.KERNELS + int8_cuda.KERNELS}[name]
    assert kernel.op is getattr(torch.ops.esr_tpu_torch, name).default
    args, bad = _op_args(name)
    dcn_cuda.reset_launches()
    int8_cuda.reset_launches()
    real = kernel.op(*args)
    if name in ("dcn_bwd", "dcn_wgrad"):
        # their plain version differentiates the plain forward by autograd,
        # which opcheck's dispatch modes turn off below them: the fake
        # outputs are held against the real ones here instead
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = kernel.op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                               for a in args])
        for f, r in zip(torch.utils._pytree.tree_leaves(fake),
                        torch.utils._pytree.tree_leaves(real)):
            assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype, r.stride())
    else:
        torch.library.opcheck(kernel.op, args, test_utils=("test_schema", "test_faketensor"))
    assert kernel.launches == 0
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fakes = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in bad]
        with pytest.raises(ValueError):
            kernel.op(*fakes)
