"""The port's DCNv2: the plain PyTorch version against the jnp reference
and against the Pallas forward kernel run in interpret mode; the dispatch
and the CUDA kernel's wrapper on CPU tensors; the kernel itself on a card.

Bound: the reference's scale-normalized forward criterion
(``dcn_fwd_parity_ok`` off-TPU), max|a - b| <= 1e-3 * max(max|ref|, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.ops import dcn as JD
from esr_tpu.ops.dcn_pallas import deform_conv2d_pallas_fwd
from esr_tpu_torch.ops import dcn as TD
from esr_tpu_torch.ops.dcn_cuda import dcn_fwd

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
