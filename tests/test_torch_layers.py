"""The port's layers, pad/crop helpers and resizes against the flax
reference at f32 on the CPU.

Both sides get the same seeded numpy inputs and the same weights (the flax
init, brought across by ``esr_tpu_torch.models.convert``). Tolerance:
atol 1e-5 + rtol 1e-5; the measured envelope is ~1e-7 (the same f32 convs
summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esr_tpu.config import precision as FP
from esr_tpu.config import quantize as FQ
from esr_tpu.models import layers as FL
from esr_tpu.models import model_util as FU
from esr_tpu.ops import resize as FR
from esr_tpu.data import np_encodings as FNE
from esr_tpu_torch.config import precision as TP
from esr_tpu_torch.config import quantize as TQ
from esr_tpu_torch.data import np_encodings as TNE
from esr_tpu_torch.device import resolve_device
from esr_tpu_torch.models import convert
from esr_tpu_torch.models import layers as TL
from esr_tpu_torch.models import model_util as TU
from esr_tpu_torch.ops import resize as TR

TOL = dict(atol=1e-5, rtol=1e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


# name -> (flax module, port module, input shapes (NHWC), kind)
CASES = {
    "conv_relu_stride2": (FL.ConvLayer(5, 3, stride=2, padding=1),
                          lambda: TL.ConvLayer(3, 5, 3, stride=2, padding=1),
                          [(2, 9, 11, 3)], "image"),
    "conv_sigmoid_1x1": (FL.ConvLayer(2, 1, padding=0, activation="sigmoid"),
                         lambda: TL.ConvLayer(4, 2, 1, padding=0, activation="sigmoid"),
                         [(2, 5, 6, 4)], "image"),
    "conv_linear": (FL.ConvLayer(4, 3, padding=1, activation=None),
                    lambda: TL.ConvLayer(3, 4, 3, padding=1, activation=None),
                    [(1, 7, 5, 3)], "image"),
    "residual_block": (FL.ResidualBlock(6), lambda: TL.ResidualBlock(6),
                       [(2, 7, 9, 6)], "image"),
    "upsample_conv": (FL.UpsampleConvLayer(4, 3, padding=1),
                      lambda: TL.UpsampleConvLayer(3, 4, 3, padding=1),
                      [(2, 5, 7, 3)], "image"),
    "convgru_cell": (FL.ConvGRUCell(4), lambda: TL.ConvGRUCell(3, 4),
                     [(2, 6, 8, 3), (2, 6, 8, 4)], "cell"),
    "recurrent_conv": (FL.RecurrentConvLayer(4, 3, padding=1),
                       lambda: TL.RecurrentConvLayer(3, 4, 3, padding=1),
                       [(2, 6, 8, 3), (2, 6, 8, 4)], "recurrent"),
    "mlp": (FL.MLP(hidden_dim=4, output_dim=6, num_layers=2),
            lambda: TL.MLP(5, 4, 6, num_layers=2), [(3, 5)], "vector"),
}


@pytest.fixture(scope="module")
def layer_pairs():
    """Each case's seeded inputs, flax params and the converted port module."""
    resolve_device("cpu")
    out = {}
    for i, (name, (fmod, tctor, shapes, kind)) in enumerate(CASES.items()):
        rng = np.random.default_rng(i)
        xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        params = fmod.init(jax.random.PRNGKey(i), *xs)
        params = jax.tree.map(np.asarray, params)
        tmod = tctor()
        convert.load_flax_params(tmod, params)
        out[name] = (fmod, params, tmod, xs, kind)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_flax(layer_pairs, name):
    fmod, params, tmod, xs, kind = layer_pairs[name]
    ref = fmod.apply(params, *xs)
    with torch.no_grad():
        if kind == "vector":
            got = tmod(torch.from_numpy(xs[0])).numpy()
            np.testing.assert_allclose(got, np.asarray(ref), **TOL)
            return
        outs = tmod(*[_nchw(x) for x in xs])
    if kind == "recurrent":
        for r, g in zip(ref, outs):
            np.testing.assert_allclose(_nhwc(g), np.asarray(r), **TOL)
    else:
        np.testing.assert_allclose(_nhwc(outs), np.asarray(ref), **TOL)


def test_f32_policy_turns_tf32_off():
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("hw", [(20, 28), (16, 16), (13, 5), (90, 160)])
def test_pad_and_crop_match_reference(hw):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    x = rng.standard_normal((2, 3, *hw, 2)).astype(np.float32)
    spec = TU.compute_pad(*hw, 8, 8)
    assert tuple(spec) == tuple(FU.compute_pad(*hw, 8, 8))
    padded = TU.pad_image(torch.from_numpy(x), spec)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(FU.pad_image(jnp.asarray(x), spec)))
    for scale in (1, 2):
        big = rng.standard_normal((2, spec.padded_height * scale,
                                   spec.padded_width * scale, 2)).astype(np.float32)
        np.testing.assert_array_equal(
            TU.crop_image(torch.from_numpy(big), spec, scale).numpy(),
            np.asarray(FU.crop_image(jnp.asarray(big), spec, scale)),
        )
    assert TU.crop_image(padded, spec).shape == x.shape


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("in_hw,out_hw", [((8, 8), (16, 16)), ((15, 9), (30, 18)),
                                          ((16, 16), (8, 8)), ((45, 80), (90, 160))])
def test_resize_matches_reference(mode, in_hw, out_hw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *in_hw, 3)).astype(np.float32)
    ref = np.asarray(FR.interpolate(jnp.asarray(x), out_hw, mode=mode))
    got = TR.interpolate(torch.from_numpy(x), out_hw, mode=mode).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
    got3 = TR.interpolate(torch.from_numpy(x[0]), out_hw, mode=mode).numpy()
    np.testing.assert_allclose(got3, ref[0], atol=2e-5, rtol=1e-4)
    # the host (numpy) path is the same matrices, so it agrees exactly
    np.testing.assert_array_equal(TNE.interpolate_np(x[0], out_hw, mode),
                                  FNE.interpolate_np(x[0], out_hw, mode))


def test_interpolate_scale_form():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 6, 2)).astype(np.float32)
    up = TR.interpolate_scale(torch.from_numpy(x), 2)
    ref = FR.interpolate_scale(jnp.asarray(x), 2)
    assert up.shape == (8, 12, 2)
    np.testing.assert_allclose(up.numpy(), np.asarray(ref), atol=2e-5)
    with pytest.raises(ValueError):
        TR.interpolate(torch.from_numpy(x), (3, 3), mode="area")


# -- the precision rungs: the policy, the quantizer and the contraction seams --
#
# The int8 seam is bitwise the reference's given the same input: the
# contraction is exact on both sides (int32 in XLA, int8 values in f64 in the
# port's plain version, which the CPU runs), and the quantize / dequantize
# steps are the same IEEE operations in the same order. The bf16 seam rounds
# the same f32-accumulated product to bf16 on both sides, then adds the bias
# in bf16; measured bitwise equal at these shapes on the CPU, held to one
# bf16 ulp of the output's scale (2**-8), since XLA's and oneDNN's
# accumulation orders may round a value to neighbouring bf16 numbers.

SPELLINGS = ["f32", "FP32", " float32 ", "bf16", "BFloat16", "int8", "i8", "w8a8",
             "half", "fp16", "f64", "int4", "", "f32x"]
BF16_SEAM_TOL = 2.0 ** -8


@pytest.mark.parametrize("name", SPELLINGS)
def test_precision_spellings_match_reference(name):
    for fn in ("canonical_precision", "canonical_dtype", "compute_dtype_of"):
        try:
            want = getattr(FP, fn)(name)
        except ValueError:
            with pytest.raises(ValueError):
                getattr(TP, fn)(name)
            continue
        got = getattr(TP, fn)(name)
        if fn == "compute_dtype_of":
            assert (got, want) in ((None, None), (torch.bfloat16, jnp.bfloat16))
        else:
            assert got == want
    assert TP.PRECISIONS == FP.PRECISIONS


@pytest.mark.parametrize("cli,config", [(None, None), ("bf16", None), (None, "bf16"),
                                        ("int8", "bf16"), ("f32", "int8"),
                                        (None, "w8a8"), ("fp8", None), (None, "fp8")])
def test_resolve_precision_precedence_matches_reference(cli, config):
    try:
        want = FP.resolve_precision(cli=cli, config=config)
    except ValueError:
        with pytest.raises(ValueError, match="unknown precision"):
            TP.resolve_precision(cli=cli, config=config)
        return
    assert TP.resolve_precision(cli=cli, config=config) == want
    assert TP.resolve_precision(cli=cli, config=config, default="bf16") == \
        FP.resolve_precision(cli=cli, config=config, default="bf16")
    assert TP.compute_dtype_of(None) is None


def _quant_input(axis):
    rng = np.random.default_rng(7 if axis is None else 8 + axis)
    x = (rng.standard_normal((6, 5, 3, 3)) * rng.uniform(0.01, 10, (6, 1, 1, 1))
         ).astype(np.float32)
    x[2] = 0.0  # an all-zero output channel (scale 1e-12 / 127)
    x[..., 1] = 0.0
    return x


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_quantize_symmetric_is_the_references_bitwise(axis):
    x = _quant_input(axis)
    qt, st = TQ.quantize_symmetric(torch.from_numpy(x), axis)
    qf, sf = FQ.quantize_symmetric(jnp.asarray(x), axis)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qf))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sf))
    np.testing.assert_array_equal(TQ.dequantize(qt, st).numpy(),
                                  np.asarray(FQ.dequantize(qf, sf)))
    # ties round half to even: amax 127 gives scale 1, so x / scale is exact
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5], np.float32)
    np.testing.assert_array_equal(TQ.quantize_symmetric(torch.from_numpy(ties))[0].numpy(),
                                  np.asarray(FQ.quantize_symmetric(jnp.asarray(ties))[0]))


# (cin, cout, kernel, stride): the head conv (Cin 2), the first stride-2
# conv (Cin 8), the bottleneck's 3x3 convs (Cin 64, the offset/mask conv's
# 216 out-channels) and its 1x1 convs (the spatial kernel's 2, the fusion's)
SEAM_CONVS = [(2, 8, 3, 1), (8, 16, 3, 2), (64, 64, 3, 1), (64, 216, 3, 1),
              (64, 2, 1, 1), (128, 64, 1, 1)]


@pytest.fixture(scope="module")
def seam_pairs():
    """Each seam case's flax conv, its params, the converted port layer and
    a seeded input; and the channel MLP's, for batches 1, 4 and 32."""
    convs = {}
    for cin, cout, k, stride in SEAM_CONVS:
        seed = cin + cout + k
        fmod = FL.ConvLayer(cout, k, stride=stride, padding=k // 2, activation=None)
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)
        params = jax.tree.map(np.asarray, fmod.init(jax.random.PRNGKey(seed), x))
        convs[(cin, cout, k, stride)] = (fmod, params, x)
    mlps = {}
    fmlp = FL.MLP(hidden_dim=32, output_dim=128, num_layers=2)
    for batch in (1, 4, 32):
        x = np.random.default_rng(batch).standard_normal((batch, 64)).astype(np.float32)
        mlps[batch] = (fmlp, jax.tree.map(np.asarray, fmlp.init(jax.random.PRNGKey(batch), x)),
                       x)
    return convs, mlps


def _seam_conv(seam_pairs, cin, cout, k, stride):
    fmod, params, x = seam_pairs[0][(cin, cout, k, stride)]
    tmod = TL.ConvLayer(cin, cout, k, stride=stride, padding=k // 2, activation=None)
    convert.load_flax_params(tmod, params)
    return fmod, tmod, params, x


def _seam_mlp(seam_pairs, batch):
    fmod, params, x = seam_pairs[1][batch]
    tmod = TL.MLP(64, 32, 128, num_layers=2)
    convert.load_flax_params(tmod, params)
    return fmod, tmod, params, x


@pytest.mark.parametrize("cin,cout,k,stride", SEAM_CONVS)
def test_int8_conv_seam_is_the_references_bitwise(seam_pairs, cin, cout, k, stride):
    fmod, tmod, params, x = _seam_conv(seam_pairs, cin, cout, k, stride)
    with FQ.int8_scope():
        ref = np.asarray(fmod.apply(params, x))
    with TQ.int8_scope():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_array_equal(got, ref)
    # the rung is a real one: it is not the f32 program
    assert not np.array_equal(got, _nhwc(tmod(_nchw(x))))
    # the packed weight is made once per weight, and again after an update
    with TQ.int8_scope():
        tmod(_nchw(x))
        packed = tmod.conv._int8_cache[1]
        tmod(_nchw(x))
        assert tmod.conv._int8_cache[1] is packed
        with torch.no_grad():
            tmod.conv.weight.mul_(2.0)
        tmod(_nchw(x))
        assert tmod.conv._int8_cache[1] is not packed


@pytest.mark.parametrize("batch", [1, 4, 32])
def test_int8_dense_seam_is_the_references_bitwise(seam_pairs, batch):
    fmod, tmod, params, x = _seam_mlp(seam_pairs, batch)
    with FQ.int8_scope():
        ref = np.asarray(fmod.apply(params, x))
    with TQ.int8_scope():
        got = tmod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cin,cout,k,stride", SEAM_CONVS[:3] + SEAM_CONVS[4:5])
def test_bf16_conv_seam_tracks_the_reference(seam_pairs, cin, cout, k, stride):
    fmod, tmod, params, x = _seam_conv(seam_pairs, cin, cout, k, stride)
    pb = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    ref = np.asarray(fmod.apply(pb, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    tmod = tmod.to(torch.bfloat16)
    got = tmod(_nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = _nhwc(got.float())
    scale = max(float(np.abs(ref).max()), 1.0)
    assert np.abs(got - ref).max() <= BF16_SEAM_TOL * scale


def test_bf16_dense_seam_tracks_the_reference(seam_pairs):
    fmod, tmod, params, x = _seam_mlp(seam_pairs, 4)
    pb = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    ref = np.asarray(fmod.apply(pb, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    got = tmod.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    scale = max(float(np.abs(ref).max()), 1.0)
    assert np.abs(got.float().detach().numpy() - ref).max() <= BF16_SEAM_TOL * scale


def test_f32_seams_are_the_stock_program_bitwise():
    """At f32 the seams run exactly what they replaced: ``F.conv2d`` with the
    bias, ``F.linear``, and ``F.interpolate`` as the upsampling's forward."""
    import torch.nn.functional as F

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 8, 9, 11)).astype(np.float32))
    conv = TL.Conv2d(8, 16, 3, stride=2, padding=1)
    want = F.conv2d(x, conv.weight, conv.bias, 2, 1)
    assert torch.equal(conv(x), want)
    lin = TL.Linear(8, 5)
    v = x[:, :, 0, 0]
    assert torch.equal(lin(v), F.linear(v, lin.weight, lin.bias))
    up = TL.UpsampleConvLayer(8, 4, 3, padding=1)
    ref = torch.relu(F.conv2d(F.interpolate(x, size=(18, 22), mode="bilinear",
                                            align_corners=False),
                              up.conv_layer.conv.weight, up.conv_layer.conv.bias, 1, 1))
    assert torch.equal(up(x), ref)
    # a bf16 conv in the same process leaves the f32 policy as it was
    resolve_device("cpu")
    conv.to(torch.bfloat16)(x.to(torch.bfloat16))
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 4, 1, 9), (3, 2, 6, 6)])
def test_upsample_backward_is_the_interpolation_gradient(shape):
    """The upsampling's backward (a product with the interpolation
    matrices, summed in a fixed order) against autograd through
    ``F.interpolate`` (the CPU's backward) and through the reference's
    resize: within f32 rounding (measured ~1e-7)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal((*shape[:2], 2 * shape[2], 2 * shape[3])).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (TL.upsample(xt, 2) * torch.from_numpy(g)).sum().backward()
    xr = torch.from_numpy(x).requires_grad_(True)
    (F.interpolate(xr, scale_factor=2, mode="bilinear", align_corners=False)
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), atol=1e-6, rtol=1e-6)
    gj = jax.grad(lambda a: jnp.sum(FR.interpolate_scale(a, 2, mode="bilinear")
                                    * jnp.moveaxis(jnp.asarray(g), 1, -1)))(
        jnp.moveaxis(jnp.asarray(x), 1, -1))
    np.testing.assert_allclose(xt.grad.numpy(), np.moveaxis(np.asarray(gj), -1, 1),
                               atol=1e-5, rtol=1e-5)
