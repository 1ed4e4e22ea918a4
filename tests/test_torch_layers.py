"""The port's layers, pad/crop helpers and resizes against the flax
reference at f32 on the CPU.

Both sides get the same seeded numpy inputs and the same weights (the flax
init, brought across by ``esr_tpu_torch.models.convert``). Tolerance:
atol 1e-5 + rtol 1e-5; the measured envelope is ~1e-7 (the same f32 convs
summed in another order). The UNet family's pieces are here too: the
ConvLSTM cell and block, the transposed conv at k 3 and 5 and p 0-2 (its
kernel crosses the bridge flipped in space), the 1D conv, the skips'
pad-or-crop alignment, the x4 bilinear upsampling and the bicubic resize
with its matrix backward. At bf16 (C8): the resize's and each layer's
output dtype and values against the reference's promotion.
"""

import copy
import functools

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
    "convlstm_cell": (FL.ConvLSTMCell(4), lambda: TL.ConvLSTMCell(3, 4),
                      [(2, 6, 8, 3), (2, 6, 8, 4), (2, 6, 8, 4)], "lstm"),
    "recurrent_convlstm": (FL.RecurrentConvLayer(4, 5, stride=2, padding=2,
                                                 recurrent_block_type="convlstm"),
                           lambda: TL.RecurrentConvLayer(3, 4, 5, stride=2, padding=2,
                                                         recurrent_block_type="convlstm"),
                           [(2, 9, 11, 3), (2, 5, 6, 4), (2, 5, 6, 4)], "lstm"),
    "conv1d": (FL.ConvLayer1D(4, 3, padding=1), lambda: TL.ConvLayer1D(3, 4, 3, padding=1),
               [(2, 9, 3)], "image"),
    "conv1d_stride2_linear": (FL.ConvLayer1D(5, 5, stride=2, padding=2, activation=None),
                              lambda: TL.ConvLayer1D(2, 5, 5, stride=2, padding=2,
                                                     activation=None),
                              [(3, 11, 2)], "image"),
}
for _k in (3, 5):
    for _p in (0, 1, 2):
        CASES[f"transposed_conv_k{_k}_p{_p}"] = (
            FL.TransposedConvLayer(4, _k, padding=_p),
            functools.partial(TL.TransposedConvLayer, 3, 4, _k, padding=_p),
            [(2, 5, 7, 3)], "image")


@pytest.fixture(scope="module")
def layer_pairs():
    """Each case's seeded inputs, flax params and the converted port module."""
    resolve_device("cpu")
    out = {}
    for i, (name, (fmod, tctor, shapes, kind)) in enumerate(CASES.items()):
        rng = np.random.default_rng(i)
        xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        params = fmod.init(jax.random.PRNGKey(i), *_cell_args(kind, xs))
        params = jax.tree.map(np.asarray, params)
        tmod = tctor()
        convert.load_flax_params(tmod, params)
        out[name] = (fmod, params, tmod, xs, kind)
    return out


def _cell_args(kind, xs):
    """A ConvLSTM's state is the pair ``(hidden, cell)``."""
    return (xs[0], (xs[1], xs[2])) if kind == "lstm" else tuple(xs)


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_flax(layer_pairs, name):
    fmod, params, tmod, xs, kind = layer_pairs[name]
    ref = fmod.apply(params, *_cell_args(kind, xs))
    with torch.no_grad():
        if kind == "vector":
            got = tmod(torch.from_numpy(xs[0])).numpy()
            np.testing.assert_allclose(got, np.asarray(ref), **TOL)
            return
        outs = tmod(*_cell_args(kind, [_nchw(x) for x in xs]))
    # every output leaf: the image, or (output, state) with a ConvLSTM's
    # state the pair (hidden, cell)
    refs = jax.tree.leaves(ref)
    gots = torch.utils._pytree.tree_leaves(outs)
    assert len(gots) == len(refs) >= 1
    for r, g in zip(refs, gots):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **TOL)


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


# -- the UNet family's skips and resizes ------------------------------------

# (x1 [H, W], x2 [H, W]): equal; padded (decoder 0 of the SR recipe, 12x20 ->
# 24x40); cropped (decoders 1 and 2, 96x160 -> 46x80 and 92x160 -> 90x160);
# odd differences each way; padded in one axis and cropped in the other
SKIP_SHAPES = [((6, 8), (6, 8)), ((12, 20), (24, 40)), ((96, 160), (46, 80)),
               ((92, 160), (90, 160)), ((7, 9), (4, 4)), ((3, 5), (6, 8)),
               ((5, 12), (8, 7))]


@pytest.mark.parametrize("kind", ["sum", "concat"])
@pytest.mark.parametrize("hw1,hw2", SKIP_SHAPES)
def test_skip_alignment_matches_reference(kind, hw1, hw2):
    rng = np.random.default_rng(hw1[0] * 100 + hw2[1])
    c2 = 3 if kind == "sum" else 2
    x1 = rng.standard_normal((2, *hw1, 3)).astype(np.float32)
    x2 = rng.standard_normal((2, *hw2, c2)).astype(np.float32)
    ref = np.asarray(getattr(FU, f"skip_{kind}")(jnp.asarray(x1), jnp.asarray(x2)))
    got = _nhwc(getattr(TU, f"skip_{kind}")(_nchw(x1), _nchw(x2)))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_upsample_x4_is_the_interpolation_and_its_gradient():
    """Decoder 0 of SRUNetRecurrent upsamples x4: the forward is the
    reference's bilinear x4 and the matrix backward is autograd's through
    ``F.interpolate`` at scale 4 (measured ~1.4e-6 on values up to ~10)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    g = rng.standard_normal((2, 3, 20, 28)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    up = TL.upsample(xt, 4)
    ref = FR.interpolate_scale(jnp.moveaxis(jnp.asarray(x), 1, -1), 4, mode="bilinear")
    np.testing.assert_allclose(_nhwc(up), np.asarray(ref), atol=2e-5, rtol=1e-4)
    (up * torch.from_numpy(g)).sum().backward()
    xr = torch.from_numpy(x).requires_grad_(True)
    (F.interpolate(xr, scale_factor=4, mode="bilinear", align_corners=False)
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), atol=1e-6, rtol=1e-6)


# (NCHW input, output size): the SR adapter's exact halvings, the recipe's
# 180x320 -> 90x160 among them, and one upscale
RESIZE_CASES = [((2, 2, 36, 64), (18, 32)), ((1, 3, 34, 46), (17, 23)),
                ((2, 2, 180, 320), (90, 160)), ((2, 2, 8, 10), (16, 20))]


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
@pytest.mark.parametrize("shape,size", RESIZE_CASES)
def test_resize_forward_and_backward(mode, shape, size):
    """``ops.resize.resize``: the forward is ``F.interpolate`` bit for bit
    and the reference's resize within f32 rounding; the backward (the
    interpolation matrices) is autograd's through ``F.interpolate`` on the
    CPU within 1e-6 (measured <= 2.4e-7) and the reference's gradient."""
    import torch.nn.functional as F

    rng = np.random.default_rng(shape[-1] + size[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal((*shape[:2], *size)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TR.resize(xt, size, mode)
    xr = torch.from_numpy(x).requires_grad_(True)
    want = F.interpolate(xr, size=size, mode=mode, align_corners=False)
    assert torch.equal(out, want)
    ref = FR.interpolate(jnp.moveaxis(jnp.asarray(x), 1, -1), size, mode=mode)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=2e-5, rtol=1e-4)
    (out * torch.from_numpy(g)).sum().backward()
    (want * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), atol=1e-6, rtol=1e-6)
    gj = jax.grad(lambda a: jnp.sum(FR.interpolate(a, size, mode=mode)
                                    * jnp.moveaxis(jnp.asarray(g), 1, -1)))(
        jnp.moveaxis(jnp.asarray(x), 1, -1))
    np.testing.assert_allclose(xt.grad.numpy(), np.moveaxis(np.asarray(gj), -1, 1),
                               atol=1e-5, rtol=1e-5)
    # the same size is the input itself
    assert TR.resize(xt, shape[2:], mode) is xt



# -- C8: the bf16 rung's dtype promotion, as the reference's ----------------
#
# The reference's resize multiplies by f32 interpolation matrices, so a bf16
# input comes out f32 (its gradient back in bf16), and flax's Conv and Dense
# promote their operands to the wider dtype (an f32 input with bf16 weights
# computes in f32); its transposed conv climbs to f32 for the whole layer
# and rounds back to the incoming width. Each case: the port's output dtype
# is the reference's, and its values within one bf16 ulp of the output's
# scale (2**-8; measured bitwise, or 2.4e-7 where f32 sums run in another
# order, on the CPU).

C8_LAYERS = {
    "upsample_conv_bf16": (lambda: FL.UpsampleConvLayer(4, 3, padding=1),
                           lambda: TL.UpsampleConvLayer(3, 4, 3, padding=1), "bf16"),
    "upsample_conv_x4_bf16": (lambda: FL.UpsampleConvLayer(4, 3, padding=1, scale=4),
                              lambda: TL.UpsampleConvLayer(3, 4, 3, padding=1, scale=4),
                              "bf16"),
    "conv_f32_input_bf16_weights": (lambda: FL.ConvLayer(4, 3, padding=1),
                                    lambda: TL.ConvLayer(3, 4, 3, padding=1), "f32"),
    "mlp_f32_input_bf16_weights": (lambda: FL.MLP(hidden_dim=4, output_dim=6, num_layers=2),
                                   lambda: TL.MLP(3, 4, 6, num_layers=2), "f32"),
    "transposed_conv_k3_bf16": (lambda: FL.TransposedConvLayer(4, 3, padding=1),
                                lambda: TL.TransposedConvLayer(3, 4, 3, padding=1), "bf16"),
    "transposed_conv_k5_bf16": (lambda: FL.TransposedConvLayer(4, 5, padding=2),
                                lambda: TL.TransposedConvLayer(3, 4, 5, padding=2), "bf16"),
    "transposed_conv_k5_f32_input": (lambda: FL.TransposedConvLayer(4, 5, padding=2),
                                     lambda: TL.TransposedConvLayer(3, 4, 5, padding=2),
                                     "f32"),
}
# the output dtype each case must have (the reference's, checked too)
C8_DTYPES = {"upsample_conv_bf16": torch.float32, "upsample_conv_x4_bf16": torch.float32,
             "conv_f32_input_bf16_weights": torch.float32,
             "mlp_f32_input_bf16_weights": torch.float32,
             "transposed_conv_k3_bf16": torch.bfloat16, "transposed_conv_k5_bf16": torch.bfloat16,
             "transposed_conv_k5_f32_input": torch.float32}


def _assert_c8(got, ref, want_dtype):
    assert str(ref.dtype) == str(want_dtype).replace("torch.", "")
    assert got.dtype == want_dtype
    ref32 = np.asarray(ref.astype(jnp.float32))
    got32 = got.detach().float().numpy()
    if got32.ndim == 4:
        got32 = np.moveaxis(got32, 1, -1)
    scale = max(float(np.abs(ref32).max()), 1.0)
    assert np.abs(got32 - ref32).max() <= BF16_SEAM_TOL * scale


@pytest.mark.parametrize("name", sorted(C8_LAYERS))
def test_bf16_layer_promotion_matches_reference(name):
    """A layer with bf16 weights: its output dtype is the reference's (f32
    after an upsampling or from an f32 input, bf16 from a transposed conv
    given bf16), its values within one bf16 ulp of the output's scale."""
    fctor, tctor, xin = C8_LAYERS[name]
    fmod, tmod = fctor(), tctor()
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    if name.startswith("mlp"):
        x = x[:, 0, 0, :]
    params = jax.tree.map(np.asarray, fmod.init(jax.random.PRNGKey(3), x))
    convert.load_flax_params(tmod, params)
    pb = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    ref = fmod.apply(pb, jnp.asarray(x) if xin == "f32" else jnp.asarray(x).astype(jnp.bfloat16))
    xt = torch.from_numpy(x) if x.ndim == 2 else _nchw(x)
    with torch.no_grad():
        got = tmod.to(torch.bfloat16)(xt if xin == "f32" else xt.to(torch.bfloat16))
    _assert_c8(got, ref, C8_DTYPES[name])


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_bf16_resize_promotes_and_its_gradient_is_bf16(mode):
    """``resize`` of a bf16 input gives f32, the reference's values within
    one bf16 ulp (measured bitwise / 2.4e-7); the gradient comes back bf16,
    the reference's within one bf16 ulp of its scale; ``interpolate`` (the
    channel-last form) promotes the same way."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    g = rng.standard_normal((2, 10, 14, 3)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    ref = FR.interpolate(xj, (10, 14), mode)
    ref_grad = jax.grad(lambda a: jnp.sum(FR.interpolate(a, (10, 14), mode)
                                          * jnp.asarray(g)))(xj)
    xt = _nchw(x).to(torch.bfloat16).requires_grad_(True)
    got = TR.resize(xt, (10, 14), mode)
    _assert_c8(got, ref, torch.float32)
    (got * _nchw(g)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and str(ref_grad.dtype) == "bfloat16"
    _assert_c8(xt.grad, ref_grad, torch.bfloat16)
    _assert_c8(TR.interpolate(torch.from_numpy(x).to(torch.bfloat16), (10, 14), mode).permute(
        0, 3, 1, 2), ref, torch.float32)


# -- the norms (BN / IN) ------------------------------------------------------
#
# Each layer that takes ``norm``, with BatchNorm and with InstanceNorm, from
# the flax init with its running statistics, BN's scale and bias drawn away
# from their defaults. Training (the moments over the batch, the running
# statistics updated, the gradients of the output's square sum to every
# parameter and to the input) and evaluation (the running statistics), at
# f32 within 1e-5 of each tensor's scale, the gradients within 1e-5 of the
# largest gradient's (an IN conv's bias has a zero gradient in exact
# arithmetic: f32 noise; measured 1.9e-6 at most); at bf16 (the rung casts
# every leaf, the statistics too) the output's dtype and its values within
# one bf16 ulp of its scale.

NORM_LAYERS = {
    "conv": (lambda n: FL.ConvLayer(5, 3, stride=2, padding=1, norm=n),
             lambda n: TL.ConvLayer(3, 5, 3, stride=2, padding=1, norm=n),
             [(2, 9, 11, 3)], "image"),
    "conv1d": (lambda n: FL.ConvLayer1D(4, 3, padding=1, norm=n),
               lambda n: TL.ConvLayer1D(3, 4, 3, padding=1, norm=n), [(2, 9, 3)], "image"),
    "transposed_conv": (lambda n: FL.TransposedConvLayer(4, 3, padding=1, norm=n),
                        lambda n: TL.TransposedConvLayer(3, 4, 3, padding=1, norm=n),
                        [(2, 5, 6, 3)], "image"),
    "upsample_conv": (lambda n: FL.UpsampleConvLayer(4, 3, padding=1, norm=n),
                      lambda n: TL.UpsampleConvLayer(3, 4, 3, padding=1, norm=n),
                      [(2, 5, 6, 3)], "image"),
    "residual_block": (lambda n: FL.ResidualBlock(6, norm=n),
                       lambda n: TL.ResidualBlock(6, norm=n), [(2, 7, 9, 6)], "image"),
    "recurrent_convlstm": (
        lambda n: FL.RecurrentConvLayer(4, 5, stride=2, padding=2,
                                        recurrent_block_type="convlstm", norm=n),
        lambda n: TL.RecurrentConvLayer(3, 4, 5, stride=2, padding=2, norm=n,
                                        recurrent_block_type="convlstm"),
        [(2, 9, 11, 3), (2, 5, 6, 4), (2, 5, 6, 4)], "lstm"),
}


# at bf16 a norm divides by the batch's spread, so an intermediate's one-ulp
# rounding flip (the moments summed in another order) can grow by a few
# ulps through the next conv: measured up to 2.3 bf16 ulps of the output's
# scale (residual block, train); 4 ulps allowed
NORM_BF16_TOL = 4 * BF16_SEAM_TOL


def _norm_variables(fmod, xs, kind, seed):
    """The flax variables of ``fmod`` with its running statistics (and
    BN's affine parameters) drawn away from their initial values."""
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.asarray, fmod.init(jax.random.PRNGKey(seed), *_cell_args(kind, xs)))

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if "Torch" not in key:
            return leaf
        if key.endswith("['var']") or key.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0.0, 0.3, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, v)


def _channels_last(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _scaled_close(got, want, tol, scale=None):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1.0) if scale is None else scale
    assert got.shape == want.shape
    assert float(np.abs(np.asarray(got, np.float64) - want).max()) <= tol * scale


@pytest.fixture(scope="module")
def norm_layers():
    """Each norm case's flax module, seeded inputs and variables."""
    out = {}
    for name, (fctor, _, shapes, kind) in NORM_LAYERS.items():
        for norm in ("BN", "IN"):
            fmod = fctor(norm)
            rng = np.random.default_rng(sum(map(ord, name + norm)))
            xs = [rng.standard_normal(s).astype(np.float32) * 2.0 + 0.5 for s in shapes]
            out[name, norm] = (fmod, xs, _norm_variables(fmod, xs, kind, 5))
    return out


@pytest.mark.parametrize("norm", ["BN", "IN"])
@pytest.mark.parametrize("name", sorted(NORM_LAYERS))
def test_norm_layer_trains_and_evaluates_as_flax(norm_layers, name, norm):
    _, tctor, _, kind = NORM_LAYERS[name]
    fmod, xs, v = norm_layers[name, norm]
    tmod = tctor(norm)
    assert convert.load_flax_params(tmod, v) == len(convert.flatten_tree(v))
    if norm == "BN":
        # a conv whose output BN takes has no bias, in both packages
        flat = convert.flatten_tree(v["params"])
        parents = {k[:-2] for k in flat if k[-2].startswith("TorchBatchNorm")}
        assert parents and not any(k[-1] == "bias" and k[:-2] + ("_NormWrapper_0",) in parents
                                   for k in flat)

    def jloss(p, x0):
        out, mut = fmod.apply({**v, "params": p}, *_cell_args(kind, [x0] + xs[1:]), True,
                              mutable=["batch_stats"])
        return sum(jnp.sum(jnp.square(o)) for o in jax.tree.leaves(out)), (out, mut)

    (_, (jout, jmut)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        v["params"], xs[0])
    tx = [_nchw(x) for x in xs]
    tx[0].requires_grad_(True)
    tmod.train()
    tout = tmod(*_cell_args(kind, tx))
    sum((o ** 2).sum() for o in torch.utils._pytree.tree_leaves(tout)).backward()
    for g, r in zip(torch.utils._pytree.tree_leaves(tout), jax.tree.leaves(jout)):
        _scaled_close(_channels_last(g), r, 1e-5)
    stats = convert.flatten_tree(convert.export_flax_params(tmod)["batch_stats"])
    want_stats = convert.flatten_tree(jax.tree.map(np.asarray, jmut["batch_stats"]))
    assert sorted(stats) == sorted(want_stats) and stats
    for k in want_stats:
        _scaled_close(stats[k], want_stats[k], 1e-5)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in tmod.named_parameters()}
    graded = copy.deepcopy(tmod)
    for k, p in graded.named_parameters():
        p.data = grads[k]
    tg = convert.flatten_tree(convert.export_flax_params(graded)["params"])
    jg = convert.flatten_tree(jax.tree.map(np.asarray, jgp))
    assert sorted(tg) == sorted(jg)
    gscale = max(float(np.abs(a).max()) for a in jg.values())
    for k in jg:
        _scaled_close(tg[k], jg[k], 1e-5, gscale)
    _scaled_close(_channels_last(tx[0].grad), jgx, 1e-5, float(np.abs(jgx).max()))

    # evaluation: the running statistics the flax variables carry
    tmod2 = tctor(norm)
    convert.load_flax_params(tmod2, v)
    jeval = fmod.apply(v, *_cell_args(kind, xs), False)
    with torch.no_grad():
        teval = tmod2.eval()(*_cell_args(kind, [_nchw(x) for x in xs]))
    for g, r in zip(torch.utils._pytree.tree_leaves(teval), jax.tree.leaves(jeval)):
        _scaled_close(_channels_last(g), r, 1e-5)

    # the bf16 rung: every leaf cast, both modes
    vb = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), v)
    xb = [jnp.asarray(x).astype(jnp.bfloat16) for x in xs]
    for train in (True, False):
        ref = fmod.apply(vb, *_cell_args(kind, xb), train, mutable=["batch_stats"])[0]
        tb = copy.deepcopy(tmod2).to(torch.bfloat16).train(train)
        with torch.no_grad():
            got = tb(*_cell_args(kind, [_nchw(x).to(torch.bfloat16) for x in xs]))
        for g, r in zip(torch.utils._pytree.tree_leaves(got), jax.tree.leaves(ref)):
            assert str(g.dtype).replace("torch.", "") == str(r.dtype)
            _scaled_close(_channels_last(g), np.asarray(r.astype(jnp.float32)), NORM_BF16_TOL)


def test_unknown_norm_is_refused_as_the_reference():
    with pytest.raises(NotImplementedError, match="norm='GN'"):
        TL.ConvLayer(3, 4, norm="GN")


# A BN layer in a 2-process gloo group, each process its half of a batch of
# 4 (``parallel.mesh``): every process's output rows, input-gradient rows and
# running statistics, and the group's summed parameter gradients, against one
# process at the whole batch and against the reference over a 2-device mesh
# (GSPMD takes the global batch's moments). Within 1e-5 of each tensor's
# scale; the two processes' running statistics are the same bits.

_BN_PROCESS = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from esr_tpu_torch.inference.checkpoint import read_params
from esr_tpu_torch.models import convert, layers
rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank,
                        world_size=world)
x = np.load(f"{root}/x.npy")
b = x.shape[0] // world
layer = layers.ConvLayer(3, 5, 3, stride=2, padding=1, norm="BN").train()
convert.load_flax_params(layer, read_params(root))
xr = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x[rank * b:(rank + 1) * b], -1, 1)))
xr.requires_grad_(True)
out = layer(xr)
(out ** 2).sum().backward()
for p in layer.parameters():
    dist.all_reduce(p.grad)
    p.data = p.grad
tree = convert.export_flax_params(layer)
flat = {"/".join(k): v for k, v in convert.flatten_tree(tree).items()}
np.savez(f"{root}/out{rank}.npz", y=out.detach().numpy(), gx=xr.grad.numpy(), **flat)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def _one_torch_thread():
    """This process's torch work in one intra-op thread while its two
    processes (one thread each) share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bn_two_processes(norm_layers, tmp_path_factory, _one_torch_thread):
    """The conv BN case's variables, a batch of 4, and what each of the two
    processes wrote."""
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path

    from esr_tpu_torch.inference.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("bn_two_processes")
    fmod, _, v = norm_layers["conv", "BN"]
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 9, 11, 3)) * 2.0 + 0.5).astype(np.float32)
    save_checkpoint(str(root), v, {})
    np.save(root / "x.npy", x)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(Path(__file__).resolve().parent.parent)}
    procs = [subprocess.Popen([sys.executable, "-c", _BN_PROCESS, str(r), "2", str(root)],
                              env=env, start_new_session=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:  # a peer left in a collective goes with its group
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0, 0], logs
    return fmod, v, x, [dict(np.load(root / f"out{r}.npz")) for r in range(2)]


def test_two_process_batchnorm_takes_the_global_batch_moments(bn_two_processes):
    from esr_tpu.parallel.mesh import make_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    fmod, v, x, got = bn_two_processes

    # one process at the whole batch
    one = TL.ConvLayer(3, 5, 3, stride=2, padding=1, norm="BN").train()
    convert.load_flax_params(one, v)
    xt = _nchw(x).requires_grad_(True)
    y = one(xt)
    (y ** 2).sum().backward()
    stats = {"/".join(k): a for k, a in convert.flatten_tree(
        {"batch_stats": convert.export_flax_params(one)["batch_stats"]}).items()}
    for p in one.parameters():
        p.data = p.grad
    grads = {"/".join(k): a for k, a in convert.flatten_tree(
        {"params": convert.export_flax_params(one)["params"]}).items()}

    # the reference over a 2-device mesh
    mesh = make_mesh(jax.devices()[:2])

    def jloss(p, xx):
        out, mut = fmod.apply({**v, "params": p}, xx, True, mutable=["batch_stats"])
        return jnp.sum(jnp.square(out)), (out, mut)

    xs = jax.device_put(x, NamedSharding(mesh, P("data")))
    (_, (jy, jmut)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(v["params"], xs)
    jflat = {"/".join(k): np.asarray(a) for k, a in convert.flatten_tree(
        {"params": jax.tree.map(np.asarray, jgp),
         "batch_stats": jax.tree.map(np.asarray, jmut["batch_stats"])}).items()}

    for r, g in enumerate(got):
        rows = slice(2 * r, 2 * r + 2)
        for want in (y.detach().numpy()[rows], np.moveaxis(np.asarray(jy), -1, 1)[rows]):
            _scaled_close(g["y"], want, 1e-5)
        for want in (xt.grad.numpy()[rows], np.moveaxis(np.asarray(jgx), -1, 1)[rows]):
            _scaled_close(g["gx"], want, 1e-5)
        for k, want in {**stats, **grads}.items():
            _scaled_close(g[k], want, 1e-5)
            _scaled_close(g[k], jflat[k], 1e-5)
    for k in stats:
        np.testing.assert_array_equal(got[0][k], got[1][k])


# -- the event-op library: sampling, gradients, IWEs, the flow and
# reconstruction losses, the rest of the encodings and PSROI pooling ------
#
# Each op takes the same seeded numpy inputs on both sides; the scalar whose
# gradient is compared is sum(output * a seeded weight). Float outputs and
# gradients: atol 1e-5 + rtol 1e-5 (measured 0 to 2e-7: the same f32 ops,
# scatter-adds summed in another order); integer, index, mask and event-list
# outputs bitwise. Images are NCHW in the port, NHWC in the reference.

from esr_tpu.losses import flow as JFL
from esr_tpu.losses import reconstruction as JREC
from esr_tpu.ops import encodings as JENC
from esr_tpu.ops import gradients as JGR
from esr_tpu.ops import iwe as JIWE
from esr_tpu.ops import psroi as JPS
from esr_tpu.ops import sampling as JSA
from esr_tpu_torch import losses as T_losses
from esr_tpu_torch import ops as T_ops
from esr_tpu_torch.losses import flow as TFL
from esr_tpu_torch.losses import reconstruction as TREC
from esr_tpu_torch.ops import encodings as TENC
from esr_tpu_torch.ops import gradients as TGR
from esr_tpu_torch.ops import iwe as TIWE
from esr_tpu_torch.ops import psroi as TPS
from esr_tpu_torch.ops import sampling as TSA

EV_TOL = dict(atol=1e-5, rtol=1e-5)
EV_B, EV_H, EV_W, EV_N = 2, 11, 14, 60


def _grads_match(jfn, tfn, arrays, nchw_args=(), tol=EV_TOL):
    """``jfn`` / ``tfn`` over the same arrays (NHWC for the reference, NCHW
    for the port at ``nchw_args``): outputs and the gradient of
    sum(output * w) with respect to every float argument."""
    t_in = [(_nchw(a) if i in nchw_args else torch.from_numpy(np.array(a))).requires_grad_(True)
            for i, a in enumerate(arrays)]
    t_out = tfn(*t_in)
    j_out = jfn(*[jnp.asarray(a) for a in arrays])
    j_np = np.asarray(j_out)
    t_np = t_out.detach().numpy()
    if j_np.ndim == 4 and t_np.shape != j_np.shape:
        j_np = np.moveaxis(j_np, -1, 1)
    np.testing.assert_allclose(t_np, j_np, **tol)
    w = np.random.default_rng(7).standard_normal(t_np.shape).astype(np.float32)
    (t_out * torch.from_numpy(w)).sum().backward()
    wj = np.moveaxis(w, 1, -1) if np.asarray(j_out).shape != t_np.shape else w
    j_grads = jax.grad(lambda *a: jnp.sum(jfn(*a) * wj), argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    for i, (tg, jg) in enumerate(zip(t_in, j_grads)):
        jg = np.asarray(jg)
        # no path from an argument to the output (a rounded index): zero
        got = np.zeros(tg.shape, np.float32) if tg.grad is None else tg.grad.numpy()
        np.testing.assert_allclose(got, np.moveaxis(jg, -1, 1) if i in nchw_args else jg, **tol)


def _event_inputs(seed=0, b=EV_B, n=EV_N, h=EV_H, w=EV_W):
    rng = np.random.default_rng(seed)
    ev = np.stack([np.sort(rng.random((b, n)), 1), rng.uniform(0, h, (b, n)),
                   rng.uniform(0, w, (b, n)), rng.choice([-1.0, 1.0], (b, n))], -1)
    flow = rng.standard_normal((b, h, w, 2)) * 0.03
    pol = np.stack([ev[..., 3] > 0, ev[..., 3] < 0], -1)
    valid = rng.random((b, n)) > 0.2
    return (ev.astype(np.float32), flow.astype(np.float32), pol.astype(np.float32), valid)


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_and_sobel_match_reference(align_corners):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 6, 2)).astype(np.float32)
    _grads_match(lambda i, g: JSA.grid_sample(i, g, align_corners),
                 lambda i, g: TSA.grid_sample(i, g, align_corners), [img, grid], nchw_args=(0,))
    _grads_match(lambda i: JGR.sobel(i)[int(align_corners)],
                 lambda i: TGR.sobel(i)[int(align_corners)], [img], nchw_args=(0,))


@pytest.mark.parametrize("round_idx", [True, False])
def test_iwe_ops_match_reference(round_idx):
    ev, flow, pol, valid = _event_inputs()
    res = (EV_H, EV_W)
    vj, vt = jnp.asarray(valid), torch.from_numpy(valid)
    _grads_match(
        lambda f, e, pm, nm: JIWE.compute_pol_iwe(f, e, res, pm, nm, 9, round_idx, vj),
        lambda f, e, pm, nm: TIWE.compute_pol_iwe(f, e, res, pm, nm, 9, round_idx, vt),
        [flow, ev, pol[..., 0:1], pol[..., 1:2]], nchw_args=(0,))
    idx_j, w_j = JIWE.get_interpolation(jnp.asarray(ev), jnp.asarray(ev[..., 1:3] * 0.01), 0.5,
                                        res, 9, round_idx)
    idx_t, w_t = TIWE.get_interpolation(torch.from_numpy(ev),
                                        torch.from_numpy(ev[..., 1:3] * 0.01), 0.5, res, 9,
                                        round_idx)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), **EV_TOL)


def test_event_warping_loss_and_averaged_iwe_match_reference():
    ev, flow, pol, valid = _event_inputs(2)
    # two events warp from one source pixel to one destination: the
    # averaged IWE's distinct-source count must see them once
    ev[:, 1] = ev[:, 0] * [1.0, 1.0, 1.0, 0.0] + [0.0, 0.0, 0.0, ev[0, 0, 3]]
    res = (EV_H, EV_W)
    vj, vt = jnp.asarray(valid), torch.from_numpy(valid)
    _grads_match(lambda f, e, p: JFL.event_warping_loss([f, f * 0.5], e, p, res, vj, 0.3),
                 lambda f, e, p: TFL.event_warping_loss([f, f * 0.5], e, p, res, vt, 0.3),
                 [flow, ev, pol], nchw_args=(0,))
    _grads_match(lambda f, e, p: JFL.averaged_iwe(f, e, p, res, vj),
                 lambda f, e, p: T_losses.averaged_iwe(f, e, p, res, vt),
                 [flow, ev, pol], nchw_args=(0,))


def test_brightness_constancy_matches_reference():
    ev, flow, pol, valid = _event_inputs(3)
    res = (EV_H, EV_W)
    rng = np.random.default_rng(4)
    img = rng.random((EV_B, EV_H, EV_W, 1)).astype(np.float32)
    prev = rng.random((EV_B, EV_H, EV_W, 1)).astype(np.float32)
    cnt = rng.integers(0, 2, (EV_B, EV_H, EV_W, 2)).astype(np.float32)
    jb, tb = JREC.BrightnessConstancy(res, (0.5, 2.0)), T_losses.BrightnessConstancy(res, (0.5, 2.0))
    assert isinstance(tb, TREC.BrightnessConstancy)
    vj, vt = jnp.asarray(valid), torch.from_numpy(valid)
    _grads_match(lambda f, i: jb.generative_model(f, i, jnp.asarray(cnt), jnp.asarray(ev),
                                                  jnp.asarray(pol), vj),
                 lambda f, i: tb.generative_model(f, i, _nchw(cnt), torch.from_numpy(ev),
                                                  torch.from_numpy(pol), vt),
                 [flow, img], nchw_args=(0, 1))
    _grads_match(lambda f, p, i: jb.temporal_consistency(f, p, i),
                 lambda f, p, i: tb.temporal_consistency(f, p, i),
                 [flow, prev, img], nchw_args=(0, 1, 2))
    _grads_match(jb.regularization, tb.regularization, [img], nchw_args=(0,))


def _cloud(seed=5, n=400, h=EV_H, w=EV_W, n_valid=370):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1, w + 1, n).astype(np.float32)
    ys = rng.uniform(-1, h + 1, n).astype(np.float32)
    ts = np.sort(rng.random(n)).astype(np.float32)
    ts[40:44] = ts[40]  # a run of equal timestamps
    ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return xs, ys, ts, ps, np.arange(n) < n_valid


def test_encodings_match_reference_bitwise_where_integer():
    xs, ys, ts, ps, valid = _cloud()
    res = (EV_H, EV_W)
    J = [jnp.asarray(a) for a in (xs, ys, ts, ps)]
    T = [torch.from_numpy(a) for a in (xs, ys, ts, ps)]
    vj, vt = jnp.asarray(valid), torch.from_numpy(valid)
    for pol in (False, True):
        for binning in ("half_open", "inclusive"):
            np.testing.assert_array_equal(
                TENC.events_to_stack(*T, 5, res, vt, pol, binning).numpy(),
                np.asarray(JENC.events_to_stack(*J, 5, res, vj, pol, binning)))
    for few in (3, 4):  # the inclusive guard zeroes a window of <= 3 events
        np.testing.assert_array_equal(
            TENC.events_to_stack(*T, 2, res, torch.arange(400) < few, False, "inclusive").numpy(),
            np.asarray(JENC.events_to_stack(*J, 2, res, jnp.arange(400) < few, False, "inclusive")))
    np.testing.assert_array_equal(TENC.events_to_mask(T[0], T[1], T[3], res, vt).numpy(),
                                  np.asarray(JENC.events_to_mask(J[0], J[1], J[3], res, vj)))
    np.testing.assert_array_equal(TENC.events_polarity_mask(T[3]).numpy(),
                                  np.asarray(JENC.events_polarity_mask(J[3])))
    cnt_t, act_t = TENC.events_to_channels_activity(T[0], T[1], T[3], res, vt, tile=4)
    cnt_j, act_j = JENC.events_to_channels_activity(J[0], J[1], J[3], res, vj, tile=4)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(act_t.numpy(), np.asarray(act_j))
    assert float(TENC.activity_fraction(act_t)) == float(JENC.activity_fraction(act_j))
    stack = np.random.default_rng(6).normal(0, 2, (2, EV_H, EV_W, 3)).astype(np.float32)
    np.testing.assert_array_equal(TENC.stack2cnt(torch.from_numpy(stack)).numpy(),
                                  np.asarray(JENC.stack2cnt(jnp.asarray(stack))))
    for a, b in zip(TENC.normalize_events(T[0], T[1], res), JENC.normalize_events(J[0], J[1], res)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_encodings_float_weights_match_reference():
    xs, ys, ts, ps, valid = _cloud(8)
    res = (EV_H, EV_W)
    J = [jnp.asarray(a) for a in (xs, ys, ts, ps)]
    T = [torch.from_numpy(a) for a in (xs, ys, ts, ps)]
    vj, vt = jnp.asarray(valid), torch.from_numpy(valid)
    for round_ts in (False, True):
        np.testing.assert_allclose(TENC.events_to_voxel(*T, 4, res, vt, round_ts).numpy(),
                                   np.asarray(JENC.events_to_voxel(*J, 4, res, vj, round_ts)),
                                   **EV_TOL)
    np.testing.assert_allclose(
        TENC.events_to_image(T[0], T[1], T[3], res, vt, "bilinear").numpy(),
        np.asarray(JENC.events_to_image(J[0], J[1], J[3], res, vj, "bilinear")), **EV_TOL)
    rng = np.random.default_rng(9)
    cloud = np.stack([rng.random((2, 300)), rng.random((2, 300)), rng.random((2, 300)),
                      rng.choice([-1.0, 1.0, 0.0], (2, 300))], -1).astype(np.float32)
    cv = rng.random((2, 300)) > 0.1
    restored_t = TENC.event_restore(torch.from_numpy(cloud), res)
    restored_j = JENC.event_restore(jnp.asarray(cloud), res)
    np.testing.assert_array_equal(restored_t.numpy(), np.asarray(restored_j))
    got = TENC.event_conversion(restored_t, 3, res, 4, torch.from_numpy(cv))
    want = JENC.event_conversion(restored_j, 3, res, 4, jnp.asarray(cv))
    np.testing.assert_array_equal(got["e_cnt"].numpy(), np.asarray(want["e_cnt"]))
    np.testing.assert_array_equal(got["e_stack"].numpy(), np.asarray(want["e_stack"]))
    np.testing.assert_allclose(got["e_voxel"].numpy(), np.asarray(want["e_voxel"]), **EV_TOL)


@pytest.mark.parametrize("max_px", [3, 6, 7, 40])
def test_hot_event_mask_ties_at_the_cutoff_take_the_lower_index(max_px):
    # integer rates tie all the time: 5 pixels at rate 3 straddle the cutoff
    # rank for max_px 3 and 6 (the top-k keeps the lower indices)
    rate = np.zeros((5, 6), np.float32)
    rate.flat[[4, 9, 11, 20, 27]] = 3.0
    rate.flat[[2, 17]] = 5.0
    rate.flat[[0, 1, 3]] = 0.5
    for idx in (7, 5, jnp.asarray(9)):
        want = np.asarray(JENC.get_hot_event_mask(jnp.asarray(rate), idx, max_px, 5, 0.8))
        t_idx = torch.tensor(int(idx)) if isinstance(idx, jax.Array) else idx
        got = TENC.get_hot_event_mask(torch.from_numpy(rate), t_idx, max_px, 5, 0.8)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).sum() == min(max_px, 7)


@pytest.mark.parametrize("capacity", [37, 900])
def test_inverse_rasterizers_are_the_reference_event_lists_bitwise(capacity):
    """Past ``capacity`` (37) the lists keep the reference's scan-order
    prefix; at 900 every event fits."""
    rng = np.random.default_rng(10)
    cnt = rng.integers(0, 4, (2, 6, 7, 2)).astype(np.float32)
    cnt[0, 2, 3, 0] = -0.9  # a negative prediction counts as 0
    stack = rng.integers(-3, 4, (2, 6, 7, 3)).astype(np.float32) + 0.4
    pstack = rng.integers(0, 3, (2, 6, 7, 3, 2)).astype(np.float32)
    for name, grid in (("cnt2event", cnt), ("event_redistribute", stack),
                       ("event_redistribute_polarity", pstack)):
        for fn_t, fn_j, g in ((getattr(TENC, name), getattr(JENC, name), grid[0]),
                              (getattr(TENC, f"{name}_batch"), getattr(JENC, f"{name}_batch"),
                               grid)):
            ev_t, v_t = fn_t(torch.from_numpy(g), capacity)
            ev_j, v_j = fn_j(jnp.asarray(g), capacity)
            np.testing.assert_array_equal(ev_t.numpy(), np.asarray(ev_j), err_msg=name)
            np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j), err_msg=name)
            if capacity == 37:
                assert bool(v_t.all())  # truncated: every slot holds an event


def test_psroi_matches_reference_at_half_coordinates():
    rng = np.random.default_rng(11)
    od, g, p = 2, 3, 3
    data = rng.standard_normal((2, 7, 9, od * g * g)).astype(np.float32)
    # .5 coordinates: C round() goes away from zero where torch.round goes to even
    rois = np.array([[0, 0.5, 1.5, 4.5, 5.5], [1, 2.5, -0.5, 8.5, 6.5],
                     [0, -1.5, 2.5, 3.5, 3.5], [1, 3, 1, 3, 1]], np.float32)
    trans = rng.standard_normal((4, 2, 2, 3, 3)).astype(np.float32)
    kw = dict(spatial_scale=0.9, output_dim=od, group_size=g, pooled_size=p,
              sample_per_part=2, trans_std=0.1)
    _grads_match(lambda d, t: JPS.deform_psroi_pooling(d, jnp.asarray(rois), t, **kw)[0],
                 lambda d, t: T_ops.deform_psroi_pooling(d, torch.from_numpy(rois), t, **kw)[0],
                 [data, trans], nchw_args=(0,))
    cnt_t = TPS.deform_psroi_pooling(_nchw(data), torch.from_numpy(rois), None, **kw)[1]
    cnt_j = JPS.deform_psroi_pooling(jnp.asarray(data), jnp.asarray(rois), None, **kw)[1]
    np.testing.assert_array_equal(cnt_t.numpy(), np.moveaxis(np.asarray(cnt_j), -1, 1))
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5])
    assert TPS._round_half_away(x).tolist() == [1.0, 2.0, 3.0, -1.0, -3.0]
    assert torch.round(x).tolist() != TPS._round_half_away(x).tolist()


# -- context parallelism (parallel.context) ----------------------------------
#
# Four gloo processes, one torch thread each: ring and Ulysses attention over
# the four (p 4) and over two pairs (p 2), causal and not, each process its
# sequence block of q, k, v [2, 32, 8, 16], with the gradients of
# sum(out ** 2) (the sum over the processes' blocks); against the
# reference's full_attention and its jax.grad, the bounds of
# tests/test_context_parallel.py (outputs 2e-5, gradients 5e-4). Ulysses
# over 4 processes with 6 heads raises.

_CP_PROCESS = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from esr_tpu_torch.parallel import context
rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank,
                        world_size=world)
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
q, k, v = (torch.from_numpy(a) for a in np.load(f"{root}/qkv.npy"))
out = {}
for p, group, index in ((4, None, rank), (2, pairs[rank // 2], rank % 2)):
    n = q.shape[1] // p
    for fn in ("ring", "ulysses"):
        for causal in (0, 1):
            leaves = [t[:, index * n:(index + 1) * n].clone().requires_grad_(True)
                      for t in (q, k, v)]
            o = getattr(context, fn + "_attention")(*leaves, group=group, causal=bool(causal))
            (o ** 2).sum().backward()
            key = f"{fn}_{p}_{causal}"
            out[key + "_out"] = o.detach().numpy()
            for name, t in zip("qkv", leaves):
                out[f"{key}_g{name}"] = t.grad.numpy()
try:
    context.ulysses_attention(*(torch.zeros(1, 4, 6, 2) for _ in range(3)))
    refused = ""
except ValueError as e:
    refused = str(e)
np.savez(f"{root}/cp{rank}.npz", refused=np.array(refused), **out)
dist.destroy_process_group()
"""

CP_CASES = [(fn, p, causal) for fn in ("ring", "ulysses") for p in (4, 2)
            for causal in (False, True)]


@pytest.fixture(scope="module")
def cp_processes(tmp_path_factory, _one_torch_thread):
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path

    root = tmp_path_factory.mktemp("cp_processes")
    rng = np.random.default_rng(0)
    qkv = rng.standard_normal((3, 2, 32, 8, 16)).astype(np.float32)
    np.save(root / "qkv.npy", qkv)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(Path(__file__).resolve().parent.parent)}
    procs = [subprocess.Popen([sys.executable, "-c", _CP_PROCESS, str(r), "4", str(root)],
                              env=env, start_new_session=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(4)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:  # a peer left in a collective goes with its group
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0] * 4, logs
    return qkv, [dict(np.load(root / f"cp{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("fn,p,causal", CP_CASES)
def test_sequence_parallel_attention_matches_full_attention(cp_processes, fn, p, causal):
    from esr_tpu.parallel.context import full_attention

    qkv, got = cp_processes
    q, k, v = (jnp.asarray(a) for a in qkv)
    want = np.asarray(full_attention(q, k, v, causal=causal))
    grads = jax.grad(lambda *t: (full_attention(*t, causal=causal) ** 2).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    n = qkv.shape[2] // p
    key = f"{fn}_{p}_{int(causal)}"
    for rank, g in enumerate(got):
        rows = slice((rank % p) * n, (rank % p + 1) * n)
        np.testing.assert_allclose(g[key + "_out"], want[:, rows], atol=2e-5)
        for name, jg in zip("qkv", grads):
            np.testing.assert_allclose(g[f"{key}_g{name}"], np.asarray(jg)[:, rows],
                                       atol=5e-4, err_msg=name)


def test_ulysses_refuses_heads_that_do_not_split(cp_processes):
    _, got = cp_processes
    for g in got:
        assert "num_heads 6 must divide by the group's size 4" in str(g["refused"])
