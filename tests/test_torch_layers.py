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

from esr_tpu.models import layers as FL
from esr_tpu.models import model_util as FU
from esr_tpu.ops import resize as FR
from esr_tpu.data import np_encodings as FNE
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
