"""The port's DeepRecurrNet against flax ``model.apply`` at f32 on the CPU,
with the same weights brought across by the weight bridge.

The weights are seeded numpy draws laid out on the reference's own
parameter tree (``jax.eval_shape`` of its init), so the offset/mask conv
is non-zero: the reference zero-initializes it, which would leave every
offset 0 and every mask 0.5 and the fractional gather untested. The map
(20, 28) is not a multiple of 8, so padding and cropping are exercised.
The reference runs its DCN both through the jnp formulation and through
the Pallas forward kernel in interpret mode. Tolerance: atol 1e-5 + rtol
1e-4 on outputs and states; the measured envelope is ~5e-8. Then the UNet
family (the four UNets and both windowed adapters, built by name through
both registries) the same way, and the second shipped recipe's full-width
parameter tree through the bridge.
"""

import jax
import numpy as np
import pytest
import torch

from esr_tpu.inference.harness import _num_params
from esr_tpu.models.esr import DeepRecurrNet as FlaxNet
from esr_tpu.models.esr import STFusion as FlaxSTFusion
from esr_tpu.models.registry import MODEL_REGISTRY as J_REGISTRY
from esr_tpu_torch.device import resolve_device
from esr_tpu_torch.models import adapters as TA
from esr_tpu_torch.models import convert
from esr_tpu_torch.models import registry as TR
from esr_tpu_torch.models.esr import DeepRecurrNet

H, W = 20, 28
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def nets():
    resolve_device("cpu")
    rng = np.random.default_rng(0)
    ref = FlaxNet(inch=2, basech=2, num_frame=3)
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            np.zeros((1, 3, H, W, 2), np.float32),
                            ref.init_states(1, H, W))

    def draw(leaf):
        # U(+-1/sqrt(fan_in)) like the reference's init; biases U(+-0.3)
        bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 0.3
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    params = jax.tree.map(draw, shapes)
    port = DeepRecurrNet(inch=2, basech=2, num_frame=3).eval()
    n_leaves = convert.load_flax_params(port, params)
    windows = [rng.poisson(0.5, (2, 3, H, W, 2)).astype(np.float32) for _ in range(3)]
    feats = [rng.standard_normal((2, 3, 4, 16)).astype(np.float32) for _ in range(2)]
    return {
        "flax": {"jnp": ref, "pallas": FlaxNet(inch=2, basech=2, num_frame=3,
                                                dcn_impl_fwd="pallas")},
        "params": params, "port": port, "n_leaves": n_leaves,
        "windows": windows, "feats": feats,
    }


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("n_windows", [1, 3])
def test_forward_and_states_match_flax(nets, impl, n_windows):
    ref, params, port = nets["flax"][impl], nets["params"], nets["port"]
    rs = ref.init_states(2, H, W)
    ts = port.init_states(2, H, W)
    for x in nets["windows"][:n_windows]:
        ro, rs = ref.apply(params, x, rs)
        with torch.no_grad():
            to, ts = port(torch.from_numpy(x), ts)
        assert tuple(to.shape) == (2, H, W, 2)
        np.testing.assert_allclose(to.numpy(), np.asarray(ro), **TOL)
        for r, t in zip(rs, ts):
            assert tuple(t.shape) == (2, 3, 4, 16)  # padded 24x32 -> /8
            np.testing.assert_allclose(t.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_deformable_alignment_matches_flax(nets, impl):
    """``STFusion._fuse``, the block that holds the DCN, on random
    bottleneck features: the fractional gather dominates its output."""
    f0, f1 = nets["feats"]
    ref = FlaxSTFusion(channels=16, dcn_impl_fwd=None if impl == "jnp" else "pallas")
    sf_params = {"params": nets["params"]["params"]["spacetime_fuse"]}
    ro = ref.apply(sf_params, f0, f1, False, method=FlaxSTFusion._fuse)
    port_sf = nets["port"].spacetime_fuse
    with torch.no_grad():
        to = port_sf._fuse(torch.from_numpy(f0).permute(0, 3, 1, 2),
                           torch.from_numpy(f1).permute(0, 3, 1, 2))
        np.testing.assert_allclose(to.permute(0, 2, 3, 1).numpy(), np.asarray(ro), **TOL)
        # the offsets matter: zero offsets and 0.5 masks give another result
        om = port_sf.dcn_offset_mask
        saved = (om.weight.clone(), om.bias.clone())
        om.weight.zero_()
        om.bias.zero_()
        t0 = port_sf._fuse(torch.from_numpy(f0).permute(0, 3, 1, 2),
                           torch.from_numpy(f1).permute(0, 3, 1, 2))
        om.weight.copy_(saved[0])
        om.bias.copy_(saved[1])
    assert float((to - t0).abs().max()) > 1e-3  # measured ~5e-3


def test_converter_consumes_every_leaf_and_counts_params(nets):
    params, port = nets["params"], nets["port"]
    flat = convert.flatten_tree(params)
    assert nets["n_leaves"] == len(flat)
    assert sum(p.numel() for p in port.parameters()) / 1e6 == _num_params(params)
    back = convert.flatten_tree(convert.export_flax_params(port))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("fault,message", [("missing", "missing"),
                                           ("left_over", "left over"),
                                           ("wrong_shape", "shape")])
def test_converter_refuses_a_tree_that_does_not_fit(nets, fault, message):
    tree = jax.tree.map(np.copy, nets["params"])
    sf = tree["params"]["spacetime_fuse"]
    if fault == "missing":
        del sf["dcn_bias"]
    elif fault == "left_over":
        sf["extra"] = {"kernel": np.zeros((3, 3, 1, 1), np.float32)}
    else:
        sf["dcn_weight"] = sf["dcn_weight"][:, :, :8]
    target = DeepRecurrNet(inch=2, basech=2, num_frame=3)
    before = target.head.conv.weight.detach().clone()
    with pytest.raises(ValueError, match=message):
        convert.load_flax_params(target, tree)
    assert torch.equal(target.head.conv.weight, before)  # nothing copied


# -- the UNet family ----------------------------------------------------------
#
# Each model at base 4 on a 17x23 grid (odd sizes: the encoders' ceil
# halvings and the skips' pad-or-crop both ways), seeded flax weights
# brought across by the bridge, 3 frames threading the states. Tolerance
# 1e-5 * max(|ref|, 1) on every output and state leaf (measured ~1e-7).

UH, UW = 17, 23
UNETS = {
    "srunet_sum_lstm": ("SRUNetRecurrent", dict(base_num_channels=4, num_encoders=3,
                                                num_bins=2, num_output_channels=2)),
    "srunet_concat_gru": ("SRUNetRecurrent", dict(base_num_channels=4, num_encoders=2,
                                                  skip_type="concat", kernel_size=3,
                                                  recurrent_block_type="convgru",
                                                  final_activation="sigmoid")),
    "unet_sum_lstm": ("UNetRecurrent", dict(base_num_channels=4, num_encoders=3,
                                            num_bins=2)),
    "unet_concat_lstm": ("UNetRecurrent", dict(base_num_channels=4, num_encoders=2,
                                               skip_type="concat", num_bins=3)),
    "unet_sum_gru": ("UNetRecurrent", dict(base_num_channels=4, num_encoders=2,
                                           recurrent_block_type="convgru", num_bins=2)),
    "unet_concat_gru_transposed": ("UNetRecurrent", dict(
        base_num_channels=4, num_encoders=3, skip_type="concat",
        recurrent_block_type="convgru", use_upsample_conv=False, kernel_size=3,
        num_bins=2, final_activation="tanh")),
    "unet_flow": ("UNetFlow", dict(base_num_channels=4, num_encoders=2, num_bins=2)),
    "multires": ("MultiResUNet", dict(base_num_channels=4, num_encoders=3, num_bins=2,
                                      num_output_channels=2, final_activation="sigmoid")),
    "multires_transposed": ("MultiResUNet", dict(base_num_channels=4, num_encoders=2,
                                                 num_bins=2, use_upsample_conv=False,
                                                 kernel_size=3)),
    # norm: the reference's batch_stats collection crosses the bridge with
    # the params (running statistics drawn positive for the variances)
    "srunet_sum_lstm_bn": ("SRUNetRecurrent", dict(base_num_channels=4, num_encoders=2,
                                                   num_bins=2, num_output_channels=2,
                                                   norm="BN")),
    "unet_sum_gru_in": ("UNetRecurrent", dict(base_num_channels=4, num_encoders=2,
                                              recurrent_block_type="convgru", num_bins=2,
                                              norm="IN")),
    "unet_concat_transposed_bn": ("UNetRecurrent", dict(
        base_num_channels=4, num_encoders=2, skip_type="concat", use_upsample_conv=False,
        kernel_size=3, num_bins=2, norm="BN")),
    "multires_in": ("MultiResUNet", dict(base_num_channels=4, num_encoders=2, num_bins=2,
                                         norm="IN")),
}
ADAPTERS = {"srunet_seq": "SRUNetRecurrentSeq", "unet_seq": "UNetRecurrentSeq"}


def _seeded_params(shapes, rng):
    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['var']"):
            # a norm's running variance
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 0.3
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(got.detach().numpy() - ref).max()) <= tol * scale


@pytest.fixture(scope="module")
def unets():
    """Each UNet case: the flax model, its seeded params, the port model
    (built by name through the port's registry) and 3 seeded frames."""
    resolve_device("cpu")
    out = {}
    for i, (case, (name, kw)) in enumerate({**UNETS, **{
            k: (n, dict(base_num_channels=4, num_encoders=2)) for k, n in ADAPTERS.items()
    }}.items()):
        rng = np.random.default_rng(100 + i)
        ref = J_REGISTRY[name](**kw)
        port = TR.get_model(name, **kw)
        if case in ADAPTERS:
            frames = [rng.poisson(0.7, (2, 3, UH, UW, ref.inch)).astype(np.float32)
                      for _ in range(2)]
            args = (frames[0], ref.init_states(2, UH, UW))
        else:
            frames = [rng.standard_normal((2, UH, UW, ref.num_bins)).astype(np.float32)
                      for _ in range(3)]
            args = ((frames[0],) if name == "MultiResUNet"
                    else (frames[0], ref.init_states(2, UH, UW)))
        params = _seeded_params(jax.eval_shape(ref.init, jax.random.PRNGKey(0), *args), rng)
        n_leaves = convert.load_flax_params(port, params)
        out[case] = {"name": name, "ref": ref, "port": port.eval(), "params": params,
                     "frames": frames, "n_leaves": n_leaves}
    return out


@pytest.mark.parametrize("case", sorted(UNETS))
def test_unet_matches_flax(unets, case):
    u = unets[case]
    ref, port, params = u["ref"], u["port"], u["params"]
    if u["name"] == "MultiResUNet":
        for x in u["frames"]:
            want = ref.apply(params, x)
            with torch.no_grad():
                got = port(torch.from_numpy(x))
            assert len(got) == len(want) == ref.num_encoders
            for g, r in zip(got, want):
                _close(g, r)
        return
    rs = ref.init_states(2, UH, UW)
    ts = port.init_states(2, UH, UW)
    # the port's flat state is the reference's leaves, in order
    assert [tuple(t.shape) for t in ts] == [r.shape for r in jax.tree.leaves(rs)]
    for x in u["frames"]:
        want, rs = ref.apply(params, x, rs)
        with torch.no_grad():
            got, ts = port(torch.from_numpy(x), ts)
        if isinstance(want, dict):
            assert sorted(got) == sorted(want) == ["flow", "image"]
            for k in want:
                _close(got[k], want[k])
        else:
            _close(got, want)
        assert len(ts) == len(jax.tree.leaves(rs))
        for t, r in zip(ts, jax.tree.leaves(rs)):
            _close(t, r)


@pytest.mark.parametrize("case", sorted(ADAPTERS))
def test_adapter_matches_flax(unets, case):
    """Two windows of 3 frames through ``FrameRecurrentSR``: the middle
    frame's output on the input grid (the SR variant's 2x output resized by
    bicubic) and the states after each window."""
    u = unets[case]
    ref, port, params = u["ref"], u["port"], u["params"]
    assert port.inch == ref.inch == 2 and port.num_frame == ref.num_frame == 3
    rs = ref.init_states(2, UH, UW)
    ts = port.init_states(2, UH, UW)
    for x in u["frames"]:
        want, rs = ref.apply(params, x, rs)
        with torch.no_grad():
            got, ts = port(torch.from_numpy(x), ts)
        assert tuple(got.shape) == (2, UH, UW, 2)
        _close(got, want)
        for t, r in zip(ts, jax.tree.leaves(rs)):
            _close(t, r)
    # the window asserts of the reference
    with pytest.raises(AssertionError, match="num_frame"):
        port(torch.zeros((1, 5, UH, UW, 2)), port.init_states(1, UH, UW))
    even = TA.FrameRecurrentSR(port.model, num_frame=2)
    with pytest.raises(AssertionError, match="odd"):
        even(torch.zeros((1, 2, UH, UW, 2)), port.init_states(1, UH, UW))


@pytest.mark.parametrize("norm", ["BN", "IN"])
def test_norm_adapter_trains_as_the_reference(norm):
    """``SRUNetRecurrentSeq`` with ``norm`` in training: two windows of 3
    frames, each frame's encoders and decoders run (the decoders' norms
    update their running statistics on every frame, as the reference's
    whole-frame loop does): the middle frame's output, the states and the
    ``batch_stats`` after each window against the reference's train-mode
    apply. Tolerance 1e-5 * max(|ref|, 1), and 1e-4 under IN, whose
    per-instance ``E[x^2] - E[x]^2`` over a few pixels amplifies the f32
    summation order (measured 1.4e-5 of the scale)."""
    import copy

    kw = dict(base_num_channels=4, num_encoders=2, norm=norm)
    ref = J_REGISTRY["SRUNetRecurrentSeq"](**kw)
    port = TR.get_model("SRUNetRecurrentSeq", **kw)
    rng = np.random.default_rng(7)
    frames = [rng.poisson(0.7, (2, 3, UH, UW, 2)).astype(np.float32) for _ in range(2)]
    params = _seeded_params(jax.eval_shape(ref.init, jax.random.PRNGKey(0), frames[0],
                                           ref.init_states(2, UH, UW)), rng)
    convert.load_flax_params(port, params)
    port = copy.deepcopy(port).train()
    tol = 1e-4 if norm == "IN" else 1e-5
    rs, ts = ref.init_states(2, UH, UW), port.init_states(2, UH, UW)
    for x in frames:
        (want, rs), mut = ref.apply(params, x, rs, True, mutable=["batch_stats"])
        params = {**params, "batch_stats": mut["batch_stats"]}
        with torch.no_grad():
            got, ts = port(torch.from_numpy(x), ts)
        _close(got, want, tol)
        for t, r in zip(ts, jax.tree.leaves(rs)):
            _close(t, r, tol)
        stats = convert.flatten_tree(convert.export_flax_params(port)["batch_stats"])
        want_stats = convert.flatten_tree(jax.tree.map(np.asarray, mut["batch_stats"]))
        assert set(stats) == set(want_stats) and len(stats) >= 8
        for k in want_stats:
            _close(torch.from_numpy(stats[k]), want_stats[k], tol)


@pytest.mark.parametrize("case", sorted(UNETS) + sorted(ADAPTERS))
def test_converter_consumes_every_unet_leaf(unets, case):
    u = unets[case]
    flat = convert.flatten_tree(u["params"])
    assert u["n_leaves"] == len(flat)
    assert (sum(p.numel() for p in u["port"].parameters()) / 1e6
            == _num_params(u["params"]["params"]))
    back = convert.flatten_tree(convert.export_flax_params(u["port"]))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_recipe_tree_loads_leaf_for_leaf():
    """``configs/train_srunet_2x.yml``'s model at full width: the
    reference's tree (38 leaves, 3,222,546 parameters, all under
    ``params/model``) loads into the port with nothing missing or left over,
    and exports back; its states are three (h, c) pairs at batch 8 on the
    90x160 grid."""
    args = dict(num_frame=3, num_bins=2, num_output_channels=2, base_num_channels=16,
                num_encoders=3, num_residual_blocks=2, skip_type="sum",
                recurrent_block_type="convlstm", kernel_size=5)
    ref = J_REGISTRY["SRUNetRecurrentSeq"](**args)
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            np.zeros((1, 3, 90, 160, 2), np.float32),
                            ref.init_states(1, 90, 160))
    tree = jax.tree.map(lambda s: np.full(s.shape, 0.01, np.float32), shapes)
    flat = convert.flatten_tree(tree)
    assert len(flat) == 38 and sum(v.size for v in flat.values()) == 3_222_546
    assert {k[:2] for k in flat} == {("params", "model")}
    port = TR.get_model("SRUNetRecurrentSeq", **args)
    assert convert.load_flax_params(port, tree) == 38
    assert sum(p.numel() for p in port.parameters()) == 3_222_546
    assert set(convert.flatten_tree(convert.export_flax_params(port))) == set(flat)
    assert [tuple(s.shape) for s in port.init_states(8, 90, 160)] == [
        (8, 45, 80, 32), (8, 45, 80, 32), (8, 23, 40, 64), (8, 23, 40, 64),
        (8, 12, 20, 128), (8, 12, 20, 128)]


def test_registry_names_are_the_references():
    assert sorted(TR.MODEL_REGISTRY) == sorted(J_REGISTRY)
    with pytest.raises(KeyError, match="unknown model"):
        TR.get_model("NoSuchNet")


@pytest.mark.parametrize("key", ["dcn_sparse", "numerics"])
def test_flagship_args_refused_for_unets_as_the_reference(key):
    """The reference's UNets take no DCN or probe arguments (a ``TypeError``
    from the flax dataclass); the port refuses with the same kind, naming
    the argument."""
    with pytest.raises(TypeError, match=key):
        J_REGISTRY["SRUNetRecurrentSeq"](base_num_channels=4, **{key: True})
    with pytest.raises(TypeError, match=key):
        TR.get_model("SRUNetRecurrentSeq", base_num_channels=4, **{key: True})


# -- the extended blocks ----------------------------------------------------
#
# Each block's flax init (plus seeded noise, so no parameter is a constant)
# crosses the weight bridge, ``batch_stats`` included; both sides see the
# same seeded input. Compared: the output, the gradient of sum(out * w)
# with respect to the input and every parameter, and in training the
# updated running statistics. Tolerance: atol 1e-5 + rtol 1e-4 (measured
# <= 5e-6: the same f32 convolutions and norms summed in other orders); a
# parameter gradient within 1e-5 of the largest gradient entry of the block
# (a conv bias before a norm has a true gradient of 0, and both sides
# return rounding noise there, measured up to 1.3e-4 of a scale ~100).

import jax.numpy as jnp  # noqa: E402

from esr_tpu.models import extended as JX  # noqa: E402
from esr_tpu_torch.models import extended as TX  # noqa: E402

EXT_TOL = dict(atol=1e-5, rtol=1e-4)
# name -> (flax block, port block, input shape (channel-last), layout, takes train)
EXT_CASES = {
    "inception": (lambda: JX.InceptionBlock(8, 3, 1, 2), lambda: TX.InceptionBlock(6, 8, 3, 1, 2),
                  (2, 10, 12, 6), "image", False),
    "dilated": (lambda: JX.DilatedBlock(8), lambda: TX.DilatedBlock(6, 8),
                (2, 10, 12, 6), "image", False),
    "self_attention": (lambda: JX.SelfAttention(8), lambda: TX.SelfAttention(8),
                       (2, 16, 8), "points", True),
    "conv3d_bn": (lambda: JX.Conv3DBlock(5), lambda: TX.Conv3DBlock(3, 5),
                  (2, 4, 6, 6, 3), "image", True),
    "conv3d_in": (lambda: JX.Conv3DBlock(5, norm="IN"), lambda: TX.Conv3DBlock(3, 5, norm="IN"),
                  (2, 4, 6, 6, 3), "image", True),
    "deconv3d_bn": (lambda: JX.Deconv3DBlock(5), lambda: TX.Deconv3DBlock(3, 5),
                    (2, 3, 4, 4, 3), "image", True),
    "deconv3d_none": (lambda: JX.Deconv3DBlock(5, norm=None, activation=None),
                      lambda: TX.Deconv3DBlock(3, 5, norm=None, activation=None),
                      (2, 3, 4, 4, 3), "image", True),
    "conv3d_block2": (lambda: JX.Conv3DBlock2(5), lambda: TX.Conv3DBlock2(3, 5),
                      (2, 4, 6, 6, 3), "image", True),
    "conv3d_block2_padded": (lambda: JX.Conv3DBlock2(4, pool_kernel=3, pool_stride=2,
                                                     pool_padding=1),
                             lambda: TX.Conv3DBlock2(3, 4, pool_kernel=3, pool_stride=2,
                                                     pool_padding=1),
                             (1, 5, 6, 7, 3), "image", True),
    "deconv3d_block2": (lambda: JX.Deconv3DBlock2(5), lambda: TX.Deconv3DBlock2(3, 5),
                        (2, 3, 4, 4, 3), "image", True),
    "dense_edge_conv": (lambda: JX.DenseEdgeConv(4, 3, 5), lambda: TX.DenseEdgeConv(3, 4, 3, 5),
                        (2, 20, 3), "points", False),
}


def _to_port(a, layout):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(a, -1, 1) if layout == "image" else a))


def _from_port(t, layout):
    a = t.detach().numpy()
    return np.moveaxis(a, 1, -1) if layout == "image" else a


@pytest.mark.parametrize("name,train", [(n, t) for n in sorted(EXT_CASES)
                                        for t in ((False, True) if EXT_CASES[n][4] else (False,))])
def test_extended_block_matches_flax(name, train):
    jmake, tmake, shape, layout, takes_train = EXT_CASES[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    if name == "dense_edge_conv":
        x = np.round(x, 1)
        x[:, 5] = x[:, 2]  # a duplicate point: unique knn ranks it last
    jm = jmake()
    args = (jnp.asarray(x),) + ((train,) if takes_train else ())
    variables = jax.tree.map(np.asarray, dict(jm.init(jax.random.PRNGKey(0), *args)))
    variables["params"] = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.05).astype(np.float32),
        variables["params"])
    tm = tmake().train(train)
    convert.load_flax_params(tm, variables)
    assert set(convert.flatten_tree(convert.export_flax_params(tm))) == set(
        convert.flatten_tree(variables))

    def jfwd(params, xx):
        v = {**variables, "params": params}
        if takes_train and train:
            out, mut = jm.apply(v, xx, True, mutable=["batch_stats"])
            return out, mut
        out = jm.apply(v, *((xx,) + ((False,) if takes_train else ())))
        return out, {}

    jout, jmut = jfwd(variables["params"], jnp.asarray(x))
    xt = _to_port(x, layout).requires_grad_(True)
    tout = tm(xt)
    if name == "dense_edge_conv":
        np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
        tout, jout = tout[0], jout[0]
    np.testing.assert_allclose(_from_port(tout, layout), np.asarray(jout), **EXT_TOL)
    w = rng.standard_normal(np.asarray(jout).shape).astype(np.float32)
    (tout * _to_port(w, layout)).sum().backward()

    def jloss(params, xx):
        out = jfwd(params, xx)[0]
        return jnp.sum((out[0] if isinstance(out, tuple) else out) * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    np.testing.assert_allclose(_from_port(xt.grad, layout), np.asarray(jgx), **EXT_TOL)
    for p in tm.parameters():
        p.data = p.grad
    got = convert.flatten_tree({"params": convert.export_flax_params(tm)["params"]})
    want = convert.flatten_tree({"params": jax.tree.map(np.asarray, jgp)})
    assert set(got) == set(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg="/".join(k), rtol=1e-4,
                                   atol=1e-5 * max(scale, 1.0))
    if jmut:
        stats = convert.flatten_tree({"batch_stats": convert.export_flax_params(tm)["batch_stats"]})
        jstats = convert.flatten_tree({"batch_stats": jax.tree.map(np.asarray, jmut["batch_stats"])})
        for k in jstats:
            np.testing.assert_allclose(stats[k], jstats[k], err_msg="/".join(k), **EXT_TOL)


def test_group_knn_ties_and_point_ops_match_flax():
    """Equal distances rank the lower index first (the reference's
    ``top_k``): a lattice has many; then the distance matrix, and
    MeanShift on NCHW."""
    g = np.stack(np.meshgrid(np.arange(4.0), np.arange(4.0), indexing="ij"), -1)
    pts = np.concatenate([g.reshape(1, 16, 2), np.zeros((1, 16, 1))], -1).astype(np.float32)
    pts = np.concatenate([pts, pts[:, ::-1]], 0)
    for unique in (True, False):
        jn, ji, jd = JX.group_knn(6, jnp.asarray(pts), jnp.asarray(pts), unique)
        tn, ti, td = TX.group_knn(6, torch.from_numpy(pts), torch.from_numpy(pts), unique)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **EXT_TOL)
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 5, 3)).astype(np.float32)
    b = rng.standard_normal((2, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TX.batch_distance_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(JX.batch_distance_matrix(jnp.asarray(a), jnp.asarray(b))), **EXT_TOL)
    img = rng.uniform(0, 255, (2, 4, 5, 3)).astype(np.float32)
    mean, std = (0.4488, 0.4371, 0.4040), (1.0, 0.9, 1.1)
    for sign in (-1, 1):
        want = np.asarray(JX.MeanShift(mean, std, sign).apply({}, jnp.asarray(img)))
        got = TX.MeanShift(mean, std, sign)(_to_port(img, "image"))
        np.testing.assert_allclose(_from_port(got, "image"), want, **EXT_TOL)
