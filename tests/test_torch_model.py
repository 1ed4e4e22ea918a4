"""The port's DeepRecurrNet against flax ``model.apply`` at f32 on the CPU,
with the same weights brought across by the weight bridge.

The weights are seeded numpy draws laid out on the reference's own
parameter tree (``jax.eval_shape`` of its init), so the offset/mask conv
is non-zero: the reference zero-initializes it, which would leave every
offset 0 and every mask 0.5 and the fractional gather untested. The map
(20, 28) is not a multiple of 8, so padding and cropping are exercised.
The reference runs its DCN both through the jnp formulation and through
the Pallas forward kernel in interpret mode. Tolerance: atol 1e-5 + rtol
1e-4 on outputs and states; the measured envelope is ~5e-8.
"""

import jax
import numpy as np
import pytest
import torch

from esr_tpu.inference.harness import _num_params
from esr_tpu.models.esr import DeepRecurrNet as FlaxNet
from esr_tpu.models.esr import STFusion as FlaxSTFusion
from esr_tpu_torch.device import resolve_device
from esr_tpu_torch.models import convert
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
