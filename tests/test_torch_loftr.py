"""Port parity: the LoFTR pair matcher against the JAX ``LoFTRMatcher`` on the CPU.

A narrow config (backbone 32/48/64, coarse d_model 64 over 2x(self, cross),
fine d_model 32, window 9) at 128^2, so the coarse streams hold 256 tokens
and run K1's plain version on the port's side (the JAX package's XLA layer
on its side). Weights come from the JAX ``init`` with perturbed BatchNorm
statistics and reach the port through ``utils.weights``; each side is built
from its own config classes. Matching on the port runs K2's plain version
(f32), the JAX package its dense f32 path. Tolerances: match sets equal,
mconf 1e-5 (f32 features of 8 coarse layer applications differ by ~1e-6
relative, logits reach ~|10| at T 0.1); fine positions 1e-3 px, expected
offsets 1e-4 and their std 1e-3 (the square root of a small variance
amplifies f32 differences); sampled features 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.config import (
    CoarseMatchingConfig,
    LoFTRConfig,
    ResNetFPNConfig,
    TransformerConfig,
)
from onepose_plus_plus_tpu.models.build import loftr_config_from_dict as jax_loftr_config
from onepose_plus_plus_tpu.models.loftr import LoFTRMatcher as JaxLoFTR, _bilinear_sample
from onepose_plus_plus_tpu.utils.checkpoint import convert_torch_state_dict
from onepose_plus_plus_tpu_torch.models.build import (
    build_loftr_matcher,
    loftr_config_from_dict,
    make_loftr_fns,
)
from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher, bilinear_sample
from onepose_plus_plus_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from port_helpers import perturbed, textured, to_port_config

torch.set_num_threads(2)

NARROW = LoFTRConfig(
    backbone=ResNetFPNConfig(initial_dim=32, block_dims=(32, 48, 64)),
    coarse=TransformerConfig(d_model=64, nhead=8, layer_iter_n=2),
    coarse_matching=CoarseMatchingConfig(thr=1e-4, temperature=0.1, border_rm=2,
                                         border_two_sided=True, max_matches=64),
    fine=TransformerConfig(d_model=32, nhead=8, layer_iter_n=1),
)
SIZE = 128


@pytest.fixture(scope="module")
def pair():
    """JAX model + variables, the port model on the same weights, and a shifted
    image pair."""
    rng = np.random.default_rng(0)
    img0 = textured(rng, 2, SIZE)
    img1 = np.roll(img0, (8, 16), axis=(1, 2))  # a shift of 2 x 1 coarse cells
    jm = JaxLoFTR(NARROW)
    variables = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), img0, img1))
    port = LoFTRMatcher(to_port_config(NARROW)).eval()
    load_jax_variables(port, variables)
    return jm, variables, port, img0, img1


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _slots(out, b):
    """{(i, j): slot} of the valid match slots of batch element b."""
    m = np.asarray(out["match_mask"][b]).astype(bool)
    i, j = np.asarray(out["i_ids"][b])[m], np.asarray(out["j_ids"][b])[m]
    return {(int(a), int(c)): s for s, a, c in zip(np.flatnonzero(m), i, j)}


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((2, 9, 13, 5)).astype(np.float32)
    xy = rng.uniform(-2.0, 15.0, (2, 40, 2)).astype(np.float32)  # some outside: clamped
    ref = jax.vmap(_bilinear_sample)(jnp.asarray(feat), jnp.asarray(xy))
    out = bilinear_sample(_t(feat), _t(xy))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_loftr_weights_round_trip_strictly():
    """Every tensor of a JAX LoFTRMatcher.init lands in the port, and the port's
    state dict converts back onto the same tree (both directions strict)."""
    cfg = jax_loftr_config({})
    jm = JaxLoFTR(cfg)
    probe = np.zeros((1, 64, 64, 1), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(1), probe, probe))
    port = LoFTRMatcher(loftr_config_from_dict({}))
    load_jax_variables(port, variables)  # raises on a missing or unexpected tensor
    names = {k for k in port.state_dict() if not k.endswith("num_batches_tracked")}
    assert names == set(state_dict_from_jax(variables))
    back, report = convert_torch_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                            variables, strict=True)
    assert not report["missing"] and not report["skipped"]
    flat_ref = jax.tree_util.tree_leaves_with_path(variables)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf)


def test_loftr_config_from_dict_matches_jax():
    for d in ({}, {"compute_dtype": "bfloat16", "match_coarse": {"thr": 0.05, "max_matches": 512}}):
        assert loftr_config_from_dict(d) == to_port_config(jax_loftr_config(d))


def test_match_coarse_matches_jax(pair):
    jm, variables, port, img0, img1 = pair
    ref = jm.apply(variables, img0, img1, method="match_coarse")
    with torch.no_grad():
        out = port.match_coarse(_t(img0), _t(img1))
    assert out["hw0_c"] == tuple(ref["hw0_c"]) and out["hw1_c"] == tuple(ref["hw1_c"])
    total = 0
    for b in range(2):
        so, sr = _slots(out, b), _slots(ref, b)
        assert set(so) == set(sr)
        total += len(so)
        for key, s in so.items():
            r = sr[key]
            assert abs(float(out["mconf"][b, s]) - float(ref["mconf"][b, r])) < 1e-5
            np.testing.assert_array_equal(out["mkpts0_c"][b, s].numpy(), np.asarray(ref["mkpts0_c"][b, r]))
            np.testing.assert_array_equal(out["mkpts1_c"][b, s].numpy(), np.asarray(ref["mkpts1_c"][b, r]))
    assert total > 0
    # border rows of image 0 (the restored row_grid_hw) and columns of image 1 give no match
    h, w = out["hw0_c"]
    for ids in (out["i_ids"][out["match_mask"]], out["j_ids"][out["match_mask"]]):
        r, c = ids // w, ids % w
        assert bool(((r >= 2) & (r < h - 2) & (c >= 2) & (c < w - 2)).all())


def test_match_matches_jax(pair):
    jm, variables, port, img0, img1 = pair
    ref = jm.apply(variables, img0, img1, method="match")
    with torch.no_grad():
        out = port.match(_t(img0), _t(img1))
    n = 0
    for b in range(2):
        mo, mr = out["match_mask"][b].numpy(), np.asarray(ref["match_mask"][b])
        assert mo.sum() == mr.sum()
        # slots sort by confidence in both; compare by the coarse keypoint pair
        ko = {tuple(out["mkpts0_c"][b, s].tolist() + out["mkpts1_c"][b, s].tolist()): s for s in np.flatnonzero(mo)}
        kr = {tuple(np.asarray(ref["mkpts0_c"][b, s]).tolist() + np.asarray(ref["mkpts1_c"][b, s]).tolist()): s
              for s in np.flatnonzero(mr)}
        assert set(ko) == set(kr)
        for key, s in ko.items():
            r = kr[key]
            np.testing.assert_allclose(out["mkpts1_f"][b, s].numpy(), np.asarray(ref["mkpts1_f"][b, r]), atol=1e-3)
            np.testing.assert_allclose(out["expec_f"][b, s].numpy(), np.asarray(ref["expec_f"][b, r]), atol=1e-4)
            n += 1
    assert n > 0


def _refine_inputs(rng, k=48):
    """Coarse matches in pixels: interior, near and across the border, and
    invalid slots far off the map."""
    mk0 = rng.uniform(-6.0, SIZE + 6.0, (2, k, 2)).astype(np.float32)
    mk1 = (mk0 + rng.normal(0, 3.0, mk0.shape)).astype(np.float32)
    mask = np.ones((2, k), bool)
    mask[:, -6:] = False
    mk0[:, -6:] = -100.0
    mk1[:, -6:] = -100.0
    return mk0, mk1, mask


def test_refine_with_features_matches_jax(pair):
    jm, variables, port, img0, img1 = pair
    mk0, mk1, mask = _refine_inputs(np.random.default_rng(2))
    ref = jm.apply(variables, img0, img1, mk0, mk1, mask, extract_features=True, method="refine")
    with torch.no_grad():
        out = port.refine(_t(img0), _t(img1), _t(mk0), _t(mk1), _t(mask), extract_features=True)
    np.testing.assert_array_equal(out["mkpts0_f"].numpy(), np.asarray(ref["mkpts0_f"]))
    np.testing.assert_array_equal(out["match_mask"].numpy(), np.asarray(ref["match_mask"]))
    np.testing.assert_allclose(out["mkpts1_f"].numpy(), np.asarray(ref["mkpts1_f"]), atol=1e-3)
    ef, er = out["expec_f"].numpy(), np.asarray(ref["expec_f"])
    np.testing.assert_allclose(ef[..., :2], er[..., :2], atol=1e-4)
    np.testing.assert_allclose(ef[..., 2], er[..., 2], atol=1e-3)  # std: sqrt of a small variance
    for key in ("feat_coarse_0", "feat_coarse_1", "feat_fine_0", "feat_fine_1"):
        r = np.asarray(ref[key])
        assert out[key].shape == r.shape and out[key].dtype == torch.float32
        np.testing.assert_allclose(out[key].numpy(), r, atol=1e-4 * max(1.0, np.abs(r).max()))


def test_sfm_surfaces_on_cpu(pair):
    """The numpy-in, CPU-tensor-out surfaces of make_loftr_fns agree with the
    model's modes."""
    _, _, port, img0, img1 = pair
    coarse_fn, refine_fn, extract_fn = make_loftr_fns(port)
    mk0, mk1, mask = _refine_inputs(np.random.default_rng(3))
    res = coarse_fn(img0, img1)
    with torch.no_grad():
        direct = port.match_coarse(_t(img0), _t(img1))
    for k in ("mkpts0_c", "mkpts1_c", "mconf", "match_mask"):
        np.testing.assert_array_equal(np.asarray(res[k]), direct[k].numpy())
    r = refine_fn(img0, img1, mk0, mk1, mask)
    e = extract_fn(img0, mk0, mask)
    with torch.no_grad():
        self_pair = port.refine(_t(img0), _t(img0), _t(mk0), _t(mk0), _t(mask), extract_features=True)
    assert np.asarray(r["mkpts1_f"]).shape == (2, mk0.shape[1], 2)
    np.testing.assert_array_equal(np.asarray(e["feat_fine"]), self_pair["feat_fine_0"].numpy())
    np.testing.assert_array_equal(np.asarray(e["feat_coarse"]), self_pair["feat_coarse_0"].numpy())
    assert build_loftr_matcher({}, device="cpu").cfg == loftr_config_from_dict({})
