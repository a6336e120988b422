"""Port parity: backbone, encodings and the whole matcher forward against the JAX model.

Weights come from the JAX model's init (with BatchNorm statistics and norm
parameters perturbed from a numpy seed, so that no layer is an identity) and
reach the port through ``utils.weights``. Tolerances follow
``tests/test_reference_parity.py:90-122``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.config import (
    CoarseMatchingConfig,
    FineConfig,
    KeypointEncodingConfig,
    OnePosePlusConfig,
    ResNetFPNConfig,
    TransformerConfig,
)
from onepose_plus_plus_tpu.models.backbone import ResNetFPN_8_2 as JaxBackbone, _StemConv
from onepose_plus_plus_tpu.models.onepose_plus import OnePosePlusModel as JaxModel
from onepose_plus_plus_tpu.models.position_encoding import (
    KeypointEncoder as JaxKeypointEncoder,
    normalize_3d_keypoints as jax_normalize,
    sine_position_encoding as jax_sine_pe,
)
from onepose_plus_plus_tpu.utils.checkpoint import convert_torch_state_dict
from onepose_plus_plus_tpu_torch.models.backbone import ResNetFPN_8_2, _Conv
from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel
from onepose_plus_plus_tpu_torch.models.position_encoding import (
    KeypointEncoder,
    normalize_3d_keypoints,
    sine_position_encoding,
)
from onepose_plus_plus_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from port_helpers import perturbed as _perturbed, textured as _textured

torch.set_num_threads(2)

NARROW_BACKBONE = ResNetFPNConfig(initial_dim=32, block_dims=(32, 48, 64))
NARROW = OnePosePlusConfig(
    backbone=NARROW_BACKBONE,
    keypoints_encoding=KeypointEncodingConfig(descriptor_dim=64),
    coarse=TransformerConfig(d_model=64, nhead=8, layer_iter_n=3),
    coarse_matching=CoarseMatchingConfig(thr=0.0, max_matches=256),
    fine=FineConfig(d_model=32, transformer=TransformerConfig(d_model=32, nhead=8, layer_iter_n=1)),
)


def test_backbone_matches_jax():
    """The direct 7x7/2 stem and F.interpolate FPN against the JAX backbone
    (space-to-depth stem, matmul upsample) on the same weights."""
    img = _textured(np.random.default_rng(0), 2, 64)
    jb = JaxBackbone(NARROW_BACKBONE)
    variables = _perturbed(jax.jit(jb.init)(jax.random.PRNGKey(0), img))
    rc, rf = jax.jit(jb.apply)(variables, img)
    port = ResNetFPN_8_2(NARROW_BACKBONE).eval()
    load_jax_variables(port, variables)
    with torch.no_grad():
        oc, of = port(torch.from_numpy(img))
    assert oc.shape == rc.shape and of.shape == rf.shape
    np.testing.assert_allclose(oc.numpy(), np.asarray(rc), atol=1e-4)
    np.testing.assert_allclose(of.numpy(), np.asarray(rf), atol=1e-4)


def test_direct_stem_matches_s2d_stem():
    img = np.random.default_rng(1).random((2, 32, 48, 1)).astype(np.float32)
    stem = _StemConv(16, s2d=True)
    params = stem.init(jax.random.PRNGKey(1), img)
    ref = stem.apply(params, img)
    port = _Conv(1, 16, 7, 2, padding=3)
    port.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        out = port(torch.from_numpy(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("temp_bug_fix", [False, True])
def test_sine_position_encoding(temp_bug_fix):
    x = np.random.default_rng(2).standard_normal((2, 6, 10, 64)).astype(np.float32)
    ref = jax_sine_pe(jnp.asarray(x), temp_bug_fix)
    out = sine_position_encoding(torch.from_numpy(x), temp_bug_fix)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_keypoint_encoder():
    rng = np.random.default_rng(3)
    kpts = rng.uniform(-0.4, 0.3, (2, 50, 3)).astype(np.float32)
    desc = rng.standard_normal((2, 50, 64)).astype(np.float32)
    norm_ref = jax_normalize(jnp.asarray(kpts))
    norm = normalize_3d_keypoints(torch.from_numpy(kpts))
    np.testing.assert_allclose(norm.numpy(), np.asarray(norm_ref), atol=1e-6)
    enc = JaxKeypointEncoder(feature_dim=64)
    variables = _perturbed(enc.init(jax.random.PRNGKey(3), norm_ref, desc))
    ref = enc.apply(variables, norm_ref, desc)
    port = KeypointEncoder(feature_dim=64)
    load_jax_variables(port, variables)
    with torch.no_grad():
        out = port(norm, torch.from_numpy(desc))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("norm_method", ["instancenorm", "layernorm", "none"])
def test_keypoint_encoder_norm_methods(norm_method):
    """Every ``norm_method`` of the JAX encoder at f32 (layernorm: flax's
    LayerNorm, eps 1e-5, scale and bias); the Linear layers stay at 0, 3, 6, 9
    and the norm (or an Identity) sits at 1, 4, 7, so the weights load strictly."""
    rng = np.random.default_rng(11)
    kpts = rng.uniform(-0.5, 0.5, (2, 40, 3)).astype(np.float32)
    desc = rng.standard_normal((2, 40, 64)).astype(np.float32)
    enc = JaxKeypointEncoder(feature_dim=64, norm_method=norm_method)
    variables = _perturbed(enc.init(jax.random.PRNGKey(5), kpts, desc), seed=2)
    ref = enc.apply(variables, kpts, desc)
    port = KeypointEncoder(feature_dim=64, norm_method=norm_method)
    from_jax = state_dict_from_jax(variables)
    assert port.load_state_dict(from_jax, strict=True)
    assert sorted({k.split(".")[1] for k in from_jax}) == (
        ["0", "1", "3", "4", "6", "7", "9"] if norm_method == "layernorm" else ["0", "3", "6", "9"])
    with torch.no_grad():
        out = port(torch.from_numpy(kpts), torch.from_numpy(desc))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    with pytest.raises(ValueError):
        KeypointEncoder(norm_method="batchnorm")


def test_layernorm_keypoint_encoder_through_the_model_and_the_jax_converter_fault():
    """The port's bridge carries ``kpt_encoder/LayerNorm_i`` to
    ``kpt_3d_pos_encoding.encoder.{3i+1}`` inside the whole model; the JAX
    package's ``convert_torch_state_dict`` maps ``encoder.N`` to
    ``dense_{N // 3}`` and so sends the LayerNorm at ``encoder.1`` onto
    ``dense_0`` (a fault of the JAX package, recorded, not repaired)."""
    cfg = dataclasses.replace(
        NARROW, keypoints_encoding=dataclasses.replace(NARROW.keypoints_encoding, norm_method="layernorm"))
    batch = _forward_inputs(False, n=1, size=64, points=64)
    variables = _perturbed(jax.jit(lambda k, b: JaxModel(cfg).init(k, b, train=False))(jax.random.PRNGKey(0), batch))
    port = OnePosePlusModel(cfg).eval()
    load_jax_variables(port, variables)
    ln = variables["params"]["kpt_encoder"]["LayerNorm_1"]
    np.testing.assert_array_equal(port.kpt_3d_pos_encoding.encoder[4].weight.detach().numpy(), ln["scale"])
    np.testing.assert_array_equal(port.kpt_3d_pos_encoding.encoder[4].bias.detach().numpy(), ln["bias"])
    with pytest.raises(ValueError, match="kpt_3d_pos_encoding.encoder.1.weight"):
        convert_torch_state_dict(port.state_dict(), variables, strict=True)
    back, report = convert_torch_state_dict(port.state_dict(), variables, strict=False)
    assert "params/kpt_encoder/LayerNorm_0/scale" in report["missing"]
    # the LayerNorm's bias (same shape) overwrites the first Linear's
    np.testing.assert_array_equal(np.asarray(back["params"]["kpt_encoder"]["dense_0"]["bias"]),
                                  variables["params"]["kpt_encoder"]["LayerNorm_0"]["bias"])


def _forward_inputs(masked: bool, n=2, size=128, points=256, seed=4):
    rng = np.random.default_rng(seed)
    batch = {
        "query_image": _textured(rng, n, size),
        "keypoints3d": rng.uniform(-0.3, 0.3, (n, points, 3)).astype(np.float32),
        "descriptors3d": rng.standard_normal((n, points, 32)).astype(np.float32),
        "descriptors3d_coarse": rng.standard_normal((n, points, 64)).astype(np.float32),
        "query_image_scale": np.array([[1.5, 2.0], [0.5, 1.0]], np.float32)[:n],
    }
    if masked:  # the bottom two rows of coarse cells are padding
        mask = np.ones((n, (size // 8) ** 2), bool)
        mask[:, -2 * (size // 8):] = False
        batch["query_image_mask"] = mask
    return batch


@pytest.mark.parametrize("masked", [False, True])
def test_model_forward_matches_jax(masked):
    batch = _forward_inputs(masked)
    jmodel = JaxModel(NARROW)
    variables = _perturbed(jax.jit(lambda k, b: jmodel.init(k, b, train=False))(jax.random.PRNGKey(0), batch))
    ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables, batch)
    ref = {k: np.asarray(v) for k, v in ref.items() if not isinstance(v, tuple)}

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    port = OnePosePlusModel(NARROW).eval()  # streaming matching (K2's plain version)
    load_jax_variables(port, variables)
    with torch.no_grad():
        out = {k: v.numpy() for k, v in port(tb).items() if torch.is_tensor(v)}
    dense_cfg = dataclasses.replace(
        NARROW, coarse_matching=dataclasses.replace(NARROW.coarse_matching, use_fused_kernel=False)
    )
    dense = OnePosePlusModel(dense_cfg).eval()
    load_jax_variables(dense, variables)
    with torch.no_grad():
        dense_out = {k: v.numpy() for k, v in dense(tb).items() if torch.is_tensor(v)}

    # 1. coarse dual-softmax confidence
    conf = dense_out["conf_matrix"]
    assert np.abs(conf - ref["conf_matrix"]).max() < 1e-3 * ref["conf_matrix"].max()
    # the dense path fills every slot as JAX does: the fine stage agrees on all
    # 256 slots of both frames, valid or not
    for k in ("i_ids", "j_ids", "match_mask"):
        np.testing.assert_array_equal(dense_out[k], ref[k])
    np.testing.assert_allclose(dense_out["mkpts_query_f"], ref["mkpts_query_f"], atol=1e-3)
    np.testing.assert_allclose(dense_out["expec_f"], ref["expec_f"], atol=1e-4)
    # mconf = exp(logit sum): the coarse features differ by ~1e-6 relative
    # after six f32 layers in two frameworks, logits reach |12| (temperature
    # 0.08), so the confidences agree to ~1e-5 relative (bound: 1e-4)
    np.testing.assert_allclose(dense_out["mconf"], ref["mconf"], rtol=1e-4, atol=1e-6)
    for f in range(len(batch["query_image"])):
        # 2. mutual-NN match set of the streaming (K2) path
        mj, mt = ref["match_mask"][f], out["match_mask"][f]
        set_j = {p: n for n, p in zip(np.nonzero(mj)[0], zip(ref["i_ids"][f][mj], ref["j_ids"][f][mj]))}
        set_t = {p: n for n, p in zip(np.nonzero(mt)[0], zip(out["i_ids"][f][mt], out["j_ids"][f][mt]))}
        common = set(set_j) & set(set_t)
        assert len(set_j) > 0
        assert len(common) / len(set(set_j) | set(set_t)) >= 0.98
        if masked:  # no match lands on a padded cell
            assert all(j < (16 - 2) * 16 for _, j in set_t)
        # 3. fine outputs and confidences on the common matches
        for p in common:
            a, b = set_t[p], set_j[p]
            np.testing.assert_allclose(out["mkpts_query_f"][f, a], ref["mkpts_query_f"][f, b], atol=1e-3)
            np.testing.assert_allclose(out["expec_f"][f, a], ref["expec_f"][f, b], atol=1e-4)
            # exp(2s - rowLSE - colLSE) against softmax * softmax, same bound
            np.testing.assert_allclose(out["mconf"][f, a], ref["mconf"][f, b], rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(out["mkpts_3d"][f, a], ref["mkpts_3d"][f, b], atol=0)


def test_bf16_fine_heatmap_matches_jax():
    """In a bf16 config the fine heatmap (similarity, softmax, expectation and
    std) runs in the windows' dtype, as the JAX model computes it, so expec_f
    comes out in bf16. Dense matching on both sides; on the matches both
    select, expec_f within 5e-2 and mkpts_query_f within 0.3 px (the offset is
    expec_f * 2 * 2 px * query_image_scale <= 2): the two frameworks round
    the bf16 backbone and transformers differently upstream (max 0.031 and
    0.18 px on this input; a bf16 step near 1 is 2^-8)."""
    batch = _forward_inputs(False)
    cfg = dataclasses.replace(
        NARROW, compute_dtype="bfloat16",
        coarse_matching=dataclasses.replace(NARROW.coarse_matching, use_fused_kernel=False))
    jmodel = JaxModel(cfg)
    variables = _perturbed(jax.jit(lambda k, b: jmodel.init(k, b, train=False))(jax.random.PRNGKey(0), batch))
    ref = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(variables, batch)
    ref = {k: np.asarray(v.astype(jnp.float32) if jnp.issubdtype(v.dtype, jnp.floating) else v)
           for k, v in ref.items() if not isinstance(v, tuple)}
    port = OnePosePlusModel(cfg).eval()
    load_jax_variables(port, variables)
    with torch.no_grad():
        out = port({k: torch.from_numpy(v) for k, v in batch.items()})
    assert out["expec_f"].dtype == torch.bfloat16
    out = {k: (v.float() if v.is_floating_point() else v).numpy() for k, v in out.items() if torch.is_tensor(v)}
    n_common = 0
    for f in range(len(batch["query_image"])):
        mj, mt = ref["match_mask"][f], out["match_mask"][f]
        set_j = {p: n for n, p in zip(np.nonzero(mj)[0], zip(ref["i_ids"][f][mj], ref["j_ids"][f][mj]))}
        set_t = {p: n for n, p in zip(np.nonzero(mt)[0], zip(out["i_ids"][f][mt], out["j_ids"][f][mt]))}
        for p in set(set_j) & set(set_t):
            a, b = set_t[p], set_j[p]
            np.testing.assert_allclose(out["expec_f"][f, a], ref["expec_f"][f, b], atol=5e-2)
            np.testing.assert_allclose(out["mkpts_query_f"][f, a], ref["mkpts_query_f"][f, b], atol=0.3)
            n_common += 1
    assert n_common >= 5


def test_full_width_bridge_round_trip():
    """The port's state dict converts strictly onto the full-width JAX tree
    (178 tensors, the reference checkpoint's count) and reproduces every leaf."""
    rng = np.random.default_rng(42)
    batch = {
        "query_image": rng.random((1, 64, 64, 1)).astype(np.float32),
        "keypoints3d": (rng.standard_normal((1, 128, 3)) * 0.1).astype(np.float32),
        "descriptors3d": rng.standard_normal((1, 128, 128)).astype(np.float32),
        "descriptors3d_coarse": rng.standard_normal((1, 128, 256)).astype(np.float32),
    }
    cfg = OnePosePlusConfig(coarse_matching=CoarseMatchingConfig(thr=0.0, max_matches=64))
    init = jax.jit(lambda k, b: JaxModel(cfg).init(k, b, train=False))
    variables = _perturbed(init(jax.random.PRNGKey(0), batch))
    port = OnePosePlusModel(cfg)
    load_jax_variables(port, variables)
    back, report = convert_torch_state_dict(port.state_dict(), variables, strict=True)
    assert report["skipped"] == [] and report["missing"] == []
    assert len(report["converted"]) == 178
    flat_ref = jax.tree_util.tree_leaves_with_path(variables)
    flat_back = dict(jax.tree_util.tree_leaves_with_path({k: back[k] for k in variables}))
    assert len(flat_ref) == len(flat_back) == 178
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf)
