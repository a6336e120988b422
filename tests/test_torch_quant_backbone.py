"""Port parity: the dynamically quantized int8 backbone (``quant_int8``).

Each quantized conv on identical inputs equals the JAX package's
``_quant_conv`` to the bit: the int8 operands, the scales, the int32
accumulators and the output, as JAX runs the function op by op. (Under
``jax.jit`` XLA turns the weight scale's ``/ 127.0`` into a product by the
reciprocal, one ulp off the written division on some channels; the port keeps
the division.) The port's direct 7x7/2 stem gives the same integers as JAX's
space-to-depth stem, so its quantized output is bitwise the same too.

Whole backbones cannot agree to the bit: one ulp upstream of a quantizer (a
BatchNorm, an f32 conv, the upsample) flips a rounding at .5, and the changed
int8 value moves every sum that reads it, so after a few layers nearly every
element differs a little. At full width on two textured 64^2 frames, 97-99 %
of the port's elements differ from JAX's quantized backbone by more than 1e-4
of the map's largest value, while the difference is 1.2 % (coarse) and 1.9 %
(fine) of the map in norm, below the quantization error itself (2.3 %, 2.8 %
against the float backbone). So the whole backbone is held to cosine > 0.999
and relative error < 0.04 against JAX's quantized backbone, and to JAX's own
bounds against the float one (cosine > 0.995, relative error < 0.12,
``tests/test_quant_backbone.py:39-46``). In train mode nothing is quantized:
the forward equals the float backbone's to the bit and has gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from onepose_plus_plus_tpu.config import ResNetFPNConfig as JaxBackboneConfig
from onepose_plus_plus_tpu.models.backbone import ResNetFPN_8_2 as JaxBackbone, _StemConv, _quant_conv
from onepose_plus_plus_tpu_torch.config import ResNetFPNConfig
from onepose_plus_plus_tpu_torch.models.backbone import ResNetFPN_8_2, _Conv
from onepose_plus_plus_tpu_torch.ops import quant
from onepose_plus_plus_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from port_helpers import perturbed, textured

torch.set_num_threads(2)


def _jax_quantized(x, w, stride, pad):
    """The JAX package's quantization steps (``_quant_conv`` :120-137), op by
    op: (wq, sw, xq, sx, int32 accumulators)."""
    sw = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)) / 127.0, 1e-12)
    wq = jnp.clip(jnp.round(w / sw), -127, 127).astype(jnp.int8)
    sx = jnp.maximum(jnp.max(jnp.abs(x)).astype(jnp.float32) / 127.0, 1e-12)
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8)
    dn = lax.conv_dimension_numbers(xq.shape, wq.shape, ("NHWC", "HWIO", "NHWC"))
    acc = lax.conv_general_dilated(xq.astype(jnp.int32), wq.astype(jnp.int32), (stride, stride),
                                   [(pad, pad)] * 2, dimension_numbers=dn,
                                   preferred_element_type=jnp.int32)
    return [np.asarray(a) for a in (wq, sw, xq, sx, acc)]


# (frames, size, cin, cout, kernel, stride, pad, dtype)
CONVS = {
    "3x3": (2, 16, 32, 48, 3, 1, 1, "float32"),
    "3x3-s2-196ch": (2, 12, 196, 196, 3, 2, 1, "float32"),  # K = 1764, N = 196: both padded to 8
    "1x1-s2-downsample": (2, 16, 24, 40, 1, 2, 0, "float32"),
    "3x3-valid": (3, 9, 48, 32, 3, 1, 0, "float32"),  # the sparse path's patches
    "3x3-bf16": (2, 16, 32, 48, 3, 1, 1, "bfloat16"),
    "16-rows": (1, 4, 16, 8, 3, 1, 1, "float32"),  # _int_mm takes more than 16 rows: padded
}


@pytest.mark.parametrize("case", list(CONVS))
def test_quantized_conv_matches_jax_bitwise(case, monkeypatch):
    n, size, cin, cout, kernel, stride, pad, dtype = CONVS[case]
    rng = np.random.default_rng(len(case))
    x = (rng.standard_normal((n, size, size, cin)) * 1.7).astype(np.float32)
    w = (rng.standard_normal((kernel, kernel, cin, cout)) * 0.1).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-12 floor
    jx = jnp.asarray(x, getattr(jnp, dtype))
    wq, sw, xq, sx, acc = _jax_quantized(jx, jnp.asarray(w), stride, pad)
    want = np.asarray(_quant_conv(jx, jnp.asarray(w), stride, pad, getattr(jnp, dtype)).astype(jnp.float32))

    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    tw = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    twq, tsw = quant.quantize_weight(tw)
    txq, tsx = quant.quantize_activation(tx)
    np.testing.assert_array_equal(twq.permute(2, 3, 1, 0).numpy(), wq)
    np.testing.assert_array_equal(tsw.numpy(), sw)
    np.testing.assert_array_equal(txq.permute(0, 2, 3, 1).numpy(), xq)
    assert tsx.item() == sx
    monkeypatch.setattr(quant, "CHUNK_BYTES", 1)  # one frame an _int_mm call
    tacc = quant.int8_conv_accumulate(txq, twq, stride, pad)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.permute(0, 2, 3, 1).numpy(), acc)
    out = quant.quant_conv(tx, tw, stride, pad)
    assert out.dtype == tx.dtype
    np.testing.assert_array_equal(out.float().permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("size", [(32, 48), (31, 33)])
def test_int8_stem_direct_equals_space_to_depth_bitwise(size):
    """JAX quantizes the scattered 4x4x4 kernel of its space-to-depth stem on
    even sizes (the direct conv on odd ones); the scatter is injective, so
    max|kernel| and max|x| per channel, and with them every int32 sum, equal
    the port's direct 7x7/2 conv's."""
    rng = np.random.default_rng(3)
    img = rng.random((2, *size, 1)).astype(np.float32)
    stem = _StemConv(16, quant=True, s2d=True)
    params = stem.init(jax.random.PRNGKey(2), img)
    want = np.asarray(stem.apply(params, img))
    port = _Conv(1, 16, 7, 2, padding=3, quant=True).eval()
    port.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def full_width():
    """Full-width JAX backbone variables (perturbed BatchNorm), two textured
    64^2 frames, JAX's float and quantized outputs, the port's quantized and
    float backbones on those weights."""
    x = textured(np.random.default_rng(0), 2, 64)
    ref = JaxBackbone(JaxBackboneConfig())
    variables = perturbed(jax.jit(ref.init)(jax.random.PRNGKey(0), x))
    jq = JaxBackbone(JaxBackboneConfig(quant_int8=True))
    outs = {"jax_float": jax.jit(ref.apply)(variables, x), "jax_quant": jax.jit(jq.apply)(variables, x)}
    for name, q in (("port_quant", True), ("port_float", False)):
        port = ResNetFPN_8_2(ResNetFPNConfig(quant_int8=q)).eval()
        load_jax_variables(port, variables)
        with torch.no_grad():
            outs[name] = port(torch.from_numpy(x))
    return {k: [np.asarray(t, np.float64).reshape(-1) for t in v] for k, v in outs.items()}


def _cos_rel(got, want):
    return got @ want / (np.linalg.norm(got) * np.linalg.norm(want)), np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("level", [0, 1], ids=["coarse", "fine"])
def test_quantized_backbone_matches_jax_quantized_backbone(full_width, level):
    got, want = full_width["port_quant"][level], full_width["jax_quant"][level]
    cos, rel = _cos_rel(got, want)
    assert cos > 0.999 and rel < 0.04, (cos, rel)
    # the share of elements off by more than 1e-4 of the map's largest value
    # (97-99 %: see the module docstring); the port is no farther from JAX's
    # quantized backbone than that is from the float one
    _, rel_quant = _cos_rel(full_width["jax_quant"][level], full_width["jax_float"][level])
    assert rel < rel_quant


@pytest.mark.parametrize("level", [0, 1], ids=["coarse", "fine"])
def test_quantized_backbone_within_jax_bounds_of_float(full_width, level):
    for quantized, float_ in (("port_quant", "port_float"), ("port_quant", "jax_float")):
        cos, rel = _cos_rel(full_width[quantized][level], full_width[float_][level])
        assert cos > 0.995 and rel < 0.12, (quantized, float_, cos, rel)


def test_quantized_conv_placement_and_train_mode_is_float():
    """The convs JAX quantizes, and no others; in train mode the quantized
    backbone is the float backbone, bit for bit, with gradients."""
    cfg = ResNetFPNConfig(initial_dim=16, block_dims=(16, 24, 32))
    q = ResNetFPN_8_2(ResNetFPNConfig(initial_dim=16, block_dims=(16, 24, 32), quant_int8=True))
    f = ResNetFPN_8_2(cfg)
    q.load_state_dict(f.state_dict())
    quantized = sorted(n for n, m in q.named_modules() if isinstance(m, _Conv) and m.quant)
    floats = sorted(n for n, m in q.named_modules() if isinstance(m, _Conv) and not m.quant)
    assert floats == ["layer1_outconv2.3", "layer2_outconv2.3", "layer3_outconv"]
    blocks = [f"layer{i}.{j}.{c}" for i in (1, 2, 3) for j in (0, 1) for c in ("conv1", "conv2")]
    assert quantized == sorted(["conv1", "layer1_outconv", "layer1_outconv2.0", "layer2_outconv",
                                "layer2_outconv2.0", "layer2.0.downsample.0", "layer3.0.downsample.0",
                                *blocks])
    x = torch.from_numpy(textured(np.random.default_rng(1), 1, 32))
    q.train(), f.train()
    cq, fq = q(x)
    cf, ff = f(x)
    assert torch.equal(cq, cf) and torch.equal(fq, ff)
    (cq.square().sum() + fq.square().sum()).backward()
    gnorm = sum(p.grad.abs().sum().item() for p in q.parameters() if p.grad is not None)
    assert np.isfinite(gnorm) and gnorm > 0
    for name, buf in q.state_dict().items():  # both updated the same running statistics
        assert torch.equal(buf, f.state_dict()[name]), name


def test_matchers_build_and_run_with_quant_int8():
    """``OnePosePlusModel`` against the JAX model, both with ``quant_int8``, on
    the same weights (narrow widths, dense matching, thr 0): the dual-softmax
    confidences within 5 % in norm (measured 0.9 %: the quantized backbones
    differ as the module docstring says) and the mutual matches mostly the same
    (all 9 of 9 here). ``LoFTRMatcher`` builds with ``quant_int8`` and
    matches a shifted pair through its quantized backbone."""
    from onepose_plus_plus_tpu.config import (
        CoarseMatchingConfig, FineConfig, KeypointEncodingConfig, LoFTRConfig, OnePosePlusConfig,
        TransformerConfig)
    from onepose_plus_plus_tpu.models.onepose_plus import OnePosePlusModel as JaxModel
    from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher
    from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel
    from port_helpers import to_port_config

    narrow = JaxBackboneConfig(initial_dim=32, block_dims=(32, 48, 64), quant_int8=True)
    cfg = OnePosePlusConfig(
        backbone=narrow, keypoints_encoding=KeypointEncodingConfig(descriptor_dim=64),
        coarse=TransformerConfig(d_model=64, nhead=8, layer_iter_n=3),
        coarse_matching=CoarseMatchingConfig(thr=0.0, max_matches=256, use_fused_kernel=False),
        fine=FineConfig(d_model=32, transformer=TransformerConfig(d_model=32, nhead=8, layer_iter_n=1)))
    rng = np.random.default_rng(4)
    batch = {
        "query_image": textured(rng, 2, 128),
        "keypoints3d": rng.uniform(-0.3, 0.3, (2, 256, 3)).astype(np.float32),
        "descriptors3d": rng.standard_normal((2, 256, 32)).astype(np.float32),
        "descriptors3d_coarse": rng.standard_normal((2, 256, 64)).astype(np.float32),
    }
    jm = JaxModel(cfg)
    variables = perturbed(jax.jit(lambda k, b: jm.init(k, b, train=False))(jax.random.PRNGKey(0), batch))
    ref = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, batch)
    port = OnePosePlusModel(to_port_config(cfg)).eval()
    load_jax_variables(port, variables)
    assert port.backbone.conv1.quant
    with torch.no_grad():
        out = port({k: torch.from_numpy(v) for k, v in batch.items()})
    conf, want = out["conf_matrix"].numpy(), np.asarray(ref["conf_matrix"])
    assert np.linalg.norm(conf - want) < 0.05 * np.linalg.norm(want)
    sets = []
    for o in ({k: np.asarray(v) for k, v in ref.items() if k in ("i_ids", "j_ids", "match_mask")},
              {k: out[k].numpy() for k in ("i_ids", "j_ids", "match_mask")}):
        sets.append({(f, i, j) for f in range(2)
                     for i, j in zip(o["i_ids"][f][o["match_mask"][f]], o["j_ids"][f][o["match_mask"][f]])})
    assert sets[0] and len(sets[0] & sets[1]) >= 0.75 * len(sets[0] | sets[1])
    assert bool(torch.isfinite(out["mkpts_query_f"]).all())

    loftr_cfg = LoFTRConfig(
        backbone=narrow, coarse=TransformerConfig(d_model=64, nhead=8, layer_iter_n=2),
        coarse_matching=CoarseMatchingConfig(thr=1e-4, temperature=0.1, border_rm=2, border_two_sided=True,
                                             max_matches=64),
        fine=TransformerConfig(d_model=32, nhead=8, layer_iter_n=1))
    loftr = LoFTRMatcher(to_port_config(loftr_cfg)).eval()
    assert loftr.backbone.layer1[0].conv1.quant
    img0 = torch.from_numpy(textured(rng, 1, 128))
    with torch.no_grad():
        res = loftr.match(img0, torch.roll(img0, (8, 16), dims=(1, 2)))
    assert bool(res["match_mask"].any()) and bool(torch.isfinite(res["mkpts1_f"]).all())
