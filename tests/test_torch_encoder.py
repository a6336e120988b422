"""Port parity: kernel K1's plain version and the transformer against the JAX package.

The same numpy inputs and the JAX layer's initial weights (carried across by
``utils.weights.state_dict_from_jax``) go through both packages on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.config import TransformerConfig
from onepose_plus_plus_tpu.models.transformer import (
    LoFTREncoderLayer as JaxLayer,
    LocalFeatureTransformer as JaxTransformer,
)
from onepose_plus_plus_tpu.ops.pallas_encoder import fused_encoder_layer as jax_fused_layer
from onepose_plus_plus_tpu_torch import kernels
from onepose_plus_plus_tpu_torch.models.transformer import (
    LoFTREncoderLayer,
    LocalFeatureTransformer,
)
from onepose_plus_plus_tpu_torch.ops.cuda_encoder import encoder_layer_plain, fused_encoder_layer, k1_instance
from onepose_plus_plus_tpu_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

N, L, S, C, NHEAD = 2, 40, 56, 128, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed, n=N, l=L, s=S, c=C, masks=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, l, c)).astype(np.float32)
    src = rng.standard_normal((n, s, c)).astype(np.float32)
    xm = sm = None
    if masks:
        xm = (rng.random((n, l)) > 0.3).astype(np.float32)
        sm = (rng.random((n, s)) > 0.3).astype(np.float32)
    return x, src, xm, sm


def _jax_layer(x, src, xm, sm, c=C, nhead=NHEAD):
    layer = JaxLayer(c, nhead, "linear", dtype=jnp.float32)
    params = layer.init(jax.random.PRNGKey(0), x, src, xm, sm)["params"]
    return layer, _np(params)


def _kernel_args(p):
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    return [t(p["q_proj"]["kernel"]), t(p["k_proj"]["kernel"]), t(p["v_proj"]["kernel"]),
            t(p["merge"]["kernel"]), t(p["norm1"]["scale"]), t(p["norm1"]["bias"]),
            t(p["mlp_0"]["kernel"]), t(p["mlp_1"]["kernel"]),
            t(p["norm2"]["scale"]), t(p["norm2"]["bias"])]


def _opt(a):
    return None if a is None else torch.from_numpy(a)


def _pallas_layer(x, src, xm, sm, p, nhead=NHEAD):
    """The TPU kernel in interpret mode (bf16 product operands, f32 residual)."""
    return np.asarray(jax_fused_layer(
        x, src, *[p[k]["kernel"] for k in ("q_proj", "k_proj", "v_proj", "merge")],
        p["norm1"]["scale"], p["norm1"]["bias"], p["mlp_0"]["kernel"], p["mlp_1"]["kernel"],
        p["norm2"]["scale"], p["norm2"]["bias"], x_mask=xm, source_mask=sm, nhead=nhead,
        interpret=True,
    ))


@pytest.mark.parametrize("masks", [False, True])
def test_k1_plain_matches_pallas_kernel(masks):
    """K1's plain version in f32 against the TPU kernel in interpret mode (the
    JAX kernel runs its matmuls in bf16: atol 3e-2)."""
    x, src, xm, sm = _inputs(0, masks=masks)
    _, p = _jax_layer(x, src, xm, sm)
    ref = _pallas_layer(x, src, xm, sm, p)
    out = fused_encoder_layer(torch.from_numpy(x), torch.from_numpy(src), *_kernel_args(p),
                              _opt(xm), _opt(sm), nhead=NHEAD)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-2)


@pytest.mark.parametrize("masks", [False, True])
def test_k1_plain_bf16_matches_pallas_kernel(masks):
    """K1's plain version with bf16 product operands against the TPU kernel in
    interpret mode, on f32 inputs: both round the same operands to bf16 and
    keep the residual in f32, so they agree far inside the f32-vs-bf16 bound.
    A bf16 residual would be off by up to half a bf16 ulp of x (~8e-3 here)."""
    x, src, xm, sm = _inputs(0, masks=masks)
    _, p = _jax_layer(x, src, xm, sm)
    ref = _pallas_layer(x, src, xm, sm, p)
    out = fused_encoder_layer(torch.from_numpy(x), torch.from_numpy(src), *_kernel_args(p),
                              _opt(xm), _opt(sm), nhead=NHEAD, dtype=torch.bfloat16)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3)


@pytest.mark.parametrize("masks", [False, True])
def test_k1_plain_matches_xla_layer_f32(masks):
    """K1's plain version against the XLA ``LoFTREncoderLayer`` in f32: atol 1e-5."""
    x, src, xm, sm = _inputs(1, masks=masks)
    layer, p = _jax_layer(x, src, xm, sm)
    ref = layer.apply({"params": p}, x, src, xm, sm)
    out = fused_encoder_layer(torch.from_numpy(x), torch.from_numpy(src), *_kernel_args(p),
                              _opt(xm), _opt(sm), nhead=NHEAD)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("variant", ["float64", "tf32x3"])
def test_k1_plain_f64_and_split_tf32_match_xla_layer_f32(variant, masks):
    """The plain version's two reference modes against the XLA layer in f32 at
    the f32 tolerance (1e-5): every operand, product and sum in float64 (what
    the card's drift tests measure an f32 instance against), and every
    two-operand product in split TF32 (``kernels.tf32x3_matmul``)."""
    x, src, xm, sm = _inputs(10, masks=masks)
    layer, p = _jax_layer(x, src, xm, sm)
    ref = layer.apply({"params": p}, x, src, xm, sm)
    extra = {"dtype": torch.float64} if variant == "float64" else {"matmul": kernels.tf32x3_matmul}
    out = encoder_layer_plain(torch.from_numpy(x), torch.from_numpy(src), *_kernel_args(p), _opt(xm), _opt(sm),
                              nhead=NHEAD, **extra)
    assert out.dtype == (torch.float64 if variant == "float64" else torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("masks", [False, True])
def test_eager_layer_matches_xla_layer_f32(masks):
    x, src, xm, sm = _inputs(2, masks=masks)
    layer, p = _jax_layer(x, src, xm, sm)
    ref = layer.apply({"params": p}, x, src, xm, sm)
    port = LoFTREncoderLayer(C, NHEAD)
    port.load_state_dict(state_dict_from_jax({"params": p}))
    out = port(torch.from_numpy(x), torch.from_numpy(src), _opt(xm), _opt(sm))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)


def test_full_attention_layer_matches_xla():
    x, src, xm, sm = _inputs(5, masks=True)
    layer = JaxLayer(C, NHEAD, "full", dtype=jnp.float32)
    p = _np(layer.init(jax.random.PRNGKey(0), x, src, xm, sm)["params"])
    ref = layer.apply({"params": p}, x, src, xm, sm)
    port = LoFTREncoderLayer(C, NHEAD, "full")
    port.load_state_dict(state_dict_from_jax({"params": p}))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(src), _opt(xm), _opt(sm))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_length1_source_shortcut():
    """The exact S=1 shortcut matches the JAX layer (which takes it too) and
    the port's general path on a duplicated source token (linear attention is
    unchanged by the duplicate: KV and the normaliser both double)."""
    x, src, _, _ = _inputs(3, n=3, l=25, s=1)
    layer, p = _jax_layer(x, src, None, None)
    ref = layer.apply({"params": p}, x, src)
    port = LoFTREncoderLayer(C, NHEAD)
    port.load_state_dict(state_dict_from_jax({"params": p}))
    xt, st = torch.from_numpy(x), torch.from_numpy(src)
    with torch.no_grad():
        short = port(xt, st)
        general = port(xt, torch.cat([st, st], dim=1))
    np.testing.assert_allclose(short.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(short.numpy(), general.numpy(), atol=1e-4)


@pytest.mark.parametrize("l0,l1,routed_to_k1", [(300, 280, True), (40, 25, False)])
def test_local_feature_transformer(l0, l1, routed_to_k1):
    """One self + cross iteration; sequences of 256+ tokens take K1 (plain on
    the CPU) and short ones the eager layer, against the XLA transformer."""
    cfg = TransformerConfig(d_model=C, nhead=NHEAD, layer_iter_n=1)
    rng = np.random.default_rng(4)
    f0 = rng.standard_normal((2, l0, C)).astype(np.float32)
    f1 = rng.standard_normal((2, l1, C)).astype(np.float32)
    jmodel = JaxTransformer(cfg)
    variables = _np(jmodel.init(jax.random.PRNGKey(0), f0, f1))
    r0, r1 = jmodel.apply(variables, f0, f1)
    port = LocalFeatureTransformer(cfg)
    port.load_state_dict(state_dict_from_jax(variables))
    kernels.reset_launch_counts()
    with torch.no_grad():
        o0, o1 = port(torch.from_numpy(f0), torch.from_numpy(f1))
    assert kernels.launch_counts()["K1_encoder_layer"] == 0  # CPU tensors never launch the kernel
    assert (min(l0, l1) >= 256) == routed_to_k1
    np.testing.assert_allclose(o0.numpy(), np.asarray(r0), atol=1e-4)
    np.testing.assert_allclose(o1.numpy(), np.asarray(r1), atol=1e-4)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 3e-2), (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("c", [384, 512])
def test_k1_plain_matches_pallas_kernel_above_256(c, dtype, atol):
    """At the JAX kernel's widths above 256 (C % 128 == 0, 8 heads), a port
    layer loaded through ``state_dict_from_jax`` runs K1 (its plain version on
    the CPU) and agrees with the TPU kernel in interpret mode, which rounds its
    product operands to bf16: the f32 operands to 3e-2, bf16 operands (the same
    rounding) to 2e-3."""
    x, src, xm, sm = _inputs(6, l=24, s=40, c=c, masks=True)
    _, p = _jax_layer(x, src, xm, sm, c=c)
    ref = _pallas_layer(x, src, xm, sm, p)
    port = LoFTREncoderLayer(c, NHEAD, dtype=dtype).eval()
    port.load_state_dict(state_dict_from_jax({"params": p}))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(src), _opt(xm), _opt(sm), fused=True)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=atol)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 3e-2), (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("c,nhead", [(640, 8), (768, 8), (512, 1)])
def test_k1_plain_matches_pallas_kernel_above_512_and_wide_heads(c, nhead, dtype, atol):
    """Widths above 512 and a head as wide as the layer, which the JAX kernel
    takes and K1 runs (f32 operands on its split-TF32 chain, bf16 operands on
    its bf16 chain): the port's layer through K1
    (its plain version on the CPU) agrees with the TPU kernel in interpret
    mode, at the tolerances of the widths up to 512."""
    x, src, xm, sm = _inputs(7, n=1, l=12, s=20, c=c, masks=True)
    _, p = _jax_layer(x, src, xm, sm, c=c, nhead=nhead)
    ref = _pallas_layer(x, src, xm, sm, p, nhead=nhead)
    port = LoFTREncoderLayer(c, nhead, dtype=dtype).eval()
    port.load_state_dict(state_dict_from_jax({"params": p}))
    assert k1_instance(c, nhead, dtype) == ("tcw" if dtype == torch.bfloat16 else "tcw_tf32")
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(src), _opt(xm), _opt(sm), fused=True)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=atol)


@pytest.mark.parametrize("c,nhead", [(384, 16), (128, 16)])
def test_k1_plain_bf16_matches_pallas_kernel_at_narrow_heads(c, nhead):
    """Head widths 24 and 8, the JAX kernel's own widths that bf16 operands now
    run on K1's tensor-core chain (16 heads a 128-column attention block): the
    port's layer through K1 (its plain version on the CPU) with bf16 operands
    against the TPU kernel in interpret mode, which rounds the same operands
    at the same points: 2e-3, as at the other widths, but in a row where an f32
    sum taken in another order puts a rounded operand on the neighbouring bf16
    value (one row of 24 at (384, 16) here, 4.9e-3 off, which the LayerNorms
    carry along the row; the other rows agree to 1e-6): at most one such row,
    within 5e-3, and a mean within 1e-4."""
    x, src, xm, sm = _inputs(11, n=1, l=24, s=40, c=c, masks=True)
    _, p = _jax_layer(x, src, xm, sm, c=c, nhead=nhead)
    ref = _pallas_layer(x, src, xm, sm, p, nhead=nhead)
    port = LoFTREncoderLayer(c, nhead, dtype=torch.bfloat16).eval()
    port.load_state_dict(state_dict_from_jax({"params": p}))
    assert k1_instance(c, nhead, torch.bfloat16) == "tcw"
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(src), _opt(xm), _opt(sm), fused=True)
    assert out.dtype == torch.float32
    d = np.abs(out.numpy() - ref)
    assert (d.max(axis=-1) > 2e-3).sum() <= 1 and d.max() <= 5e-3 and d.mean() <= 1e-4, (d.max(), d.mean())


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("c,nhead", [(64, 8), (96, 8), (32, 8)])
def test_k1_plain_matches_xla_layer_f32_below_128(c, nhead, masks):
    """Widths no JAX kernel takes (C below 128; head widths 8, 12 and 4), which
    both operand types run on K1's tensor-core chains with C padded to 64
    channels: the port's layer through K1 (its plain version on the CPU)
    against the XLA ``LoFTREncoderLayer`` in f32 at the f32 tolerance (1e-5)."""
    x, src, xm, sm = _inputs(12, n=2, l=30, s=44, c=c, masks=masks)
    layer, p = _jax_layer(x, src, xm, sm, c=c, nhead=nhead)
    ref = layer.apply({"params": p}, x, src, xm, sm)
    port = LoFTREncoderLayer(c, nhead, dtype=torch.float32).eval()
    port.load_state_dict(state_dict_from_jax({"params": p}))
    assert k1_instance(c, nhead, torch.float32) == "tcw_tf32" and k1_instance(c, nhead, torch.bfloat16) == "tcw"
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(src), _opt(xm), _opt(sm), fused=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("c,nhead", [(384, 16), (128, 16)])
def test_k1_plain_matches_xla_layer_f32_at_narrow_heads(c, nhead, masks):
    """Head widths 24 and 8 (32-channel chunks straddled; 16 heads a 128-column
    block), which f32 operands run on K1's split-TF32 chain: the port's
    layer through K1 (its plain version on the CPU) against the XLA
    ``LoFTREncoderLayer`` in f32 at the f32 tolerance (1e-5)."""
    x, src, xm, sm = _inputs(8, n=1, l=30, s=44, c=c, masks=masks)
    layer, p = _jax_layer(x, src, xm, sm, c=c, nhead=nhead)
    ref = layer.apply({"params": p}, x, src, xm, sm)
    port = LoFTREncoderLayer(c, nhead, dtype=torch.float32).eval()
    port.load_state_dict(state_dict_from_jax({"params": p}))
    assert k1_instance(c, nhead, torch.float32) == "tcw_tf32"
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(src), _opt(xm), _opt(sm), fused=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("c,nhead", [(384, 16), (128, 16)])
def test_k1_plain_matches_pallas_kernel_at_narrow_heads_f32(c, nhead):
    """The same widths against the TPU kernel in interpret mode, which rounds
    its product operands to bf16: f32 operands to 3e-2, as at the other widths."""
    x, src, xm, sm = _inputs(9, n=1, l=24, s=40, c=c, masks=True)
    _, p = _jax_layer(x, src, xm, sm, c=c, nhead=nhead)
    ref = _pallas_layer(x, src, xm, sm, p, nhead=nhead)
    port = LoFTREncoderLayer(c, nhead, dtype=torch.float32).eval()
    port.load_state_dict(state_dict_from_jax({"params": p}))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(src), _opt(xm), _opt(sm), fused=True)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-2)
