"""Port parity: kernel K7's plain version and its fine-transformer harness.

K7 is the encoder layer over many short sequences
(``experiments/pallas_short_encoder.py::fused_short_encoder_layer``). The TPU
kernel runs in interpret mode, loaded through
``port_helpers.load_short_encoder_experiment`` (the file does not import as
it stands). The same numpy inputs and the JAX layer's initial weights go
through both packages on the CPU, at the four (L, S) shapes of the fine
transformer and an M that is not a multiple of 8.
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
from onepose_plus_plus_tpu_torch import kernels
from onepose_plus_plus_tpu_torch.models.transformer import LocalFeatureTransformer
from onepose_plus_plus_tpu_torch.ops.cuda_short_encoder import (
    fine_transformer_short,
    fused_short_encoder_layer,
    short_encoder_layer_plain,
)
from onepose_plus_plus_tpu_torch.utils.weights import state_dict_from_jax
from port_helpers import load_short_encoder_experiment

torch.set_num_threads(2)

M, C, NHEAD = 13, 128, 8  # the TPU kernel takes C = 128 only; M pads to its 8-sequence blocks
SHAPES = [(1, 1), (25, 25), (1, 25), (25, 1)]  # (L, S) of the fine transformer's four layers


def _inputs(seed, l, s, m=M):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, l, C)).astype(np.float32),
            rng.standard_normal((m, s, C)).astype(np.float32))


def _params(x, src):
    layer = JaxLayer(C, NHEAD, "linear", dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, layer.init(jax.random.PRNGKey(0), x, src)["params"])
    return layer, params


def _weights(p):
    """The layer's weights in K7's argument order ([in, out] layout)."""
    return [p["q_proj"]["kernel"], p["k_proj"]["kernel"], p["v_proj"]["kernel"], p["merge"]["kernel"],
            p["norm1"]["scale"], p["norm1"]["bias"], p["mlp_0"]["kernel"], p["mlp_1"]["kernel"],
            p["norm2"]["scale"], p["norm2"]["bias"]]


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("l,s", SHAPES)
def test_k7_plain_bf16_matches_pallas_kernel(l, s):
    """bf16 product operands, f32 residual, as the TPU kernel in interpret mode:
    both round the same values, so most sequences agree to f32 rounding
    (~1e-6). Where an f32 sum taken in another order rounds to the neighbouring
    bf16 value, that sequence's rows move by up to ~1e-2 (a rounded score A of
    ~50 has a bf16 step of 0.25): max 2e-2. The mean, 1e-5 to 2e-4 here, stays
    under 5e-4; leaving any one of the rounded operands unrounded gives a mean
    of 1.4e-3 to 2.7e-3, and the f32 layer 3.4e-3."""
    x, src = _inputs(l * 100 + s, l, s)
    _, p = _params(x, src)
    ref = np.asarray(load_short_encoder_experiment().fused_short_encoder_layer(
        x, src, *_weights(p), nhead=NHEAD, interpret=True))
    out = short_encoder_layer_plain(*_t([x, src, *_weights(p)]), nhead=NHEAD, dtype=torch.bfloat16)
    assert out.shape == (M, l, C) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2)
    assert np.abs(out.numpy() - ref).mean() < 5e-4


@pytest.mark.parametrize("l,s", SHAPES)
def test_k7_plain_f32_matches_eager_jax_layer(l, s):
    """In f32 the quadratic form equals the JAX package's linear-attention
    layer by associativity (its exact S = 1 shortcut included: the kernel's
    v * a / (a + 1e-6) is v to ~1e-7 relative): atol 1e-5."""
    x, src = _inputs(7 + l + s, l, s)
    layer, p = _params(x, src)
    ref = np.asarray(layer.apply({"params": p}, x, src))
    out = short_encoder_layer_plain(*_t([x, src, *_weights(p)]), nhead=NHEAD)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_wrapper_on_cpu_tensors_runs_the_plain_version():
    x, src = _inputs(3, 25, 1)
    _, p = _params(x, src)
    args = _t([x, src, *_weights(p)])
    kernels.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        got = fused_short_encoder_layer(*args, nhead=NHEAD, dtype=dtype)
        torch.testing.assert_close(got, short_encoder_layer_plain(*args, nhead=NHEAD, dtype=dtype),
                                   rtol=0, atol=0)
    # the default operand type follows x: bf16 x means bf16 operands
    bx = [args[0].to(torch.bfloat16), args[1].to(torch.bfloat16), *args[2:]]
    torch.testing.assert_close(fused_short_encoder_layer(*bx, nhead=NHEAD),
                               short_encoder_layer_plain(*bx, nhead=NHEAD, dtype=torch.bfloat16))
    assert kernels.launch_counts()["K7_short_encoder"] == 0  # CPU tensors never launch the kernel
    with pytest.raises(ValueError):
        fused_short_encoder_layer(*args, nhead=NHEAD, dtype=torch.float16)


def _fine_streams(seed, m=M, w=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, 1, C)).astype(np.float32),
            rng.standard_normal((m, w * w, C)).astype(np.float32))


def test_fine_transformer_short_matches_the_transformers():
    """The harness applies each layer through K7 (plain on the CPU) in the
    self/cross order: equal in f32 to the JAX package's transformer and to the
    port's eager one (the route the query step takes), on the fine stage's
    [M, 1, C] and [M, 25, C] streams, with JAX's weights bridged."""
    cfg = TransformerConfig(d_model=C, nhead=NHEAD, layer_iter_n=1)
    f0, f1 = _fine_streams(11)
    jmodel = JaxTransformer(cfg)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), f0, f1))
    r0, r1 = jmodel.apply(variables, f0, f1)
    port = LocalFeatureTransformer(cfg).eval()
    port.load_state_dict(state_dict_from_jax(variables))
    t0, t1 = torch.from_numpy(f0), torch.from_numpy(f1)
    with torch.no_grad():
        e0, e1 = port(t0, t1)
        k0, k1 = fine_transformer_short(port, t0, t1)
    assert k0.shape == (M, 1, C) and k1.shape == (M, 25, C)
    for got, eager, ref in ((k0, e0, r0), (k1, e1, r1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
        np.testing.assert_allclose(got.numpy(), eager.numpy(), atol=1e-4)


def test_fine_transformer_short_bf16_against_the_eager_bf16_transformer():
    """In a bf16 configuration K7 returns f32 streams and rounds only product
    operands, where the eager layer returns bf16 streams: the two differ by
    bf16 rounding of values up to ~6, not by a bug (atol 0.1, mean 1e-2)."""
    cfg = TransformerConfig(d_model=C, nhead=NHEAD, layer_iter_n=1, compute_dtype="bfloat16")
    f0, f1 = _fine_streams(12)
    port = LocalFeatureTransformer(cfg).eval()
    port.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, JaxTransformer(TransformerConfig(d_model=C, nhead=NHEAD, layer_iter_n=1)).init(
            jax.random.PRNGKey(0), f0, f1))))
    t0, t1 = torch.from_numpy(f0).to(torch.bfloat16), torch.from_numpy(f1).to(torch.bfloat16)
    with torch.no_grad():
        e0, e1 = port(t0, t1)
        k0, k1 = fine_transformer_short(port, t0, t1)
    assert k0.dtype == k1.dtype == torch.float32 and e0.dtype == torch.bfloat16
    for got, eager in ((k0, e0), (k1, e1)):
        d = (got - eager.float()).abs()
        assert d.max().item() < 0.1 and d.mean().item() < 1e-2
