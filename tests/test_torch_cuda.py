"""Kernels K1-K7 on the GPU against their plain PyTorch versions (marker ``cuda``).

These build the kernels with nvcc and launch them, so they run only on a
machine with an NVIDIA Hopper GPU and the CUDA toolkit, and skip elsewhere:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

``chip_smoke.py`` makes the same comparisons at the main path's shapes.
"""
import collections
import re
import time

import pytest
import torch

from onepose_plus_plus_tpu_torch import kernels
from onepose_plus_plus_tpu_torch.ops.cuda_encoder import (
    encoder_layer_plain,
    fused_encoder_layer,
    fused_encoder_layer_packed,
    pack_encoder_weights,
)
from onepose_plus_plus_tpu_torch.ops.cuda_coarse_loss import (
    coarse_focal_sums,
    coarse_focal_sums_plain,
    fused_coarse_focal_loss,
    k5_instance,
)
from onepose_plus_plus_tpu_torch.ops.cuda_gather import (
    scatter_index,
    scatter_index_plain,
    window_gather,
    window_gather_plain,
    window_instance,
    window_scatter,
    window_scatter_plain,
    window_sum_chunks,
)
from onepose_plus_plus_tpu_torch.ops.cuda_matching import (
    dual_softmax_rowcol_stats,
    rowcol_stats_plain,
)
from onepose_plus_plus_tpu_torch.config import ResNetFPNConfig
from onepose_plus_plus_tpu_torch.models.backbone import ResNetFPN_8_2
from onepose_plus_plus_tpu_torch.ops import quant
from onepose_plus_plus_tpu_torch.ops.cuda_patch_gather import patch_gather, patch_gather_centered, patch_gather_plain
from onepose_plus_plus_tpu_torch.ops.cuda_short_encoder import (
    fused_short_encoder_layer,
    fused_short_encoder_layer_packed,
    pack_short_encoder_weights,
    short_encoder_layer_plain,
)
from onepose_plus_plus_tpu_torch.ops.window_gather import gather_windows, gather_windows_aligned
from onepose_plus_plus_tpu_torch.utils.weights import random_state_dict

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpreter mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _k1_args(gen, n, l, s, masks, dtype, c=256):
    rn = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen, device="cuda") * scale)  # noqa: E731
    x = rn(n, l, c)  # f32 streams; dtype is the product operand type
    src = x if s is None else rn(n, s, c)
    w = [rn(c, c, scale=c ** -0.5).to(dtype) for _ in range(4)]
    ln1 = [1 + rn(c, scale=0.1), rn(c, scale=0.1)]
    w0, w1 = rn(2 * c, 2 * c, scale=(2 * c) ** -0.5).to(dtype), rn(2 * c, c, scale=(2 * c) ** -0.5).to(dtype)
    ln2 = [1 + rn(c, scale=0.1), rn(c, scale=0.1)]
    xm = (torch.rand(n, l, generator=gen, device="cuda") > 0.3).float() if masks else None
    sm = (torch.rand(n, src.shape[1], generator=gen, device="cuda") > 0.3).float() if masks else None
    return x, src, (*w, *ln1, w0, w1, *ln2), xm, sm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,s,masks", [
    (300, 450, False), (97, 61, True),  # ragged: neither a multiple of the 64-row tile
    (130, 257, False), (63, 65, True), (64, 128, True), (1, 1, False), (200, None, True),
])
def test_k1_matches_plain(gen, dtype, l, s, masks):
    x, src, w, xm, sm = _k1_args(gen, 2, l, s, masks, dtype)
    before = kernels.launch_counts()["K1_encoder_layer"]
    got = fused_encoder_layer(x, src, *w, xm, sm, nhead=8, dtype=dtype)
    assert kernels.launch_counts()["K1_encoder_layer"] == before + 1
    ref = encoder_layer_plain(x, src, *w, xm, sm, nhead=8, dtype=dtype)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    d = (got - ref).abs()
    if dtype == torch.float32:
        # split TF32 on the tensor cores (~2^-22 relative a product), summed in
        # another order than cuBLAS
        assert d.max().item() < 1e-3
    else:
        # the tensor cores sum a product in another order than the plain
        # version, so an operand that is rounded to bf16 (Q', K', msg, the LN1
        # output, the FFN hidden) can land on the neighbouring bf16 value: a
        # few elements differ by one bf16 step of an O(1) value, the mean stays small
        assert d.max().item() <= 5e-2 and d.mean().item() <= 5e-3


@pytest.mark.parametrize("l,s,masks", [(1000, 1500, False), (777, None, True)])
def test_k1_tensor_core_f32_epilogues_do_not_drift(gen, l, s, masks):
    """The tensor-core instance computes elu+1 through ex2.approx and divides by
    (den + 1e-6) through a reciprocal. Flips between neighbouring bf16 values
    have no sign and cost no accuracy; an epilogue that drifted would show as a
    bias against the plain version, or as a larger distance than the plain
    version's to the same layer with every activation kept in f32."""
    x, src, w, xm, sm = _k1_args(gen, 4, l, s, masks, torch.bfloat16)
    got = fused_encoder_layer(x, src, *w, xm, sm, nhead=8, dtype=torch.bfloat16)
    ref = encoder_layer_plain(x, src, *w, xm, sm, nhead=8, dtype=torch.bfloat16)
    exact = encoder_layer_plain(x, src, *w, xm, sm, nhead=8, dtype=torch.float32)  # bf16-valued weights
    torch.cuda.synchronize()
    bias = (got - ref).mean().item()
    err_kernel, err_plain = (got - exact).abs().mean().item(), (ref - exact).abs().mean().item()
    print(f"K1 bf16 l={l} s={s}: bias {bias:.3e}, mean|kernel - f32| {err_kernel:.4e}, "
          f"mean|plain - f32| {err_plain:.4e}")
    assert abs(bias) <= 5e-6  # the mean |difference| is ~1e-3
    assert err_kernel <= 1.02 * err_plain


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_packed_weights_equal_loose_and_repeat_bitwise(gen, dtype):
    """Packing once gives the same bits as packing at the call, and two launches
    agree bit for bit (the K'^T[V|1] partials are reduced in a fixed order)."""
    x, src, w, xm, sm = _k1_args(gen, 3, 333, 500, True, dtype)
    packed = pack_encoder_weights(*w, nhead=8, dtype=dtype)
    a = fused_encoder_layer_packed(x, src, packed, xm, sm)
    b = fused_encoder_layer_packed(x, src, packed, xm, sm)
    c = fused_encoder_layer(x, src, *w, xm, sm, nhead=8, dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c)


def _names(fn):
    """fn()'s result and the names of the kernels three calls of it launch
    (without namespaces, templates and arguments). A profiler session that
    kept no device event (it keeps only those it maps inside the session) is
    taken again with idle margins around the calls."""
    for margin in (0.0, 0.25, 1.0):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            for _ in range(3):  # the profiler can miss a first launch
                out = fn()
            torch.cuda.synchronize()
            time.sleep(margin)
        events = prof.key_averages()
        if any(e.device_type.name == "CUDA" and e.device_time_total > 0 for e in events):
            break
    names = set()
    for e in events:
        m = re.search(r"(\w+)(?:<[^(]*>)?\(", e.key)
        names.add(m.group(1) if m else e.key)
    return out, names


K1_TC_NAMES = ("kv_partial_tc_kernel", "kv_reduce_tc_kernel", "apply_tc_kernel")


@pytest.mark.parametrize("l,s,masks", [(300, 450, True), (64, None, False)])
def test_k1_f32_runs_the_split_tf32_instance_and_repeats_bitwise(gen, l, s, masks):
    """f32 operands at C = 256 with 8 heads run K1's split-TF32 chain, by name,
    and none of the bf16 kernels; two launches agree bit for bit."""
    x, src, w, xm, sm = _k1_args(gen, 2, l, s, masks, torch.float32)
    packed = pack_encoder_weights(*w, nhead=8, dtype=torch.float32)
    assert packed.instance == "tcw_tf32"
    got, names = _names(lambda: fused_encoder_layer_packed(x, src, packed, xm, sm))
    again = fused_encoder_layer_packed(x, src, packed, xm, sm)
    ref = encoder_layer_plain(x, src, *w, xm, sm, nhead=8)
    torch.cuda.synchronize()
    assert set(K1_TCW32_NAMES) <= names and not set(K1_TC_NAMES + K1_TCW_NAMES) & names, names
    assert not {n for n in names if n.endswith("_tf32x3_kernel")}, names  # K1 has none; K2 does not run here
    assert torch.equal(got, again)
    assert (got - ref).abs().max().item() < 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [384, 512])
def test_k1_runs_the_jax_kernels_widths_above_256(gen, dtype, c):
    """C = 384 and 512 with 8 heads (widths the JAX kernel takes) run K1's
    wide tensor-core instances: split TF32 for f32 operands, bf16 for bf16."""
    x, src, w, xm, sm = _k1_args(gen, 2, 97, 130, True, dtype, c=c)
    assert pack_encoder_weights(*w, nhead=8, dtype=dtype).instance == (
        "tcw" if dtype == torch.bfloat16 else "tcw_tf32")
    before = kernels.launch_counts()["K1_encoder_layer"]
    got = fused_encoder_layer(x, src, *w, xm, sm, nhead=8, dtype=dtype)
    assert kernels.launch_counts()["K1_encoder_layer"] == before + 1
    ref = encoder_layer_plain(x, src, *w, xm, sm, nhead=8, dtype=dtype)
    torch.cuda.synchronize()
    d = (got - ref).abs()
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert d.max().item() < 1e-3
    else:
        assert d.max().item() <= 5e-2 and d.mean().item() <= 5e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,nhead", [(640, 8), (768, 8), (1024, 8), (2048, 16), (512, 1)])
def test_k1_runs_the_jax_kernels_widths_above_512_and_wide_heads(gen, dtype, c, nhead):
    """Above 512 and at a one-head layer, f32 operands run the wide split-TF32
    instance and bf16 operands the wide bf16 one. Ragged rows, masks."""
    x, src, w, xm, sm = _k1_args(gen, 2, 37, 70, True, dtype, c=c)
    assert pack_encoder_weights(*w, nhead=nhead, dtype=dtype).instance == (
        "tcw" if dtype == torch.bfloat16 else "tcw_tf32")
    before = kernels.launch_counts()["K1_encoder_layer"]
    got = fused_encoder_layer(x, src, *w, xm, sm, nhead=nhead, dtype=dtype)
    assert kernels.launch_counts()["K1_encoder_layer"] == before + 1
    ref = encoder_layer_plain(x, src, *w, xm, sm, nhead=nhead, dtype=dtype)
    torch.cuda.synchronize()
    d = (got - ref).abs()
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert d.max().item() < 1e-3
    else:
        assert d.max().item() <= 5e-2 and d.mean().item() <= 5e-3


TCW_WIDTHS = ((128, 8), (256, 4), (384, 8), (512, 8), (512, 1), (640, 8), (768, 8), (1024, 8), (2048, 16),
              (4096, 16), (4096, 32), (128, 16), (384, 16), (4096, 512))  # the JAX kernel's: head widths 8 and 24 too
K1_TCW_NAMES = ("tcw_pack_kernel", "tcw_gemm_kernel", "tcw_kv_reduce_kernel", "tcw_ln_image_kernel",
                "tcw_ln_residual_kernel")


@pytest.mark.parametrize("c,nhead", TCW_WIDTHS)
@pytest.mark.parametrize("l,s,masks", [(97, 61, True), (130, 257, False), (200, None, True), (65, 1100, False)])
def test_k1_tcw_matches_plain_repeats_bitwise_and_launches_its_kernels(gen, c, nhead, l, s, masks):
    """bf16 operands at the wide instance's widths: within the bf16 tolerances of
    the plain version (max 5e-2, mean 5e-3: a rounded operand may land on the
    neighbouring bf16 value), two launches bitwise equal (partials summed in a
    fixed order, no atomics), the instance's kernels by name and none of the
    split-TF32 chain's; ragged rows (neither a multiple of 64), more than one
    16-chunk source group (S = 1100), a self layer (source is x). Head widths
    8 and 24 put up to 16 heads in a 128-column attention block."""
    x, src, w, xm, sm = _k1_args(gen, 2, l, s, masks, torch.bfloat16, c=c)
    packed = pack_encoder_weights(*w, nhead=nhead, dtype=torch.bfloat16)
    assert packed.instance == "tcw"
    before = kernels.launch_counts()["K1_encoder_layer"]
    got = fused_encoder_layer_packed(x, src, packed, xm, sm)
    assert kernels.launch_counts()["K1_encoder_layer"] == before + 1
    again, names = _names(lambda: fused_encoder_layer_packed(x, src, packed, xm, sm))
    ref = encoder_layer_plain(x, src, *w, xm, sm, nhead=nhead, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    d = (got - ref).abs()
    assert d.max().item() <= 5e-2 and d.mean().item() <= 5e-3, (d.max().item(), d.mean().item())
    assert set(K1_TCW_NAMES) <= names and not set(K1_TCW32_NAMES) & names, names


def test_k1_tensor_core_instance_names_its_width(gen):
    """At C = 128 with 8 heads bf16 and f32 operands take the wide tensor-core
    instances; a width no instance takes raises."""
    x, src, w, _, _ = _k1_args(gen, 1, 70, 70, False, torch.bfloat16, c=128)
    for dtype in (torch.bfloat16, torch.float32):
        got = fused_encoder_layer(x, src, *w, nhead=8, dtype=dtype)
        ref = encoder_layer_plain(x, src, *w, nhead=8, dtype=dtype)
        torch.cuda.synchronize()
        d = (got - ref).abs()
        # the kernels sum in another order than the plain version: f32 to 1e-3,
        # bf16 operands may land on the neighbouring bf16 value
        assert d.max().item() < (1e-3 if dtype == torch.float32 else 5e-2) and d.mean().item() <= 5e-3
    x, src, w, _, _ = _k1_args(gen, 1, 70, 70, False, torch.bfloat16, c=48)
    with pytest.raises(ValueError, match="C = 48"):
        fused_encoder_layer(x, src, *w, nhead=8, dtype=torch.bfloat16)


TCW32_WIDTHS = TCW_WIDTHS  # (C, heads) of the split-TF32 chain at the JAX kernel's widths
K1_TCW32_NAMES = ("tcw32_pack_kernel", "tcw32_gemm_kernel", "tcw32_kv_reduce_kernel", "tcw32_ln_image_kernel",
                  "tcw32_ln_residual_kernel")


@pytest.mark.parametrize("c,nhead", TCW32_WIDTHS)
@pytest.mark.parametrize("l,s,masks", [(97, 61, True), (130, 257, False), (200, None, True), (65, 1100, False)])
def test_k1_tcw_tf32_matches_plain_repeats_bitwise_and_launches_its_kernels(gen, c, nhead, l, s, masks):
    """f32 operands at the wide split-TF32 instance's widths: within 1e-3 of the
    plain f32 version (TF32 off), two launches bitwise equal (partials summed in
    a fixed order, no atomics), the instance's kernels by name and none of the
    bf16 chain's; ragged rows, more than one source group (S = 1100), a self
    layer (source is x)."""
    x, src, w, xm, sm = _k1_args(gen, 2, l, s, masks, torch.float32, c=c)
    packed = pack_encoder_weights(*w, nhead=nhead, dtype=torch.float32)
    assert packed.instance == "tcw_tf32"
    before = kernels.launch_counts()["K1_encoder_layer"]
    got = fused_encoder_layer_packed(x, src, packed, xm, sm)
    assert kernels.launch_counts()["K1_encoder_layer"] == before + 1
    again, names = _names(lambda: fused_encoder_layer_packed(x, src, packed, xm, sm))
    ref = encoder_layer_plain(x, src, *w, xm, sm, nhead=nhead, dtype=torch.float32)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    assert (got - ref).abs().max().item() <= 1e-3, (got - ref).abs().max().item()
    assert set(K1_TCW32_NAMES) <= names and not set(K1_TCW_NAMES) & names, names


@pytest.mark.parametrize("c,nhead,l,s,masks", [(512, 8, 1000, 1500, False), (1024, 8, 777, None, True),
                                               (384, 16, 1000, 1500, True), (128, 16, 777, None, False),
                                               (96, 8, 1000, 1500, True), (640, 160, 777, None, False),
                                               (256, 8, 1000, 1500, False), (256, 8, 777, None, True)])
def test_k1_tcw_tf32_epilogues_do_not_drift(gen, c, nhead, l, s, masks):
    """The split-TF32 chain computes elu+1 through ex2.approx and divides by
    (den + 1e-6) through a reciprocal, and drops each product's lo x lo term
    (~2^-22 relative): its mean distance to the layer in float64 stays within
    twice the plain f32 version's. A single TF32 product (10 bits) would miss
    this by orders of magnitude."""
    x, src, w, xm, sm = _k1_args(gen, 4, l, s, masks, torch.float32, c=c)
    got = fused_encoder_layer(x, src, *w, xm, sm, nhead=nhead, dtype=torch.float32)
    ref = encoder_layer_plain(x, src, *w, xm, sm, nhead=nhead, dtype=torch.float32)
    exact = encoder_layer_plain(x, src, *w, xm, sm, nhead=nhead, dtype=torch.float64)
    torch.cuda.synchronize()
    err_kernel, err_plain = (got.double() - exact).abs().mean().item(), (ref.double() - exact).abs().mean().item()
    print(f"K1 tcw_tf32 C={c} heads={nhead} l={l} s={s}: mean|kernel - f64| {err_kernel:.4e}, "
          f"mean|plain - f64| {err_plain:.4e}")
    assert err_kernel <= 2 * err_plain


# (C, heads) outside the JAX kernel's widths: C below 128 or not a multiple of
# 64, head widths 1, 3, 4, 12, 20, 28, 36, 68 and 508 (replicated denominators)
# and 8, 16, 64 (rows of head sums)
K1_NARROW = ((32, 8), (32, 32), (64, 8), (64, 1), (96, 8), (96, 32), (160, 8), (224, 8), (288, 8), (544, 8),
             (640, 160), (4064, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,nhead", K1_NARROW)
@pytest.mark.parametrize("l,s,masks", [(97, 61, True), (200, None, True), (65, 1100, False)])
def test_k1_chains_take_the_narrow_widths(gen, dtype, c, nhead, l, s, masks):
    """The widths the CUDA-core kernels ran until the chains took them: the
    chain of the operand type, within the plain version's tolerances (f32
    1e-3, bf16 max 5e-2 / mean 5e-3), two launches bitwise equal, its own
    kernels by name and none of the other chain's; ragged rows, a self layer,
    more than one source group. C padded to 64 channels, the attention over
    64-column blocks where the head width is not a multiple of 8."""
    x, src, w, xm, sm = _k1_args(gen, 2, l, s, masks, dtype, c=c)
    packed = pack_encoder_weights(*w, nhead=nhead, dtype=dtype)
    bf16 = dtype == torch.bfloat16
    assert packed.instance == ("tcw" if bf16 else "tcw_tf32")
    before = kernels.launch_counts()["K1_encoder_layer"]
    got = fused_encoder_layer_packed(x, src, packed, xm, sm)
    assert kernels.launch_counts()["K1_encoder_layer"] == before + 1
    again, names = _names(lambda: fused_encoder_layer_packed(x, src, packed, xm, sm))
    ref = encoder_layer_plain(x, src, *w, xm, sm, nhead=nhead, dtype=dtype)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    d = (got - ref).abs()
    if bf16:
        assert d.max().item() <= 5e-2 and d.mean().item() <= 5e-3, (d.max().item(), d.mean().item())
    else:
        assert d.max().item() <= 1e-3, d.max().item()
    mine, other = (K1_TCW_NAMES, K1_TCW32_NAMES) if bf16 else (K1_TCW32_NAMES, K1_TCW_NAMES)
    assert set(mine) <= names and not set(other) & names, names


def test_bf16_model_at_d_model_64_runs_k1_on_the_tensor_cores(gen):
    """A bf16 coarse transformer at d_model 64 (the narrow test configurations)
    routes every layer to K1 on the card, through the bf16 chain, and agrees
    with the CPU (plain version)."""
    from onepose_plus_plus_tpu_torch.config import TransformerConfig
    from onepose_plus_plus_tpu_torch.models.transformer import LocalFeatureTransformer

    torch.manual_seed(0)
    cfg = TransformerConfig(d_model=64, nhead=8, compute_dtype="bfloat16", layer_iter_n=2)
    model = LocalFeatureTransformer(cfg).eval()
    f0 = torch.randn(2, 300, 64, generator=gen, device="cuda")
    f1 = torch.randn(2, 260, 64, generator=gen, device="cuda")
    before = kernels.launch_counts()["K1_encoder_layer"]
    with torch.no_grad():
        got = model.cuda()(f0, f1)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["K1_encoder_layer"] == before + 8  # 4 layers, two streams
        assert model.layers[0].packed_weights().instance == "tcw"
        ref = model.cpu()(f0.cpu(), f1.cpu())
    for g, r in zip(got, ref):
        d = (g.cpu() - r).abs()
        assert bool(torch.isfinite(g).all()) and d.max().item() <= 5e-2 and d.mean().item() <= 5e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain(gen, dtype):
    f0 = torch.randn(2, 333, 64, generator=gen, device="cuda")
    f1 = torch.randn(2, 200, 64, generator=gen, device="cuda")
    col_add = torch.where(torch.rand(2, 200, generator=gen, device="cuda") > 0.1, 0.0, -1e9)
    got = dual_softmax_rowcol_stats(f0, f1, 0.08, col_add=col_add, dtype=dtype)
    ref = rowcol_stats_plain((f0 / 8).to(dtype), (f1 / 8).to(dtype), 1 / (0.08 + 1e-4), None, col_add)
    torch.cuda.synchronize()
    for k in ("row_lse", "col_lse", "row_best_val", "col_best_val"):
        assert (got[k] - ref[k]).abs().max().item() < 1e-3, k
    for k in ("row_best_j", "col_best_p"):
        assert (got[k] == ref[k]).float().mean().item() >= 0.999, k


@pytest.mark.parametrize("b,p,l,c", [
    (2, 333, 200, 32), (2, 333, 200, 64), (2, 333, 200, 256), (1, 7000, 4096, 64),
    (1, 7000, 4096, 256), (1, 333, 4096, 96),
])
def test_k2_bf16_tensor_cores_match_plain_and_repeat_bitwise(gen, b, p, l, c):
    """K2's tensor-core instance at ragged shapes (P and L not multiples of the
    64-row tile, C padded to 16 channels), with a column mask: LSEs within
    1e-3 of the plain bf16 version, argmaxes agreeing on >= 99.9 %, two launches
    equal bit for bit (column partials merged in order, no atomics)."""
    f0 = torch.randn(b, p, c, generator=gen, device="cuda")
    f1 = torch.randn(b, l, c, generator=gen, device="cuda")
    col_add = torch.where(torch.rand(b, l, generator=gen, device="cuda") > 0.1, 0.0, -1e9)
    before = kernels.launch_counts()["K2_rowcol_stats"]
    got = dual_softmax_rowcol_stats(f0, f1, 0.08, col_add=col_add, dtype=torch.bfloat16)
    again = dual_softmax_rowcol_stats(f0, f1, 0.08, col_add=col_add, dtype=torch.bfloat16)
    assert kernels.launch_counts()["K2_rowcol_stats"] == before + 2
    scale = c ** -0.5
    ref = rowcol_stats_plain((f0 * scale).to(torch.bfloat16), (f1 * scale).to(torch.bfloat16),
                             1 / (0.08 + 1e-4), None, col_add)
    torch.cuda.synchronize()
    for k in got:
        assert torch.equal(got[k], again[k]), k
    for k in ("row_lse", "col_lse", "row_best_val", "col_best_val"):
        assert (got[k] - ref[k]).abs().max().item() < 1e-3, k
    for k in ("row_best_j", "col_best_p"):
        assert (got[k] == ref[k]).float().mean().item() >= 0.999, k


@pytest.mark.parametrize("b,p,l,c", [
    (2, 333, 200, 32), (2, 333, 200, 64), (2, 333, 200, 256), (1, 7000, 4096, 256),
    (1, 333, 4096, 96), (2, 130, 70, 576),
])
def test_k2_f32_split_tf32_matches_plain_and_repeats_bitwise(gen, b, p, l, c):
    """K2's f32 instance on the tensor cores in split TF32 at ragged shapes (P
    and L not multiples of the 64-row tile, C padded to 32 channels, up to the
    widest it takes), with a column mask: LSEs within 1e-3 of the plain f32
    version, argmaxes agreeing on >= 99.9 %, two launches equal bit for bit,
    and its kernels by name, not the CUDA-core tile's."""
    f0 = torch.randn(b, p, c, generator=gen, device="cuda")
    f1 = torch.randn(b, l, c, generator=gen, device="cuda")
    col_add = torch.where(torch.rand(b, l, generator=gen, device="cuda") > 0.1, 0.0, -1e9)
    before = kernels.launch_counts()["K2_rowcol_stats"]
    got, names = _names(lambda: dual_softmax_rowcol_stats(f0, f1, 0.08, col_add=col_add))
    again = dual_softmax_rowcol_stats(f0, f1, 0.08, col_add=col_add)
    assert kernels.launch_counts()["K2_rowcol_stats"] == before + 4
    scale = c ** -0.5
    ref = rowcol_stats_plain(f0 * scale, f1 * scale, 1 / (0.08 + 1e-4), None, col_add)
    torch.cuda.synchronize()
    assert {"pack_tf32_operand_kernel", "lse_tf32x3_kernel", "argmax_tf32x3_kernel"} <= names, names
    assert not {"lse_wide_tf32x3_kernel", "argmax_wide_tf32x3_kernel"} & names, names
    for k in got:
        assert torch.equal(got[k], again[k]), k
    for k in ("row_lse", "col_lse", "row_best_val", "col_best_val"):
        assert (got[k] - ref[k]).abs().max().item() < 1e-3, k
    for k in ("row_best_j", "col_best_p"):
        assert (got[k] == ref[k]).float().mean().item() >= 0.999, k


K2_WIDE_NAMES = {
    torch.bfloat16: {"pack_wide_bf16_kernel", "lse_wide_bf16_kernel", "argmax_wide_bf16_kernel"},
    torch.float32: {"pack_tf32_operand_kernel", "pack_tf32_hilo_kernel", "lse_wide_tf32x3_kernel",
                    "argmax_wide_tf32x3_kernel"},
}
K2_RESIDENT_NAMES = {"lse_tc_kernel", "argmax_tc_kernel", "lse_tf32x3_kernel", "argmax_tf32x3_kernel"}


def _row_lse64(a0, a1, col_add):
    """Row LSE of s = a0 a1^T * inv_temp + col_add in float64 (a0, a1 the
    operands after scaling and rounding)."""
    sim = torch.einsum("bpc,blc->bpl", a0.double(), a1.double()) / (0.08 + 1e-4) + col_add.double()[:, None, :]
    return torch.logsumexp(sim, dim=2)


@pytest.mark.parametrize("b,p,l,c", [(2, 1000, 700, 256), (2, 1000, 700, 576)])
def test_k2_f32_resident_tile_stays_near_float64(gen, b, p, l, c):
    """K2's f32 resident tile (sim_tile_tf32.cuh, up to 576 channels) sums the
    whole k of each split-TF32 product on the tensor cores: its mean row-LSE
    distance to float64 stays within 2x the plain version's (f32 sums of the
    same operands), the bar the wide tile and K1's chain meet."""
    f0 = torch.randn(b, p, c, generator=gen, device="cuda")
    f1 = torch.randn(b, l, c, generator=gen, device="cuda")
    col_add = torch.where(torch.rand(b, l, generator=gen, device="cuda") > 0.1, 0.0, -1e9)
    got, names = _names(lambda: dual_softmax_rowcol_stats(f0, f1, 0.08, col_add=col_add))
    scale = c ** -0.5
    a0, a1 = f0 * scale, f1 * scale
    ref = rowcol_stats_plain(a0, a1, 1 / (0.08 + 1e-4), None, col_add)
    lse64 = _row_lse64(a0, a1, col_add)
    torch.cuda.synchronize()
    assert {"lse_tf32x3_kernel", "argmax_tf32x3_kernel"} <= names, names
    kernel = (got["row_lse"].double() - lse64).abs().mean().item()
    plain = (ref["row_lse"].double() - lse64).abs().mean().item()
    print(f"K2 f32 resident tile at C = {c}: mean |row_lse - float64| kernel {kernel:.3e}, plain {plain:.3e} "
          f"({kernel / plain:.2f}x)")
    assert kernel <= 2 * plain, (kernel, plain)


def test_k2_bf16_wider_than_the_resident_tile_runs_the_wide_instance(gen):
    """bf16 operands wider than the resident tensor-core tile takes (C > 576)
    run the channel-streaming bf16 instance: held to the plain version on the
    same bf16 values, and by the names of the launches."""
    b, p, l, c = 1, 333, 200, 640
    f0 = torch.randn(b, p, c, generator=gen, device="cuda")
    f1 = torch.randn(b, l, c, generator=gen, device="cuda")
    col_add = torch.where(torch.rand(b, l, generator=gen, device="cuda") > 0.1, 0.0, -1e9)
    before = kernels.launch_counts()["K2_rowcol_stats"]
    got, names = _names(lambda: dual_softmax_rowcol_stats(f0, f1, 0.08, col_add=col_add, dtype=torch.bfloat16))
    assert kernels.launch_counts()["K2_rowcol_stats"] == before + 3
    assert K2_WIDE_NAMES[torch.bfloat16] <= names and not K2_RESIDENT_NAMES & names, names
    scale = c ** -0.5
    ref = rowcol_stats_plain((f0 * scale).to(torch.bfloat16), (f1 * scale).to(torch.bfloat16),
                             1 / (0.08 + 1e-4), None, col_add)
    torch.cuda.synchronize()
    for k in ("row_lse", "col_lse", "row_best_val", "col_best_val"):
        assert (got[k] - ref[k]).abs().max().item() < 1e-3, k
    for k in ("row_best_j", "col_best_p"):
        assert (got[k] == ref[k]).float().mean().item() >= 0.999, k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,p,l,c", [
    (2, 333, 200, 577), (2, 333, 200, 640), (2, 333, 200, 1000), (2, 1000, 700, 2048), (1, 333, 200, 4096),
])
def test_k2_wide_instances_match_plain_and_repeat_bitwise(gen, b, p, l, c, dtype):
    """K2 above 576 channels on the channel-streaming tile (sim_tile_wide.cuh)
    at ragged shapes (P not a multiple of the 64-row tile, L of the 128-row
    one, C of 64), with a column mask: LSEs and best values within 1e-3 of the
    plain version on the same values (bf16 values for bf16), argmaxes agreeing
    on >= 99.9 %, two launches equal bit for bit, its kernels by name and no
    resident-tile kernel. At C = 2048 the mean row-LSE distance to float64,
    within 2x the plain version's (f32 sums of the same operands)."""
    f0 = torch.randn(b, p, c, generator=gen, device="cuda")
    f1 = torch.randn(b, l, c, generator=gen, device="cuda")
    col_add = torch.where(torch.rand(b, l, generator=gen, device="cuda") > 0.1, 0.0, -1e9)
    got, names = _names(lambda: dual_softmax_rowcol_stats(f0, f1, 0.08, col_add=col_add, dtype=dtype))
    again = dual_softmax_rowcol_stats(f0, f1, 0.08, col_add=col_add, dtype=dtype)
    scale = c ** -0.5
    a0, a1 = (f0 * scale).to(dtype), (f1 * scale).to(dtype)
    ref = rowcol_stats_plain(a0, a1, 1 / (0.08 + 1e-4), None, col_add)
    torch.cuda.synchronize()
    assert K2_WIDE_NAMES[dtype] <= names and not K2_RESIDENT_NAMES & names, names
    for k in got:
        assert torch.equal(got[k], again[k]), k
    for k in ("row_lse", "col_lse", "row_best_val", "col_best_val"):
        assert (got[k] - ref[k]).abs().max().item() < 1e-3, k
    for k in ("row_best_j", "col_best_p"):
        assert (got[k] == ref[k]).float().mean().item() >= 0.999, k
    if c == 2048:
        lse64 = _row_lse64(a0, a1, col_add)
        kernel = (got["row_lse"].double() - lse64).abs().mean().item()
        plain = (ref["row_lse"].double() - lse64).abs().mean().item()
        print(f"K2 {dtype} at C = {c}: mean |row_lse - float64| kernel {kernel:.3e}, plain {plain:.3e}")
        assert kernel <= 2 * plain, (kernel, plain)


def test_k5_wide_instance_takes_its_lse_from_the_wide_tile(gen):
    """K5 above 576 channels takes its row and column LSEs from K2's wide bf16
    LSE pass over the operands its own passes read (one pack each), and runs
    its loss, g sums and feature gradients on the wide instance's kernels."""
    f0, f1, gt = _k5_inputs(gen, 2, 333, 200, 640)
    assert k5_instance(640) == ("wide", 3)

    def run():
        a0, a1 = f0.clone().requires_grad_(), f1.clone().requires_grad_()
        pos, neg, _ = coarse_focal_sums(a0, a1, gt, 1 / (0.08 + 1e-4), 0.5, 2.0)
        (pos + neg).backward()
        return pos, neg

    _, names = _names(run)
    assert {"pack_wide_bf16_kernel", "lse_wide_bf16_kernel", "col_lse_reduce", "loss_wide_kernel",
            "gsum_wide_kernel", "colg_reduce", "dfeat_wide_kernel"} <= names, names
    assert not {"lse_kernel", "lse_tc_kernel", "loss_tc_kernel", "dfeat_tc_kernel"} & names, names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain(gen, dtype):
    feat = torch.randn(2, 48, 64, 128, generator=gen, device="cuda").to(dtype)
    ids = torch.randint(-5, 12 * 16 + 5, (2, 77), generator=gen, device="cuda")
    got = window_gather(feat, ids, (12, 16), 4, 5)
    torch.cuda.synchronize()
    assert torch.equal(got, window_gather_plain(feat, ids, (12, 16), 4, 5))


@pytest.mark.parametrize("dtype,c,window", [(torch.float32, 128, 5), (torch.bfloat16, 128, 5),
                                            (torch.bfloat16, 96, 5), (torch.float32, 8, 9)])
def test_k3_exact_at_corners_and_ragged_shapes(gen, dtype, c, window):
    """One warp a window: ragged window counts (not a multiple of the block's
    eight), windows at the grid's corners reaching off the map, out-of-range
    ids, a pixel of 12 vectors (division, not a shift) and of 2 (f32, C = 8)."""
    feat = torch.randn(3, 40, 36, c, generator=gen, device="cuda").to(dtype)
    ids = torch.randint(-4, 10 * 9 + 4, (3, 61), generator=gen, device="cuda", dtype=torch.int32)
    ids[:, :4] = torch.tensor([0, 8, 81, 89], dtype=torch.int32)
    before = kernels.launch_counts()["K3_window_gather"]
    got = window_gather(feat, ids, (10, 9), 4, window)
    assert kernels.launch_counts()["K3_window_gather"] == before + 1
    ref = window_gather_plain(feat, ids, (10, 9), 4, window)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert bool((got[:, :4].reshape(3, 4, window, window, c)[:, 0, : window // 2] == 0).all())


def test_wrapper_raises_for_unsupported_operands(gen):
    """Any pixel width runs (f32 C = 3 takes the span instance); a dtype no
    instance takes raises."""
    ids = torch.zeros(1, 2, device="cuda")
    f3 = torch.randn(1, 8, 8, 3, generator=gen, device="cuda")
    assert torch.equal(window_gather(f3, ids, (2, 2), 4, 5), window_gather_plain(f3, ids, (2, 2), 4, 5))
    with pytest.raises(ValueError):
        window_gather(torch.zeros(1, 8, 8, 4, device="cuda", dtype=torch.float16), ids, (2, 2), 4, 5)
    kernels.build()  # the library itself builds from csrc/


# Narrow pixels: (dtype, C, elements the map starts past an alignment). Each runs
# the span instances of K3 and K4; bf16 C = 196 is the sparse FPN's pin map.
NARROW_PIXELS = [
    (torch.bfloat16, 196, 0), (torch.bfloat16, 130, 0), (torch.bfloat16, 33, 0),
    (torch.float32, 130, 0), (torch.float32, 33, 0), (torch.bfloat16, 128, 1),
    (torch.float32, 128, 2), (torch.bfloat16, 1101, 0),
]


def _offset_tensor(gen, shape, dtype, offset):
    n = 1
    for d in shape:
        n *= d
    base = torch.randn(offset + n, generator=gen, device="cuda").to(dtype)
    return base[offset:].view(*shape)


def _device_kernels(fn, calls=3):
    """fn()'s result and the device launches `calls` calls of it make, counted
    by kernel name (idle margins around the calls, so that the profiler keeps
    their launches)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)
        for _ in range(calls):
            out = fn()
        torch.cuda.synchronize()
        time.sleep(0.2)
    counts = collections.Counter()
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            m = re.search(r"(\w+)(?:<[^(]*>)?\(", e.key)
            counts[m.group(1) if m else e.key] += e.count
    return out, dict(counts)


@pytest.mark.parametrize("dtype,c,offset", NARROW_PIXELS)
def test_k3_narrow_vector_instances_match_plain(gen, dtype, c, offset):
    """K3 at a pixel's bytes or a map address that is not a multiple of 16 (a
    pixel of more 2-byte halves than a block has threads among them) runs its
    span instance, one launch a call, and copies exactly: corners,
    out-of-range ids, ragged K."""
    feat = _offset_tensor(gen, (2, 40, 36, c), dtype, offset)
    assert window_instance(c * feat.element_size(), feat.data_ptr()) == "span"
    ids = torch.randint(-4, 10 * 9 + 4, (2, 61), generator=gen, device="cuda", dtype=torch.int32)
    ids[:, :4] = torch.tensor([0, 8, 81, 89], dtype=torch.int32)
    before = kernels.launch_counts()["K3_window_gather"]
    got, launched = _device_kernels(lambda: window_gather(feat, ids, (10, 9), 4, 5))
    assert kernels.launch_counts()["K3_window_gather"] == before + 3
    assert launched == {"window_span_kernel": 3}, launched
    ref = window_gather_plain(feat, ids, (10, 9), 4, 5)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype,c,offset", NARROW_PIXELS)
def test_k4_narrow_vector_instances_match_plain_and_repeat(gen, dtype, c, offset):
    """K4 at the narrow pixels (and on gradients past an alignment): two
    launches a call, the index launch and the span sum; f32 sums in a fixed
    order (duplicates and overlaps add up, out-of-range ids drop out), two
    calls bitwise equal, within the 128-channel case's tolerances of the plain
    version."""
    grad = _offset_tensor(gen, (2, 150, 25, c), dtype, offset)
    ids = torch.randint(-5, 12 * 16 + 5, (2, 150), generator=gen, device="cuda", dtype=torch.int32)
    ids[:, 100:140] = ids[:, :40]  # repeated cells
    before = kernels.launch_counts()["K4_window_scatter"]
    got, launched = _device_kernels(lambda: window_scatter(grad, ids, (12, 16), 4, 5, (48, 64)), calls=2)
    again = window_scatter(grad, ids, (12, 16), 4, 5, (48, 64))
    assert kernels.launch_counts()["K4_window_scatter"] == before + 3
    assert launched == {"scatter_index_kernel": 2, "window_sum_kernel": 2}, launched
    ref = window_scatter_plain(grad, ids, (12, 16), 4, 5, (48, 64))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - ref.float()).abs().max().item() < tol


@pytest.mark.parametrize("dtype,c,offset", [(torch.float32, 128, 0), (torch.bfloat16, 128, 0),
                                            (torch.bfloat16, 33, 1), (torch.float32, 33, 1),
                                            (torch.bfloat16, 196, 0), (torch.float32, 130, 2)])
def test_k4_span_sum_equals_its_cpu_mirror_bitwise(gen, dtype, c, offset):
    """The card's K4 map is, byte for byte, what ``window_sum_chunks`` computes
    on the CPU from the same gradient bytes at the same addresses mod 16 (the
    kernel's f32 order, its funnel shifts and its rounding), ``offset``
    elements past the allocator's alignment."""
    grad = _offset_tensor(gen, (2, 90, 25, c), dtype, offset)
    ids = torch.randint(-5, 12 * 16 + 5, (2, 90), generator=gen, device="cuda", dtype=torch.int32)
    ids[:, 60:80] = ids[:, :20]  # repeated cells
    got = window_scatter(grad, ids, (12, 16), 4, 5, (48, 64))
    base, n_bytes = grad.data_ptr() % 16, grad.numel() * grad.element_size()
    mem = torch.zeros(base + n_bytes + 16, dtype=torch.uint8)
    mem[base:base + n_bytes] = grad.cpu().reshape(-1).view(torch.uint8)
    want, _, _ = window_sum_chunks(mem, base, got.data_ptr() % 16, ids.cpu(), (12, 16), 4, 5, (48, 64), c, dtype)
    assert torch.equal(got.cpu().reshape(-1).view(torch.uint8), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain_and_is_deterministic(gen, dtype):
    """Duplicates, overlapping windows, -1 and out-of-range ids; two launches
    bitwise equal (no atomics)."""
    grad = torch.randn(2, 300, 25, 128, generator=gen, device="cuda").to(dtype)
    ids = torch.randint(-5, 12 * 16 + 5, (2, 300), generator=gen, device="cuda")
    ids[:, 100:140] = ids[:, :40]  # repeated cells
    before = kernels.launch_counts()["K4_window_scatter"]
    got = window_scatter(grad, ids, (12, 16), 4, 5, (48, 64))
    again = window_scatter(grad, ids, (12, 16), 4, 5, (48, 64))
    assert kernels.launch_counts()["K4_window_scatter"] == before + 2
    ref = window_scatter_plain(grad, ids, (12, 16), 4, 5, (48, 64))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    # f32: summation order only; bf16: one rounding of the f32 sum each
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - ref.float()).abs().max().item() < tol
    # an id out of range contributes nothing
    only_bad = torch.full_like(ids, -1)
    only_bad[:, 0] = 12 * 16
    assert not window_scatter(grad, only_bad, (12, 16), 4, 5, (48, 64)).any()


@pytest.mark.parametrize("n,k,n_cells", [(2, 300, 192), (4, 1228, 4096), (3, 37, 16), (2, 5000, 64)])
def test_k4_index_kernel_equals_plain_preparation(gen, n, k, n_cells):
    """order and cell_start of the index launch equal a stable library sort and
    searchsorted exactly: duplicates, negative and out-of-range ids, K not a
    multiple of 32 and above one shared-memory chunk, an empty batch element."""
    ids = torch.randint(-4, n_cells + 4, (n, k), generator=gen, device="cuda", dtype=torch.int32)
    ids[:, k // 2:k // 2 + k // 8] = ids[:, :k // 8]
    ids[-1] = -1
    order, cell_start = scatter_index(ids, n_cells)
    order_ref, cell_start_ref = scatter_index_plain(ids, n_cells)
    torch.cuda.synchronize()
    assert order.dtype == torch.int32 and cell_start.shape == (n, n_cells + 1)
    assert torch.equal(order, order_ref) and torch.equal(cell_start, cell_start_ref)


def _k5_inputs(gen, b, p, l, c, frac_pos=0.3):
    f0 = (torch.randn(b, p, c, generator=gen, device="cuda") / c ** 0.5).to(torch.bfloat16)
    f1 = (torch.randn(b, l, c, generator=gen, device="cuda") / c ** 0.5).to(torch.bfloat16)
    gt = torch.randint(0, l, (b, p), generator=gen, device="cuda", dtype=torch.int32)
    gt = torch.where(torch.rand(b, p, generator=gen, device="cuda") < frac_pos, gt, -1)
    return f0, f1, gt


@pytest.mark.parametrize("b,p,l,c,gamma,frac_pos", [
    (2, 300, 200, 64, 2.0, 0.3),
    (1, 129, 65, 256, 2.5, 0.3),
    (1, 100, 70, 32, 2.0, 0.0),
])
def test_k5_matches_plain(gen, b, p, l, c, gamma, frac_pos):
    f0, f1, gt = _k5_inputs(gen, b, p, l, c, frac_pos)
    inv_temp = 1 / (0.08 + 1e-4)
    sums, grads = [], []
    for fn in (coarse_focal_sums, coarse_focal_sums_plain):
        a0, a1 = f0.clone().requires_grad_(), f1.clone().requires_grad_()
        pos, neg, mx = fn(a0, a1, gt, inv_temp, 0.5, gamma)
        (0.7 * pos + 1.3 * neg).backward()
        sums.append(torch.stack([pos.detach(), neg.detach(), mx]))
        grads.append((a0.grad.float(), a1.grad.float()))
    torch.cuda.synchronize()
    torch.testing.assert_close(sums[0], sums[1], rtol=2e-4, atol=1e-6)
    for g, r in zip(*grads):
        scale = r.abs().max().item()
        assert scale > 0
        assert (g - r).abs().max().item() < 2e-2 * scale
        assert torch.nn.functional.cosine_similarity(g.flatten(), r.flatten(), dim=0).item() > 0.999


def _k5_against_plain(gen, b, p, l, c):
    """K5 twice and its plain version, forward and backward: sums within 2e-4
    relative, gradients within 2e-2 of max|grad| with cosine > 0.999, the two
    launches equal bit for bit."""
    f0, f1, gt = _k5_inputs(gen, b, p, l, c)
    inv_temp = 1 / (0.08 + 1e-4)
    runs = []
    for fn in (coarse_focal_sums, coarse_focal_sums, coarse_focal_sums_plain):
        a0, a1 = f0.clone().requires_grad_(), f1.clone().requires_grad_()
        pos, neg, mx = fn(a0, a1, gt, inv_temp, 0.5, 2.0)
        (0.7 * pos + 1.3 * neg).backward()
        runs.append((torch.stack([pos.detach(), neg.detach(), mx]), a0.grad.float(), a1.grad.float()))
    torch.cuda.synchronize()
    (sums, g0, g1), (sums2, h0, h1), (ref, r0, r1) = runs
    assert torch.equal(sums, sums2) and torch.equal(g0, h0) and torch.equal(g1, h1)
    torch.testing.assert_close(sums, ref, rtol=2e-4, atol=1e-6)
    for g, r in ((g0, r0), (g1, r1)):
        scale = r.abs().max().item()
        assert (g - r).abs().max().item() < 2e-2 * scale
        assert torch.nn.functional.cosine_similarity(g.flatten(), r.flatten(), dim=0).item() > 0.999


def test_k5_wide_cluster_size_is_the_width_rule(gen):
    """The wide instance's kernels size their clusters as k5_instance says, at
    every width it takes."""
    lib = kernels.build()
    for c in range(577, 4097):
        assert lib.lib.opp_coarse_loss_cluster_size(c) == k5_instance(c)[1], c


@pytest.mark.parametrize("b,p,l,c,instance", [
    (2, 333, 200, 384, ("tc", 2)), (2, 333, 200, 512, ("tc", 2)), (1, 200, 130, 520, ("tc", 3)),
    (2, 333, 200, 640, ("wide", 3)), (2, 333, 200, 1024, ("wide", 4)),
    (1, 129, 65, 4096, ("wide", 16)),
    (3, 333, 201, 600, ("wide", 3)), (3, 333, 201, 1000, ("wide", 4)), (3, 129, 65, 4000, ("wide", 16)),
])
def test_k5_wide_instances_match_plain_and_repeat_bitwise(gen, b, p, l, c, instance):
    """K5 above 256 channels: the resident tile in 256-channel output chunks up
    to 576, the wide instance's clusters of 256-channel slices up to 4096
    (K1's widest), ragged widths (a narrower last slice) and ragged P and L."""
    assert k5_instance(c) == instance
    _k5_against_plain(gen, b, p, l, c)


@pytest.mark.parametrize("b,p,l,c", [
    (2, 333, 200, 32), (2, 333, 200, 64), (2, 333, 200, 256), (1, 7000, 4096, 256),
    (1, 333, 4096, 64),
])
def test_k5_tensor_cores_match_plain_and_repeat_bitwise(gen, b, p, l, c):
    """K5 forward and backward at ragged shapes: sums within 2e-4 relative,
    gradients within 2e-2 of max|grad| with cosine > 0.999, two launches equal
    bit for bit."""
    _k5_against_plain(gen, b, p, l, c)


def test_k5_is_deterministic_and_counts(gen):
    f0, f1, gt = _k5_inputs(gen, 2, 200, 150, 64)
    before = kernels.launch_counts()
    runs = []
    for _ in range(2):
        a0 = f0.float().requires_grad_()
        loss, mx = fused_coarse_focal_loss(a0, f1.float(), gt, 0.08, feat_norm="none")
        loss.backward()
        runs.append((loss.detach(), a0.grad))
    after = kernels.launch_counts()
    assert after["K5_coarse_loss"] == before["K5_coarse_loss"] + 2
    assert after["K5_coarse_loss_bwd"] == before["K5_coarse_loss_bwd"] + 2
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("feat_norm", ["sqrt_feat_dim", "none"])
def test_k5_scales_and_rounds_in_the_pack(gen, feat_norm):
    """The loss on f32 features: the card scales and rounds them to bf16 in the
    operand pack and scales their gradients in the backward kernel; the CPU
    (plain version) scales, rounds and differentiates through PyTorch ops.
    Loss within 2e-4 relative, gradients within 2e-2 of max|grad|, cosine > 0.999."""
    b, p, l, c = 2, 300, 200, 64
    feat0 = torch.randn(b, p, c, generator=gen, device="cuda")
    feat1 = torch.randn(b, l, c, generator=gen, device="cuda")
    gt = torch.randint(0, l, (b, p), generator=gen, device="cuda", dtype=torch.int32)
    gt = torch.where(torch.rand(b, p, generator=gen, device="cuda") < 0.3, gt, -1)
    runs = []
    for dev in ("cuda", "cpu"):
        a0 = feat0.to(dev, copy=True).requires_grad_()
        a1 = feat1.to(dev, copy=True).requires_grad_()
        loss, mx = fused_coarse_focal_loss(a0, a1, gt.to(dev), 0.08, feat_norm=feat_norm)
        loss.backward()
        runs.append((loss.detach().cpu(), mx.cpu(), a0.grad.cpu(), a1.grad.cpu()))
    (loss, mx, g0, g1), (rloss, rmx, r0, r1) = runs
    assert g0.dtype == torch.float32 and g1.dtype == torch.float32
    torch.testing.assert_close(loss, rloss, rtol=2e-4, atol=0)
    torch.testing.assert_close(mx, rmx, rtol=2e-4, atol=0)
    for g, r in ((g0, r0), (g1, r1)):
        scale = r.abs().max().item()
        assert (g - r).abs().max().item() < 2e-2 * scale
        assert torch.nn.functional.cosine_similarity(g.flatten(), r.flatten(), dim=0).item() > 0.999


@pytest.mark.parametrize("b,p,l,c,instance", [(2, 333, 200, 256, "tc"), (2, 333, 200, 512, "tc"),
                                               (2, 333, 200, 1024, "wide")])
@pytest.mark.parametrize("feat_norm", ["sqrt_feat_dim", "none"])
def test_k5_feature_gradients_are_bf16_values_times_the_scale(gen, b, p, l, c, instance, feat_norm):
    """Both K5 instances round each finished df element to bf16 before the
    operands' scale, as the TPU kernel's _core_bwd does: at a power-of-two
    scale (1/16 at C = 256, 1/32 at 1024, 1 without the norm) df / scale is
    bf16-valued; two launches are bitwise equal."""
    assert k5_instance(c)[0] == instance
    scale = c ** -0.5 if feat_norm == "sqrt_feat_dim" else 1.0
    f0 = torch.randn(b, p, c, generator=gen, device="cuda") * (1.0 if feat_norm == "sqrt_feat_dim" else c ** -0.5)
    f1 = torch.randn(b, l, c, generator=gen, device="cuda") * (1.0 if feat_norm == "sqrt_feat_dim" else c ** -0.5)
    gt = torch.randint(0, l, (b, p), generator=gen, device="cuda", dtype=torch.int32)
    gt = torch.where(torch.rand(b, p, generator=gen, device="cuda") < 0.3, gt, -1)
    runs = []
    for _ in range(2):
        a0, a1 = f0.clone().requires_grad_(), f1.clone().requires_grad_()
        loss, _ = fused_coarse_focal_loss(a0, a1, gt, 0.08, feat_norm=feat_norm)
        loss.backward()
        runs.append((a0.grad, a1.grad))
    torch.cuda.synchronize()
    for g, again in zip(*runs):
        assert torch.equal(g, again)
        if c in (256, 1024) or scale == 1.0:  # a power of two: df / scale is exact
            unscaled = g / scale
            assert torch.equal(unscaled.to(torch.bfloat16).float(), unscaled)
        assert g.abs().max().item() > 0


def test_window_gather_autograd_runs_k3_forward_k4_backward(gen):
    """The differentiable gather on the card: K3 forward, K4 backward, and the
    gradient equal to the CPU's (plain versions) up to f32 summation order."""
    feat = torch.randn(2, 48, 64, 128, generator=gen, device="cuda")
    ids = torch.randint(-3, 12 * 16 + 3, (2, 90), generator=gen, device="cuda")
    cot = torch.randn(2, 90, 25, 128, generator=gen, device="cuda")
    before = kernels.launch_counts()
    grads = []
    for dev in ("cuda", "cpu"):
        f = feat.detach().to(dev).requires_grad_()  # a leaf on each device
        gather_windows_aligned(f, ids.to(dev), (12, 16), 4, 5).backward(cot.to(dev))
        grads.append(f.grad.cpu())
    after = kernels.launch_counts()
    assert after["K3_window_gather"] == before["K3_window_gather"] + 1
    assert after["K4_window_scatter"] == before["K4_window_scatter"] + 1
    assert (grads[0] - grads[1]).abs().max().item() < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [5, 9])
def test_k6_matches_plain(gen, dtype, window):
    """K6 is a copy: bitwise equal to its plain version, with corners across
    every border, entirely off the map, and K not a multiple of anything."""
    feat = torch.randn(2, 40, 56, 128, generator=gen, device="cuda").to(dtype)
    r0 = torch.randint(-window - 3, 40 + 3, (2, 77), generator=gen, device="cuda")
    c0 = torch.randint(-window - 3, 56 + 3, (2, 77), generator=gen, device="cuda")
    r0[:, :5] = -10 * window  # invalid slots
    before = kernels.launch_counts()["K6_patch_gather"]
    got = patch_gather(feat, r0, c0, window)
    ref = patch_gather_plain(feat, r0, c0, window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["K6_patch_gather"] == before + 1
    assert got.shape == (2, 77, window * window, 128) and got.dtype == dtype
    assert torch.equal(got, ref)
    assert bool((got[:, :5] == 0).all())


def test_k6_gather_windows_and_operand_checks(gen):
    feat = torch.randn(1, 16, 16, 64, generator=gen, device="cuda")
    centers = torch.randint(-4, 20, (1, 33, 2), generator=gen, device="cuda", dtype=torch.int32)
    got = gather_windows(feat, centers, 9)
    ref = gather_windows(feat.cpu(), centers.cpu(), 9)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)
    # 3 channels of f32 are 12 bytes, no multiple of 16
    f3 = torch.randn(1, 8, 8, 3, generator=gen, device="cuda")
    assert torch.equal(patch_gather(f3, centers[..., 0], centers[..., 1], 5),
                       patch_gather_plain(f3, centers[..., 0], centers[..., 1], 5))
    with pytest.raises(ValueError):
        patch_gather(torch.zeros(1, 8, 8, 4, device="cuda", dtype=torch.float16),
                     centers[..., 0], centers[..., 1], 5)
    # 3 bf16 values are 6 bytes, and a map 2 bytes past an alignment (what K3 and
    # K4 copy 2 bytes a lane)
    b3 = torch.randn(1, 8, 8, 3, generator=gen, device="cuda").to(torch.bfloat16)
    misaligned = torch.randn(1 + 8 * 8 * 4, generator=gen, device="cuda").to(torch.bfloat16)[1:].view(1, 8, 8, 4)
    for f in (b3, misaligned):
        assert window_instance(f.shape[-1] * 2, f.data_ptr()) == "span"
        assert torch.equal(patch_gather(f, centers[..., 0], centers[..., 1], 5),
                           patch_gather_plain(f, centers[..., 0], centers[..., 1], 5))


@pytest.mark.parametrize("dtype,c,offset,vec", [
    (torch.bfloat16, 196, 0, 8), (torch.bfloat16, 130, 0, 4), (torch.bfloat16, 256, 4, 8),
    (torch.bfloat16, 256, 2, 4), (torch.float32, 98, 0, 8), (torch.float32, 5, 0, 4),
    (torch.bfloat16, 33, 0, 2), (torch.bfloat16, 256, 1, 2), (torch.float32, 33, 0, 4),
    (torch.bfloat16, 130, 0, 4)])
def test_k6_narrow_vector_instances_match_plain(gen, dtype, c, offset, vec):
    """The pixels and map addresses that took K6's 8-, 4- and 2-byte instances
    before the span copy (``vec``, the vector they took) are exact copies with
    16 bytes a lane too, and take K3's and K4's span instances; ``offset``
    elements shift the map off the allocator's alignment."""
    n, h, w, k, window = 2, 20, 24, 45, 9
    base = torch.randn(offset + n * h * w * c, generator=gen, device="cuda").to(dtype)
    feat = base[offset:].view(n, h, w, c)
    assert vec < 16 and window_instance(c * feat.element_size(), feat.data_ptr()) == "span"
    r0 = torch.randint(-window - 3, h + 3, (n, k), generator=gen, device="cuda")
    c0 = torch.randint(-window - 3, w + 3, (n, k), generator=gen, device="cuda")
    r0[:, :4] = -10 * window
    before = kernels.launch_counts()["K6_patch_gather"]
    got = patch_gather(feat, r0, c0, window)
    ref = patch_gather_plain(feat, r0, c0, window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["K6_patch_gather"] == before + 1
    assert torch.equal(got, ref) and bool((got[:, :4] == 0).all())


# K6's span copy at every pixel width: (dtype, C) of 2 to 392 bytes, and the
# map's start past a 16-byte alignment, in bytes (a view into a larger buffer;
# an f32 map starts at a multiple of 4)
K6_CASES = [(torch.bfloat16, c, base) for c in (1, 2, 4, 8, 33, 130, 196) for base in (0, 2, 4, 8)] + [
    (torch.float32, c, base) for c in (1, 2, 4, 33, 65) for base in (0, 4, 8)]


def _k6_corners(gen, n, k, h, w, window, dtype):
    r0 = torch.randint(-window - 3, h + 3, (n, k), generator=gen, device="cuda").to(dtype)
    c0 = torch.randint(-window - 3, w + 3, (n, k), generator=gen, device="cuda").to(dtype)
    r0[:, :3] = -10 * window  # off the map, as fine_windows makes its invalid slots
    c0[:, 3] = w + 4
    r0[:, 4], c0[:, 5] = h - 1, w - 1
    return r0, c0


@pytest.mark.parametrize("corner_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("window", [5, 9, 13])
@pytest.mark.parametrize("dtype,c,base", K6_CASES)
def test_k6_span_copy_matches_plain_at_every_width_and_offset(gen, dtype, c, base, window, corner_dtype):
    """K6 is bitwise the plain version at every pixel width, map offset,
    window and corner type: corners across each edge, off the map and inside,
    windows wider than the map."""
    size = torch.tensor([], dtype=dtype).element_size()
    n, h, w, k = 2, 13, 11, 37
    feat = _offset_tensor(gen, (n, h, w, c), dtype, base // size)
    assert feat.data_ptr() % 16 == base
    r0, c0 = _k6_corners(gen, n, k, h, w, window, corner_dtype)
    before = kernels.launch_counts()["K6_patch_gather"]
    got = patch_gather(feat, r0, c0, window)
    assert kernels.launch_counts()["K6_patch_gather"] == before + 1
    ref = patch_gather_plain(feat, r0, c0, window)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and bool((got[:, :4] == 0).all())


def test_k6_makes_one_launch_and_nothing_else(gen):
    """A call is one K6 launch and no other launch: int32 and int64 corners,
    strided corner views, and gather_windows' int64 centres with their -W/2
    offset, as the SfM refine hands them."""
    feat = torch.randn(2, 40, 56, 128, generator=gen, device="cuda").to(torch.bfloat16)
    centres = torch.randint(-8, 60, (2, 77, 2), generator=gen, device="cuda")  # int64
    corners = centres - 4  # int64 [2, 77, 2]
    r32, c32, centres32 = corners[..., 0].int().contiguous(), corners[..., 1].int().contiguous(), centres.int()
    calls = {
        "int32": lambda: patch_gather(feat, r32, c32, 9),
        "int64 views": lambda: patch_gather(feat, corners[..., 0], corners[..., 1], 9),
        "gather_windows": lambda: gather_windows(feat, centres, 9),
        "centred int32": lambda: patch_gather_centered(feat, centres32, 9),
    }
    want = patch_gather_plain(feat, r32, c32, 9)
    for tag, fn in calls.items():
        before = kernels.launch_counts()["K6_patch_gather"]
        got, names = _device_kernels(fn)
        assert kernels.launch_counts()["K6_patch_gather"] == before + 3, tag
        assert set(names) == {"patch_gather_kernel"}, (tag, names)
        assert torch.equal(got, want), tag


def test_k6_repeats_bitwise_and_raises_rather_than_fall_back(gen):
    feat = torch.randn(4, 64, 64, 196, generator=gen, device="cuda").to(torch.bfloat16)
    r0, c0 = _k6_corners(gen, 4, 300, 64, 64, 9, torch.int64)
    a, b = patch_gather(feat, r0, c0, 9), patch_gather(feat, r0, c0, 9)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    before = kernels.launch_counts()["K6_patch_gather"]
    for bad in (feat.half(), feat.double()):
        with pytest.raises(ValueError):
            patch_gather(bad, r0, c0, 9)
    with pytest.raises(ValueError):
        patch_gather(feat, r0.float(), c0.float(), 9)
    with pytest.raises(ValueError):
        patch_gather(feat, r0, c0, 256)  # a window the kernel does not take
    assert kernels.launch_counts()["K6_patch_gather"] == before


@pytest.mark.parametrize("cin,cout,kernel,stride,pad", [(1, 32, 7, 2, 3), (48, 40, 3, 1, 1), (196, 196, 3, 2, 1),
                                                        (24, 40, 1, 2, 0), (16, 8, 3, 1, 0)])
def test_int8_conv_sums_on_the_card_equal_the_cpu(gen, cin, cout, kernel, stride, pad):
    """The int8 conv (``ops/quant.py``, ``torch._int_mm`` on cuBLASLt) sums
    exactly: its int32 accumulators and its output equal the CPU's to the bit."""
    x = torch.randn(3, cin, 20, 20, generator=gen, device="cuda").to(memory_format=torch.channels_last)
    wt = torch.randn(cout, cin, kernel, kernel, generator=gen, device="cuda") * 0.1
    xq, _ = quant.quantize_activation(x)
    wq, _ = quant.quantize_weight(wt)
    acc = quant.int8_conv_accumulate(xq, wq, stride, pad)
    assert torch.equal(acc.cpu(), quant.int8_conv_accumulate(xq.cpu(), wq.cpu(), stride, pad))
    assert torch.equal(quant.quant_conv(x, wt, stride, pad).cpu(), quant.quant_conv(x.cpu(), wt.cpu(), stride, pad))


def test_sparse_fine_windows_on_the_card_match_the_cpu(gen):
    """``fine_windows`` through K6 on a 196-channel pin map: bf16 takes the
    8-byte instance, and the windows match the CPU's (f32, TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = ResNetFPNConfig(initial_dim=32, block_dims=(32, 196, 64))
    img = torch.rand(2, 64, 64, 1, generator=gen, device="cuda")
    ids = torch.randint(-2, 70, (2, 20), generator=gen, device="cuda")
    outs = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.float32), ("cuda", torch.bfloat16)):
        bb = ResNetFPN_8_2(cfg, dtype=dtype)
        bb.load_state_dict(random_state_dict(bb, seed=1))
        bb.eval().to(dev)
        before = kernels.launch_counts()["K6_patch_gather"]
        with torch.no_grad():
            _, ctx = bb.coarse_and_ctx(img.to(dev))
            outs[(dev, dtype)] = bb.fine_windows(ctx, ids.to(dev), (8, 8), 4, 5).float().cpu()
        assert kernels.launch_counts()["K6_patch_gather"] == before + (dev == "cuda")
    ref = outs[("cpu", torch.float32)]
    assert (outs[("cuda", torch.float32)] - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert (outs[("cuda", torch.bfloat16)] - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()


def test_triangulation_eigh_in_chunks_on_the_card(gen):
    """More 4 x 4 eigensolves than cuSOLVER's batched solver takes in one call
    (it refused phase 8c's 110608): the chunked DLT on the card recovers the
    points, as the CPU does."""
    from onepose_plus_plus_tpu_torch.geometry.rotations import angle_axis_to_matrix
    from onepose_plus_plus_tpu_torch.geometry.triangulation import triangulate_tracks

    n = 40000
    X = torch.rand(n, 3, generator=gen, device="cuda") * 2 - 1 + torch.tensor([0.0, 0.0, 5.0], device="cuda")
    K = torch.tensor([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]], device="cuda")
    R = angle_axis_to_matrix(torch.rand(n, 3, generator=gen, device="cuda") * 0.2)
    t = torch.tensor([1.0, 0.0, 0.0], device="cuda").expand(n, 3)
    P0 = (K @ torch.eye(3, 4, device="cuda")).expand(n, 3, 4)
    P1 = K @ torch.cat([R, t[..., None]], dim=-1)
    P = torch.stack([P0, P1], dim=1)
    Xh = torch.cat([X, torch.ones(n, 1, device="cuda")], dim=-1)
    proj = torch.einsum("nvij,nj->nvi", P, Xh)
    uv = proj[..., :2] / proj[..., 2:3]
    valid = torch.ones(n, 2, dtype=torch.bool, device="cuda")
    got = triangulate_tracks(P, uv, valid)
    ref = triangulate_tracks(P.cpu(), uv.cpu(), valid.cpu())
    torch.cuda.synchronize()
    assert got.shape == (n, 3)
    assert (got - X).abs().max().item() < 1e-2
    assert (got.cpu() - ref).abs().max().item() < 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,s", [(1, 1), (25, 25), (1, 25), (25, 1), (32, 7)])
def test_k7_matches_plain(gen, dtype, l, s):
    """The fine transformer's four (L, S) shapes and the largest L the TPU
    kernel's callers used, M not a multiple of the kernel's sequence group
    (f32: summation order only; bf16: a rounded operand may land on the
    neighbouring bf16 value, moving a row by up to ~1e-2)."""
    c, m = 128, 77
    rn = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen, device="cuda") * scale)  # noqa: E731
    w = [rn(c, c, scale=c ** -0.5) for _ in range(4)]
    args = (rn(m, l, c), rn(m, s, c), *w, 1 + rn(c, scale=0.1), rn(c, scale=0.1),
            rn(2 * c, 2 * c, scale=(2 * c) ** -0.5), rn(2 * c, c, scale=(2 * c) ** -0.5),
            1 + rn(c, scale=0.1), rn(c, scale=0.1))
    before = kernels.launch_counts()["K7_short_encoder"]
    got = fused_short_encoder_layer(*args, nhead=8, dtype=dtype)
    assert kernels.launch_counts()["K7_short_encoder"] == before + 1
    ref = short_encoder_layer_plain(*args, nhead=8, dtype=dtype)
    torch.cuda.synchronize()
    assert got.shape == (m, l, c) and got.dtype == torch.float32
    d = (got - ref).abs()
    if dtype == torch.float32:
        assert d.max().item() < 1e-4
    else:
        assert d.max().item() < 5e-2 and d.mean().item() < 5e-4
    with pytest.raises(ValueError):  # C not a multiple of 32
        fused_short_encoder_layer(rn(2, l, 48), rn(2, s, 48), *[rn(48, 48) for _ in range(4)],
                                  rn(48), rn(48), rn(96, 96), rn(96, 48), rn(48), rn(48), nhead=8)


@pytest.mark.parametrize("l,s", [(1, 1), (25, 25), (1, 25), (25, 1)])
def test_k7_bf16_tensor_cores_match_plain_and_repeat_bitwise(gen, l, s):
    """bf16 operands at C = 128 run the tensor-core instance (by kernel name;
    no CUDA-core K7 kernel), within phase 9a's tolerance of the plain version,
    two launches bitwise equal, a self layer (source is x, one tile for both)
    bitwise equal to the same layer given a copy of x as its source; M ragged
    (not a multiple of the tile's sequences)."""
    c, m = 128, 1003
    rn = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen, device="cuda") * scale)  # noqa: E731
    w = [rn(c, c, scale=c ** -0.5) for _ in range(4)] + [1 + rn(c, scale=0.1), rn(c, scale=0.1),
                                                         rn(2 * c, 2 * c, scale=(2 * c) ** -0.5),
                                                         rn(2 * c, c, scale=(2 * c) ** -0.5),
                                                         1 + rn(c, scale=0.1), rn(c, scale=0.1)]
    x = rn(m, l, c)
    src = x if l == s else rn(m, s, c)
    packed = pack_short_encoder_weights(*w, nhead=8, dtype=torch.bfloat16)
    assert packed.chunks is not None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            got = fused_short_encoder_layer_packed(x, src, packed)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.device_type.name == "CUDA"}
    assert any("short_encoder_tc_kernel" in n for n in names), names
    assert not any(re.search(r"\bshort_encoder_kernel", n) for n in names), names
    again = fused_short_encoder_layer_packed(x, src, packed)
    ref = short_encoder_layer_plain(x, src, *w, nhead=8, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    d = (got - ref).abs()
    assert got.shape == (m, l, c) and bool(torch.isfinite(got).all())
    assert d.max().item() < 5e-2 and d.mean().item() < 5e-4
    if l == s:
        assert torch.equal(fused_short_encoder_layer_packed(x, x.clone(), packed), got)

