"""Kernels K1-K3 on the GPU against their plain PyTorch versions (marker ``cuda``).

These build the kernels with nvcc and launch them, so they run only on a
machine with an NVIDIA Hopper GPU and the CUDA toolkit, and skip elsewhere:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

``chip_smoke.py`` makes the same comparisons at the main path's shapes.
"""
import pytest
import torch

from onepose_plus_plus_tpu_torch import kernels
from onepose_plus_plus_tpu_torch.ops.cuda_encoder import encoder_layer_plain, fused_encoder_layer
from onepose_plus_plus_tpu_torch.ops.cuda_gather import window_gather, window_gather_plain
from onepose_plus_plus_tpu_torch.ops.cuda_matching import (
    dual_softmax_rowcol_stats,
    rowcol_stats_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpreter mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,s,masks", [(300, 450, False), (97, 61, True)])
def test_k1_matches_plain(gen, dtype, l, s, masks):
    c = 256
    rn = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen, device="cuda") * scale)  # noqa: E731
    x, src = rn(2, l, c), rn(2, s, c)  # f32 streams; dtype is the product operand type
    w = [rn(c, c, scale=c ** -0.5).to(dtype) for _ in range(4)]
    ln1 = [1 + rn(c, scale=0.1), rn(c, scale=0.1)]
    w0, w1 = rn(2 * c, 2 * c, scale=(2 * c) ** -0.5).to(dtype), rn(2 * c, c, scale=(2 * c) ** -0.5).to(dtype)
    ln2 = [1 + rn(c, scale=0.1), rn(c, scale=0.1)]
    xm = (torch.rand(2, l, generator=gen, device="cuda") > 0.3).float() if masks else None
    sm = (torch.rand(2, s, generator=gen, device="cuda") > 0.3).float() if masks else None
    args = (x, src, *w, *ln1, w0, w1, *ln2, xm, sm)
    before = kernels.launch_counts()["K1_encoder_layer"]
    got = fused_encoder_layer(*args, nhead=8, dtype=dtype)
    assert kernels.launch_counts()["K1_encoder_layer"] == before + 1
    ref = encoder_layer_plain(*args, nhead=8, dtype=dtype)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() < 1e-3


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain(gen, dtype):
    feat = torch.randn(2, 48, 64, 128, generator=gen, device="cuda").to(dtype)
    ids = torch.randint(-5, 12 * 16 + 5, (2, 77), generator=gen, device="cuda")
    got = window_gather(feat, ids, (12, 16), 4, 5)
    torch.cuda.synchronize()
    assert torch.equal(got, window_gather_plain(feat, ids, (12, 16), 4, 5))


def test_wrapper_raises_for_unsupported_operands(gen):
    with pytest.raises(ValueError):
        window_gather(torch.zeros(1, 8, 8, 3, device="cuda"), torch.zeros(1, 2, device="cuda"), (2, 2), 4, 5)
    kernels.build()  # the library itself builds from csrc/
