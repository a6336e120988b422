"""K2 on padded image pairs at LoFTR outdoor's MegaDepth-1500 shape, on the
card: two views of 1200 x 800 and 800 x 1200 padded to 1200 x 1200 give
150 x 150 coarse grids of 22 500 cells, 15 000 of them valid, whose padded
rows and columns enter the dual softmax as ``row_add`` and ``col_add``
(-1e9). Run on the card: ``python3 -m pytest tests/test_torch_padded_pairs_cuda.py -m cuda``."""
import pytest
import torch

from onepose_plus_plus_tpu_torch.ops.cuda_matching import dual_softmax_rowcol_stats, rowcol_stats_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpreter mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _coarse_mask(h: int, w: int, side: int = 150) -> torch.Tensor:
    m = torch.zeros(side, side, dtype=torch.bool, device="cuda")
    m[:h, :w] = True
    return m.reshape(-1)


def test_k2_row_and_col_masks_at_megadepth_shape(gen):
    """[4, 22500] x [4, 22500] x 256 bf16 with the padding of landscape and
    portrait views on both sides: at the valid rows and columns the LSEs lie
    within 2e-3 of the plain bf16 version (one pair at a time, the dense
    [22500, 22500] f32 similarity being 2 GB) and the argmaxes agree on
    >= 99.9 %; no valid row's best column, and no valid column's best row,
    is a padded one."""
    b, l, c = 4, 22500, 256
    land, port = _coarse_mask(100, 150), _coarse_mask(150, 100)
    m0 = torch.stack([land, port, land, port])
    m1 = torch.stack([port, port, land, land])
    f0 = torch.randn(b, l, c, generator=gen, device="cuda")
    f1 = torch.randn(b, l, c, generator=gen, device="cuda")
    row_add = torch.where(m0, 0.0, -1e9)
    col_add = torch.where(m1, 0.0, -1e9)
    got = dual_softmax_rowcol_stats(f0, f1, 0.1, row_add=row_add, col_add=col_add, dtype=torch.bfloat16)
    scale = c ** -0.5
    for i in range(b):
        ref = rowcol_stats_plain((f0[i:i + 1] * scale).to(torch.bfloat16), (f1[i:i + 1] * scale).to(torch.bfloat16),
                                 1 / (0.1 + 1e-4), row_add[i:i + 1], col_add[i:i + 1])
        rows, cols = m0[i], m1[i]
        for k, at in (("row_lse", rows), ("row_best_val", rows), ("col_lse", cols), ("col_best_val", cols)):
            assert (got[k][i][at] - ref[k][0][at]).abs().max().item() < 2e-3, (i, k)
        assert (got["row_best_j"][i][rows] == ref["row_best_j"][0][rows]).float().mean().item() >= 0.999
        assert (got["col_best_p"][i][cols] == ref["col_best_p"][0][cols]).float().mean().item() >= 0.999
        assert m1[i][got["row_best_j"][i][rows].long()].all()
        assert m0[i][got["col_best_p"][i][cols].long()].all()
        del ref
