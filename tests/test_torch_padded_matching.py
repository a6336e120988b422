"""Coarse matching of image pairs padded bottom-right (LoFTR's MegaDepth
loader): the row mask and the column mask in the dual softmax, and the border
removed per pair from each image's valid extent (LoFTR's
``mask_border_with_padding``), in the streaming selector (K2's plain version
on the CPU) and the dense one."""
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu_torch.ops.cuda_matching import fused_select_topk_matches
from onepose_plus_plus_tpu_torch.ops.matching import (
    _border_keep,
    border_keep_padded,
    dual_softmax_confidence,
    select_topk_matches,
)

torch.set_num_threads(2)

SIDE = 12
GRID = (SIDE, SIDE)


def grid_mask(rows: int, cols: int) -> torch.Tensor:
    m = torch.zeros(SIDE, SIDE, dtype=torch.bool)
    m[:rows, :cols] = True
    return m.reshape(-1)


def pair_feats(seed: int, c: int = 64):
    """Half-integer features of two 12 x 12 grids; every other cell of image 0
    planted on a cell of image 1 (strong mutual matches), padded cells
    included."""
    rng = np.random.default_rng(seed)
    f0 = rng.integers(-2, 3, (2, SIDE * SIDE, c)).astype(np.float32) * 0.5
    f1 = rng.integers(-2, 3, (2, SIDE * SIDE, c)).astype(np.float32) * 0.5
    for b in range(2):
        for row in range(0, SIDE * SIDE, 2):
            f0[b, row] = f1[b, (row * 7 + b) % (SIDE * SIDE)] * 2.0
    return torch.from_numpy(f0), torch.from_numpy(f1)


MASKS = {  # (row mask, column mask) of the two pairs: landscape and portrait views
    "mixed": (torch.stack([grid_mask(8, 12), grid_mask(12, 8)]), torch.stack([grid_mask(12, 8), grid_mask(12, 12)])),
    "ragged": (torch.stack([grid_mask(9, 11), grid_mask(12, 12)]), torch.stack([grid_mask(7, 12), grid_mask(10, 5)])),
}


def _sets(m):
    return [set(zip(m.i_ids[b][m.mask[b]].tolist(), m.j_ids[b][m.mask[b]].tolist())) for b in range(len(m.mask))]


def test_border_keep_padded_measures_from_each_valid_extent():
    """A 6 x 6 grid of which 4 rows and 5 columns hold image, border 1: rows
    1-2 and columns 1-3 stay; border 0 removes nothing; a full mask removes
    the border of the whole grid, as ``_border_keep`` two-sided."""
    m = torch.zeros(1, 6, 6, dtype=torch.bool)
    m[0, :4, :5] = True
    keep = border_keep_padded(m.reshape(1, -1), (6, 6), 1).reshape(6, 6)
    want = torch.zeros(6, 6, dtype=torch.bool)
    want[1:3, 1:4] = True
    assert torch.equal(keep, want)
    assert border_keep_padded(m.reshape(1, -1), (6, 6), 0).all()
    full = torch.ones(2, 36, dtype=torch.bool)
    assert torch.equal(border_keep_padded(full, (6, 6), 2), _border_keep(6, 6, 2, True)[None].expand(2, -1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_masks_select_bitwise_as_no_masks(dtype):
    """Masks that pad nothing add 0 to every similarity and measure the border
    from the grid's edge: the selection is bitwise the unmasked one."""
    f0, f1 = pair_feats(1)
    full = torch.ones(2, SIDE * SIDE, dtype=torch.bool)
    kw = dict(border_two_sided=True, row_grid_hw=GRID, dtype=dtype)
    a = fused_select_topk_matches(f0, f1, 0.1, GRID, 0.2, 2, 64, **kw)
    b = fused_select_topk_matches(f0, f1, 0.1, GRID, 0.2, 2, 64, col_mask=full, row_mask=full, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.mask.any()


@pytest.mark.parametrize("layout", sorted(MASKS))
@pytest.mark.parametrize("seed", [2, 3])
def test_streaming_selector_agrees_with_dense_on_padded_pairs(layout, seed):
    """K2's plain statistics with ``row_add`` and ``col_add`` and the dense
    masked confidence select the same matches, at confidences within 1e-5
    (the same float32 similarities, factorised through log-sum-exps on one
    side and two softmaxes on the other)."""
    f0, f1 = pair_feats(seed)
    m0, m1 = MASKS[layout]
    fused = fused_select_topk_matches(f0, f1, 0.1, GRID, 0.2, 2, 80, border_two_sided=True, row_grid_hw=GRID,
                                      col_mask=m1, row_mask=m0)
    conf = dual_softmax_confidence(f0, f1, 0.1, m0, m1)
    dense = select_topk_matches(conf, GRID, 0.2, 2, 80, border_two_sided=True, row_grid_hw=GRID,
                                row_mask=m0, col_mask=m1)
    assert _sets(fused) == _sets(dense) and any(_sets(fused))
    np.testing.assert_allclose(fused.mconf.numpy(), dense.mconf.numpy(), atol=1e-5)


@pytest.mark.parametrize("layout", sorted(MASKS))
def test_no_match_in_padding_or_in_the_valid_extents_border(layout):
    """The planted matches reach into the padding; with the masks every kept
    match lies at least 2 cells inside both images' valid extents, and the
    same selection without masks keeps some that do not."""
    f0, f1 = pair_feats(4)
    m0, m1 = MASKS[layout]
    kw = dict(border_two_sided=True, row_grid_hw=GRID)
    masked = fused_select_topk_matches(f0, f1, 0.1, GRID, 0.2, 2, 80, col_mask=m1, row_mask=m0, **kw)
    plain = fused_select_topk_matches(f0, f1, 0.1, GRID, 0.2, 2, 80, **kw)
    k0, k1 = border_keep_padded(m0, GRID, 2), border_keep_padded(m1, GRID, 2)
    outside = 0
    for b in range(2):
        for i, j in _sets(masked)[b]:
            assert k0[b, i] and k1[b, j]
        outside += sum(not (k0[b, i] and k1[b, j]) for i, j in _sets(plain)[b])
    assert outside > 0


def test_row_mask_needs_the_row_grid_and_a_column_mask():
    f0, f1 = pair_feats(5)
    m0, m1 = MASKS["mixed"]
    with pytest.raises(ValueError):
        fused_select_topk_matches(f0, f1, 0.1, GRID, 0.2, 2, 16, row_mask=m0, col_mask=m1)
    with pytest.raises(ValueError):
        fused_select_topk_matches(f0, f1, 0.1, GRID, 0.2, 2, 16, row_grid_hw=GRID, row_mask=m0)
    with pytest.raises(ValueError):
        select_topk_matches(dual_softmax_confidence(f0, f1, 0.1), GRID, 0.2, 2, 16, row_mask=m0, col_mask=m1)
