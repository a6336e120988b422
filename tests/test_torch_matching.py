"""Port parity: coarse matching and kernel K2's plain version against the JAX package.

Features are small multiples of 1/2 with C = 64: after the 1/sqrt(C) = 1/8
scaling they stay exactly representable in bf16, and every similarity is an
exact f32 sum, so the JAX kernel (bf16 operands) and the port (f32) see the
same similarities and differ only in how they reduce them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.ops.matching import (
    _border_keep as jax_border_keep,
    dual_softmax_confidence as jax_confidence,
    select_topk_matches as jax_select,
)
from onepose_plus_plus_tpu.ops.pallas_matching import (
    dual_softmax_rowcol_stats as jax_stats,
    fused_select_topk_matches as jax_fused_select,
)
from onepose_plus_plus_tpu_torch.ops.cuda_matching import (
    dual_softmax_rowcol_stats,
    fused_select_topk_matches,
)
from onepose_plus_plus_tpu_torch.ops.matching import (
    _border_keep,
    dual_softmax_confidence,
    select_topk_matches,
)

torch.set_num_threads(2)

TEMP = 0.08


def make_feats(b=2, p=200, l=144, c=64, seed=0, planted=None):
    """Half-integer features; row 3i is planted on column i (strong mutual match)."""
    rng = np.random.default_rng(seed)
    f0 = rng.integers(-2, 3, (b, p, c)).astype(np.float32) * 0.5
    f1 = rng.integers(-2, 3, (b, l, c)).astype(np.float32) * 0.5
    pairs = planted if planted is not None else [(3 * i, i) for i in range(0, min(p // 3, l), 2)]
    for bi in range(b):
        for row, col in pairs:
            f0[bi, row] = f1[bi, col] * 2.0
    return f0, f1


def _match_sets(m):
    i, j, mask = (np.asarray(a) for a in (m.i_ids, m.j_ids, m.mask))
    return [set(zip(i[b][mask[b]].tolist(), j[b][mask[b]].tolist())) for b in range(len(i))]


def _mconf_by_pair(m):
    i, j, mask, conf = (np.asarray(a) for a in (m.i_ids, m.j_ids, m.mask, m.mconf))
    return [{(a, c): v for a, c, v, ok in zip(i[b], j[b], conf[b], mask[b]) if ok}
            for b in range(len(i))]


def test_k2_plain_stats_match_pallas_kernel():
    f0, f1 = make_feats(p=256, l=512, seed=1)
    ref = jax_stats(jnp.asarray(f0), jnp.asarray(f1), TEMP, r_tile=64, l_tile=128, interpret=True)
    got = dual_softmax_rowcol_stats(torch.from_numpy(f0), torch.from_numpy(f1), TEMP)
    for k in ("row_lse", "col_lse", "row_best_val", "col_best_val"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)
    for k in ("row_best_j", "col_best_p"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_k2_plain_stats_with_column_mask():
    f0, f1 = make_feats(p=100, l=128, seed=2)
    col_add = np.where(np.random.default_rng(0).random((2, 128)) > 0.2, 0.0, -1e9).astype(np.float32)
    ref = jax_stats(jnp.asarray(f0), jnp.asarray(f1), 0.1, col_add=jnp.asarray(col_add),
                    r_tile=64, l_tile=128, interpret=True)
    got = dual_softmax_rowcol_stats(torch.from_numpy(f0), torch.from_numpy(f1), 0.1,
                                    col_add=torch.from_numpy(col_add))
    np.testing.assert_allclose(got["row_lse"].numpy(), np.asarray(ref["row_lse"]), atol=1e-4)
    np.testing.assert_array_equal(got["row_best_j"].numpy(), np.asarray(ref["row_best_j"]))
    assert not np.isin(got["row_best_j"].numpy()[0], np.nonzero(col_add[0])[0]).any()


# Above 576 channels (the card's wide instances): make_feats' half-integers
# scaled so that the operands after the feature norm are multiples of 1/32 or
# 1/64 (exact in bf16, every similarity an exact f32 sum). 1/sqrt(640) is not a
# power of two, so C = 640 passes feat_norm="none" to both packages with the
# features scaled beforehand.
WIDE = [(640, "none", 1 / 16), (1024, "sqrt_feat_dim", 1.0)]


def _wide_inputs(c, factor, seed):
    f0, f1 = make_feats(p=200, l=144, c=c, seed=seed)
    col_mask = np.random.default_rng(seed).random((2, 144)) > 0.2
    return f0 * factor, f1 * factor, col_mask


@pytest.mark.parametrize("c,feat_norm,factor", WIDE)
def test_k2_plain_bf16_stats_match_pallas_kernel_above_576_channels(c, feat_norm, factor):
    """K2 at the widths the card's wide instances take, with a column mask: the
    port's bf16 operands (the JAX kernel's precision) against the JAX kernel in
    interpret mode. LSEs and best values within 1e-4, argmaxes equal. The
    column statistics are compared at the unmasked columns: at a masked one
    the JAX kernel's column LSE is its log(0 + 1e-30) guard, the port's the
    -1e9 of the mask."""
    f0, f1, col_mask = _wide_inputs(c, factor, seed=11)
    col_add = np.where(col_mask, 0.0, -1e9).astype(np.float32)
    ref = jax_stats(jnp.asarray(f0), jnp.asarray(f1), TEMP, col_add=jnp.asarray(col_add), r_tile=64,
                    l_tile=128, feat_norm=feat_norm, interpret=True)
    got = dual_softmax_rowcol_stats(torch.from_numpy(f0), torch.from_numpy(f1), TEMP,
                                    col_add=torch.from_numpy(col_add), feat_norm=feat_norm,
                                    dtype=torch.bfloat16)
    for k in ("row_lse", "row_best_val"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)
    for k in ("col_lse", "col_best_val"):
        np.testing.assert_allclose(got[k].numpy()[col_mask], np.asarray(ref[k])[col_mask], atol=1e-4, err_msg=k)
    for k in ("row_best_j", "col_best_p"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert not np.isin(got["row_best_j"].numpy()[0], np.nonzero(~col_mask[0])[0]).any()


@pytest.mark.parametrize("c,feat_norm,factor", WIDE)
def test_fused_select_matches_jax_above_576_channels(c, feat_norm, factor):
    """The match set of the fused selection on bf16 operands above 576
    channels, with a column mask, equals the JAX package's."""
    f0, f1, col_mask = _wide_inputs(c, factor, seed=12)
    ref = jax_fused_select(jnp.asarray(f0), jnp.asarray(f1), TEMP, (12, 12), 0.0, 2, 64, feat_norm=feat_norm,
                           col_mask=jnp.asarray(col_mask), interpret=True)
    got = fused_select_topk_matches(torch.from_numpy(f0), torch.from_numpy(f1), TEMP, (12, 12), 0.0, 2, 64,
                                    feat_norm=feat_norm, col_mask=torch.from_numpy(col_mask),
                                    dtype=torch.bfloat16)
    sets = _match_sets(got)
    assert sets == _match_sets(ref)
    assert sum(len(m) for m in sets) > 20


@pytest.mark.parametrize("two_sided", [False, True])
def test_border_keep(two_sided):
    np.testing.assert_array_equal(
        _border_keep(6, 9, 2, two_sided).numpy(), np.asarray(jax_border_keep(6, 9, 2, two_sided))
    )


@pytest.mark.parametrize("thr", [0.0, 0.1])
def test_dense_select_matches_jax(thr):
    f0, f1 = make_feats(p=300, l=144, seed=3)
    conf_j = jax_confidence(jnp.asarray(f0), jnp.asarray(f1), TEMP)
    conf_t = dual_softmax_confidence(torch.from_numpy(f0), torch.from_numpy(f1), TEMP)
    # f32 softmax over logits up to ~|80|: a few ulps of confidences near 1
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j), atol=1e-5)
    ref = jax_select(jnp.asarray(conf_t.numpy()), (12, 12), thr, 2, 64)
    got = select_topk_matches(conf_t, (12, 12), thr, 2, 64)
    assert _match_sets(got) == _match_sets(ref)
    assert sum(len(s) for s in _match_sets(got)) > 20
    # both select from the same confidence tensor: measured max |d| 0; the
    # bound is the one two f32 frameworks' confidences are held to
    for g, r in zip(_mconf_by_pair(got), _mconf_by_pair(ref)):
        for pair in r:
            np.testing.assert_allclose(g[pair], r[pair], rtol=1e-5, atol=1e-6)


def test_fused_select_matches_jax_with_one_sided_border():
    """Rows planted on border columns: a row whose best column lies in the
    removed top/left border gives no match; the bottom/right border stays
    (the one-sided quirk of border_two_sided=False)."""
    planted = [(0, 0), (3, 5), (6, 13), (9, 143), (12, 140), (15, 60), (18, 77), (21, 100)]
    f0, f1 = make_feats(p=200, l=144, seed=5, planted=planted)
    ref = jax_fused_select(jnp.asarray(f0), jnp.asarray(f1), TEMP, (12, 12), 0.0, 2, 64,
                           interpret=True)
    got = fused_select_topk_matches(torch.from_numpy(f0), torch.from_numpy(f1), TEMP,
                                    (12, 12), 0.0, 2, 64)
    sets = _match_sets(got)
    assert sets == _match_sets(ref)
    for s in sets:
        assert {(9, 143), (12, 140)} <= s  # cells (11, 11), (11, 8): bottom/right border kept
        # cells (0, 0), (0, 5), (1, 1), (5, 0): top/left border removed
        assert not any(row in (0, 3, 6, 15) for row, _ in s)
    # confidences near 1 from two frameworks' f32 exp and LSE: measured max
    # |d| 9.5e-7 (95 % of a bare atol=1e-6, 9 % of this bound)
    for g, r in zip(_mconf_by_pair(got), _mconf_by_pair(ref)):
        for pair in r:
            np.testing.assert_allclose(g[pair], r[pair], rtol=1e-5, atol=1e-6)


def test_fused_and_dense_select_agree():
    f0, f1 = make_feats(p=300, l=144, seed=6)
    ft0, ft1 = torch.from_numpy(f0), torch.from_numpy(f1)
    dense = select_topk_matches(dual_softmax_confidence(ft0, ft1, TEMP), (12, 12), 0.05, 2, 64)
    fused = fused_select_topk_matches(ft0, ft1, TEMP, (12, 12), 0.05, 2, 64)
    assert _match_sets(fused) == _match_sets(dense)


@pytest.mark.parametrize("fused", [False, True])
def test_select_with_row_grid_matches_jax_two_sided(fused):
    """Image-pair matching (LoFTR): rows are a 12 x 12 grid too, and
    ``border_two_sided`` with ``row_grid_hw`` drops matches on the border of
    either grid. Rows planted on border cells of the row grid give no match."""
    # (row cell, column cell): interior pairs, border rows (0, 13, 131, 143)
    # and a border column (11)
    planted = [(0, 50), (13, 60), (131, 70), (143, 80), (26, 11), (30, 40), (40, 90), (52, 100),
               (64, 30), (77, 66), (90, 101), (100, 29)]
    f0, f1 = make_feats(p=144, l=144, seed=7, planted=planted)
    if fused:
        ref = jax_fused_select(jnp.asarray(f0), jnp.asarray(f1), TEMP, (12, 12), 0.0, 2, 64,
                               border_two_sided=True, row_grid_hw=(12, 12), interpret=True)
        got = fused_select_topk_matches(torch.from_numpy(f0), torch.from_numpy(f1), TEMP, (12, 12),
                                        0.0, 2, 64, border_two_sided=True, row_grid_hw=(12, 12))
    else:
        conf = dual_softmax_confidence(torch.from_numpy(f0), torch.from_numpy(f1), TEMP)
        ref = jax_select(jnp.asarray(conf.numpy()), (12, 12), 0.0, 2, 64, border_two_sided=True,
                         row_grid_hw=(12, 12))
        got = select_topk_matches(conf, (12, 12), 0.0, 2, 64, border_two_sided=True,
                                  row_grid_hw=(12, 12))
    sets = _match_sets(got)
    assert sets == _match_sets(ref)
    for s in sets:
        assert {(30, 40), (40, 90), (52, 100), (64, 30), (77, 66), (90, 101), (100, 29)} <= s
        assert not any(row in (0, 13, 131, 143, 26) for row, _ in s)  # border row or column
    with pytest.raises(ValueError):  # the row grid must cover every row
        fused_select_topk_matches(torch.from_numpy(f0), torch.from_numpy(f1), TEMP, (12, 12), 0.0, 2,
                                  64, row_grid_hw=(10, 12))
