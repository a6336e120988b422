"""Port parity: the training losses against ``onepose_plus_plus_tpu/train/losses.py``.

Same numpy inputs through both; values and gradients. f32 throughout, except
the fused coarse loss (K5's plain version against the JAX kernel in interpret
mode), which works on bf16-rounded features.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.ops.matching import dual_softmax_log_confidence as jax_log_confidence
from onepose_plus_plus_tpu.train import losses as jl
from onepose_plus_plus_tpu_torch.ops.matching import dual_softmax_log_confidence
from onepose_plus_plus_tpu_torch.train import losses as tl

torch.set_num_threads(2)


def _feats(seed, n=2, l=24, s=36, c=32, scale=1.0):
    rng = np.random.default_rng(seed)
    f0 = (rng.standard_normal((n, l, c)) * scale).astype(np.float32)
    f1 = (rng.standard_normal((n, s, c)) * scale).astype(np.float32)
    gt = np.where(rng.random((n, l)) < 0.5, rng.integers(0, s, (n, l)), -1).astype(np.int32)
    return f0, f1, gt


@pytest.mark.parametrize("log_space,weighted,scale", [
    (True, False, 1.0), (True, False, 4.0),  # 4.0: GT confidences far below 1e-6
    (False, False, 1.0), (True, True, 1.0), (False, True, 1.0),
])
def test_coarse_focal_loss_matches_jax(log_space, weighted, scale):
    f0, f1, gt = _feats(0, scale=scale)
    rng = np.random.default_rng(1)
    c_weight = rng.uniform(0.5, 1.5, (2, 24, 36)).astype(np.float32) if weighted else None
    jcfg = jl.LossConfig(log_space=log_space)
    tcfg = tl.LossConfig(log_space=log_space)

    def jax_fn(a):
        conf, log_conf = jax_log_confidence(a, jnp.asarray(f1), 0.08)
        return jl.coarse_focal_loss(conf, jnp.asarray(gt), jcfg,
                                    c_weight=None if c_weight is None else jnp.asarray(c_weight),
                                    log_conf=log_conf if log_space else None)

    ref, ref_g = jax.value_and_grad(jax_fn)(jnp.asarray(f0))
    a = torch.from_numpy(f0).requires_grad_()
    conf, log_conf = dual_softmax_log_confidence(a, torch.from_numpy(f1), 0.08)
    got = tl.coarse_focal_loss(conf, torch.from_numpy(gt), tcfg,
                               c_weight=None if c_weight is None else torch.from_numpy(c_weight),
                               log_conf=log_conf if log_space else None)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    ref_g = np.asarray(ref_g)
    # f32 softmax gradients in two frameworks: 1e-4 of the largest gradient
    np.testing.assert_allclose(a.grad.numpy(), ref_g, atol=1e-4 * np.abs(ref_g).max())


@pytest.mark.parametrize("scaled", [False, True])
def test_fine_supervision_matches_jax(scaled):
    rng = np.random.default_rng(2)
    n, l, k, hw_c = 2, 30, 12, (6, 8)
    gt_cell = np.where(rng.random((n, l)) < 0.7, rng.integers(0, 48, (n, l)), -1).astype(np.int32)
    gt_fine = (rng.random((n, l, 2)) * 60).astype(np.float32)
    i_ids = rng.integers(0, l, (n, k)).astype(np.int32)
    j_ids = np.where(rng.random((n, k)) < 0.5, np.take_along_axis(gt_cell, i_ids, 1),
                     rng.integers(0, 48, (n, k))).astype(np.int32)
    scale = np.array([[1.5, 2.0], [0.5, 1.0]], np.float32) if scaled else None
    ref = jl.fine_supervision(jnp.asarray(i_ids), jnp.asarray(j_ids), jnp.asarray(gt_cell),
                              jnp.asarray(gt_fine), hw_c, 8.0, 2.0, 5,
                              None if scale is None else jnp.asarray(scale))
    got = tl.fine_supervision(torch.from_numpy(i_ids), torch.from_numpy(j_ids), torch.from_numpy(gt_cell),
                              torch.from_numpy(gt_fine), hw_c, 8.0, 2.0, 5,
                              None if scale is None else torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_fine_l2_std_loss_matches_jax():
    rng = np.random.default_rng(3)
    n, k = 2, 20
    expec = np.concatenate([rng.uniform(-1, 1, (n, k, 2)), rng.uniform(0.1, 1.0, (n, k, 1))], -1).astype(np.float32)
    gt = rng.uniform(-1.5, 1.5, (n, k, 2)).astype(np.float32)
    mask = rng.random((n, k)) < 0.8
    cfg = jl.LossConfig()
    ref, ref_g = jax.value_and_grad(lambda e: jl.fine_l2_std_loss(e, jnp.asarray(gt), jnp.asarray(mask), cfg))(
        jnp.asarray(expec))
    e = torch.from_numpy(expec).requires_grad_()
    got = tl.fine_l2_std_loss(e, torch.from_numpy(gt), torch.from_numpy(mask), tl.LossConfig())
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    # the weight is detached: no gradient reaches the std channel
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ref_g), atol=1e-6)
    assert not e.grad[..., 2].any()


def _outputs(route, seed=4):
    """A train-mode output dict of either route, numpy, plus the batch."""
    rng = np.random.default_rng(seed)
    n, l, s, k, c = 2, 40, 48, 10, 32
    f0, f1, gt = _feats(seed, n, l, s, c)
    out = {
        "i_ids": rng.integers(0, l, (n, k)).astype(np.int32),
        "j_ids": rng.integers(0, s, (n, k)).astype(np.int32),
        "expec_f": np.concatenate([rng.uniform(-1, 1, (n, k, 2)), rng.uniform(0.1, 1, (n, k, 1))], -1).astype(np.float32),
        "match_mask": rng.random((n, k)) < 0.8,
    }
    out["j_ids"][:, :5] = np.take_along_axis(gt, out["i_ids"][:, :5], 1).clip(0)
    batch = {"gt_cell": gt, "gt_fine_xy": (rng.random((n, l, 2)) * 63).astype(np.float32)}
    return out, batch, f0, f1


@pytest.mark.parametrize("route", ["dense", "fused"])
def test_compute_losses_matches_jax(route):
    """Both routes of ``compute_losses``: the dense one on a log-space
    confidence, the fused one through K5's plain version against the JAX
    kernel (interpret mode; loss_c rtol 2e-4, as tests/test_pallas_coarse_loss.py)."""
    out, batch, f0, f1 = _outputs(route)
    j_out = {k: jnp.asarray(v) for k, v in out.items()}
    t_out = {k: torch.from_numpy(v) for k, v in out.items()}
    hw_c = (6, 8)
    j_out["hw_c"] = t_out["hw_c"] = hw_c
    if route == "dense":
        conf, log_conf = jax_log_confidence(jnp.asarray(f0), jnp.asarray(f1), 0.08)
        j_out.update(conf_matrix=conf, log_conf_matrix=log_conf)
        conf, log_conf = dual_softmax_log_confidence(torch.from_numpy(f0), torch.from_numpy(f1), 0.08)
        t_out.update(conf_matrix=conf, log_conf_matrix=log_conf)
        rtol = 1e-5
    else:
        j_out["coarse_loss_ctx"] = {"feats": (jnp.asarray(f0), jnp.asarray(f1)), "temperature": 0.08,
                                    "feat_norm": "sqrt_feat_dim"}
        t_out["coarse_loss_ctx"] = {"feats": (torch.from_numpy(f0), torch.from_numpy(f1)),
                                    "temperature": 0.08, "feat_norm": "sqrt_feat_dim"}
        rtol = 2e-4
    _, ref = jl.compute_losses(j_out, {k: jnp.asarray(v) for k, v in batch.items()}, jl.LossConfig(), 5)
    _, got = tl.compute_losses(t_out, {k: torch.from_numpy(v) for k, v in batch.items()}, tl.LossConfig(), 5)
    assert set(got) == set(ref) == {"loss", "loss_c", "loss_f", "max_conf"}
    assert float(ref["loss_f"]) > 0
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=rtol, err_msg=k)


def test_fused_route_keeps_jax_errors():
    out, batch, f0, f1 = _outputs("fused")
    t_out = {k: torch.from_numpy(v) for k, v in out.items()}
    t_out["hw_c"] = (6, 8)
    t_out["coarse_loss_ctx"] = {"feats": (torch.from_numpy(f0), torch.from_numpy(f1)),
                                "temperature": 0.08, "feat_norm": "sqrt_feat_dim"}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="c_weight"):
        tl.compute_losses(t_out, {**tb, "c_weight": torch.ones(2, 40, 48)}, tl.LossConfig(), 5)
    with pytest.raises(ValueError, match="log-space"):
        tl.compute_losses(t_out, tb, dataclasses.replace(tl.LossConfig(), log_space=False), 5)
    assert tl.effective_fine_weight(tl.LossConfig(), 9) == jl.effective_fine_weight(jl.LossConfig(), 9)
