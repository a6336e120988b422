"""Port parity of the training path's building blocks against the JAX package.

K4's plain version (the window gather's VJP), the log-space dual softmax, GT
padding, BatchNorm in train mode, and the configs the port defines because
their JAX modules load JAX (``LossConfig``, ``TrainConfig``,
``onepose_config_from_dict``).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from onepose_plus_plus_tpu.models.backbone import _BN as JaxBN
from onepose_plus_plus_tpu.models.build import onepose_config_from_dict as jax_config_from_dict
from onepose_plus_plus_tpu.ops.matching import (
    CoarseMatches as JaxMatches,
    dual_softmax_log_confidence as jax_log_confidence,
    pad_matches_with_gt as jax_pad,
)
from onepose_plus_plus_tpu.ops.window_gather import gather_windows_aligned as jax_gather
from onepose_plus_plus_tpu.train.losses import LossConfig as JaxLossConfig
from onepose_plus_plus_tpu.train.train_step import TrainConfig as JaxTrainConfig
from onepose_plus_plus_tpu_torch import kernels
from onepose_plus_plus_tpu_torch.models.backbone import _BN
from onepose_plus_plus_tpu_torch.models.build import onepose_config_from_dict
from onepose_plus_plus_tpu_torch.ops.cuda_gather import window_scatter
from onepose_plus_plus_tpu_torch.ops.matching import (
    CoarseMatches,
    dual_softmax_log_confidence,
    pad_matches_with_gt,
    sample_gt_rows,
)
from onepose_plus_plus_tpu_torch.ops.window_gather import gather_windows_aligned
from onepose_plus_plus_tpu_torch.train.losses import LossConfig
from onepose_plus_plus_tpu_torch.train.train_step import TrainConfig
from port_helpers import to_port_config

torch.set_num_threads(2)


# ------------------------------------------------------------------ K4


@pytest.mark.parametrize("grid,stride,window", [((8, 8), 4, 5), ((5, 7), 4, 9), ((6, 10), 2, 5)])
def test_k4_plain_matches_jax_vjp(grid, stride, window):
    """Gradient of the window gather in feat against ``jax.vjp`` of the JAX
    gather (train=True; the one-hot path on the CPU), with duplicate ids,
    overlapping windows, -1 and out-of-range ids. Exact up to f32 summation
    order: atol 1e-6, plus rtol 1e-6 (two ulps) for the 9x9 windows, where up
    to nine windows and their duplicates add onto one pixel."""
    rng = np.random.default_rng(1)
    h_c, w_c = grid
    n, k, c = 2, 60, 16
    feat = rng.standard_normal((n, stride * h_c, stride * w_c, c)).astype(np.float32)
    ids = rng.integers(0, h_c * w_c, (n, k)).astype(np.int32)
    ids[:, :4] = [-1, h_c * w_c, 0, h_c * w_c + 7]
    ids[:, 30:45] = ids[:, 4:19]  # repeated cells, as GT-padded slots repeat predictions
    cot = rng.standard_normal((n, k, window * window, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jax_gather(f, jnp.asarray(ids), grid, stride, window, train=True),
                     jnp.asarray(feat))
    (ref,) = vjp(jnp.asarray(cot))
    f = torch.from_numpy(feat).requires_grad_()
    out = gather_windows_aligned(f, torch.from_numpy(ids), grid, stride, window)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_k4_wrapper_runs_plain_on_cpu_and_drops_bad_ids():
    kernels.reset_launch_counts()
    grad = torch.ones(1, 3, 25, 8)
    out = window_scatter(grad, torch.tensor([[-1, 16, 99]]), (4, 4), 4, 5, (16, 16))
    assert not out.any()
    assert kernels.launch_counts()["K4_window_scatter"] == 0
    # two slots on one cell: every tap of the window counts twice
    out = window_scatter(grad[:, :2], torch.tensor([[5, 5]]), (4, 4), 4, 5, (16, 16))
    assert out.sum().item() == 2 * 25 * 8 and out.max().item() == 2


# --------------------------------------------------------- dual softmax


def test_dual_softmax_log_confidence_matches_jax():
    rng = np.random.default_rng(2)
    f0 = rng.standard_normal((2, 40, 32)).astype(np.float32)
    f1 = rng.standard_normal((2, 30, 32)).astype(np.float32)
    mask1 = rng.random((2, 30)) > 0.2
    conf_j, log_j = jax_log_confidence(jnp.asarray(f0), jnp.asarray(f1), 0.08, mask1=jnp.asarray(mask1))
    conf, log_c = dual_softmax_log_confidence(torch.from_numpy(f0), torch.from_numpy(f1), 0.08,
                                              mask1=torch.from_numpy(mask1))
    # two f32 frameworks at temperature 0.08 (logits up to |46|, each exp off by
    # up to 46 x 6e-8 relative): measured max |d| 5.96e-7 on a confidence of
    # 0.85, 16 % of this bound and 60 % of a bare atol=1e-6, which tipped over
    # under other reduction orders
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_j), rtol=1e-5, atol=1e-6)
    valid = np.broadcast_to(mask1[:, None, :], log_c.shape)
    np.testing.assert_allclose(log_c.numpy()[valid], np.asarray(log_j)[valid], rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------ GT padding


def _gt_cells(rng, n, l, s, n_gt):
    gt = np.full((n, l), -1, np.int32)
    for b, m in enumerate(n_gt):
        rows = rng.choice(l, m, replace=False)
        gt[b, rows] = rng.integers(0, s, m)
    return gt


def test_pad_matches_assembly_matches_jax_on_injected_rows():
    """Frames with many GT rows, fewer GT rows than slots (wrap-around), and none."""
    rng = np.random.default_rng(3)
    n, l, s, k, num = 3, 50, 64, 6, 8
    gt = _gt_cells(rng, n, l, s, [30, 3, 0])
    pred = JaxMatches(
        jnp.asarray(rng.integers(0, l, (n, k)), jnp.int32), jnp.asarray(rng.integers(0, s, (n, k)), jnp.int32),
        jnp.asarray(rng.random((n, k)), jnp.float32), jnp.asarray(rng.random((n, k)) > 0.5),
    )
    key = jax.random.PRNGKey(5)
    ref = jax_pad(pred, jnp.asarray(gt), key, num)
    # the rows the JAX package sampled: its Gumbel top-k, replayed on the same key
    g = jax.random.gumbel(key, gt.shape)
    rows = np.asarray(jax.lax.top_k(jnp.where(jnp.asarray(gt) >= 0, g, -jnp.inf), num)[1])
    port_pred = CoarseMatches(*(torch.from_numpy(np.array(a)) for a in pred))
    got = pad_matches_with_gt(port_pred, torch.from_numpy(gt), num, rows=torch.from_numpy(rows))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gt_row_sampling_properties():
    rng = np.random.default_rng(4)
    n, l, s, num = 3, 60, 64, 10
    gt = torch.from_numpy(_gt_cells(rng, n, l, s, [40, 4, 0]))
    empty = CoarseMatches(torch.zeros(n, 0, dtype=torch.int32), torch.zeros(n, 0, dtype=torch.int32),
                          torch.zeros(n, 0), torch.zeros(n, 0, dtype=torch.bool))
    gen = torch.Generator().manual_seed(0)
    rows = sample_gt_rows(gt, num, gen)
    out = pad_matches_with_gt(empty, gt, num, rows=rows)
    # frame 0: n_gt >= num -> distinct GT rows, each slot on its row's GT cell
    assert len(set(out.i_ids[0].tolist())) == num
    assert bool((gt[0, out.i_ids[0].long()] >= 0).all())
    assert torch.equal(out.j_ids[0].long(), gt[0, out.i_ids[0].long()].long())
    # frame 1: 4 GT rows for 10 slots -> all four, then the last one repeated
    i1 = out.i_ids[1].tolist()
    assert set(i1) == set(torch.nonzero(gt[1] >= 0)[:, 0].tolist())
    assert i1[3:] == [i1[3]] * (num - 3)
    # frame 2: no GT -> mask all false; every slot has mconf 0
    assert out.mask[:2].all() and not out.mask[2].any()
    assert not out.mconf.any()
    # a different generator state draws a different sample
    assert not torch.equal(sample_gt_rows(gt, num, gen)[0], rows[0])


# ------------------------------------------------------------- BatchNorm


def test_batchnorm_train_mode_matches_flax():
    """Output and updated running statistics after one train-mode forward equal
    flax's: momentum 0.9 and the BIASED batch variance (torch's F.batch_norm
    would update with the unbiased one)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 3, 3, 4)) * 2 + 0.5).astype(np.float32)  # NHWC
    bn = JaxBN()
    variables = bn.init(jax.random.PRNGKey(0), x, False)
    mean0 = (0.1 * rng.standard_normal(4)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(4)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(4)).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean0, "var": var0}}}
    ref, upd = bn.apply(variables, x, True, mutable=["batch_stats"])
    port = _BN(4)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    port.train()
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    stats = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    # the biased variance is what separates the two frameworks' rules
    unbiased = 0.9 * var0 + 0.1 * x.reshape(-1, 4).var(axis=0, ddof=1)
    assert np.abs(port.running_var.numpy() - unbiased).max() > 1e-3
    # eval mode normalises with the running statistics and leaves them alone
    port.eval()
    before = port.running_var.clone()
    port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(port.running_var, before)


# --------------------------------------------------------------- configs


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_loss_and_train_configs_equal_jax():
    assert _fields(LossConfig) == _fields(JaxLossConfig)
    assert [f.name for f in dataclasses.fields(TrainConfig)] == [f.name for f in dataclasses.fields(JaxTrainConfig)]
    for f in dataclasses.fields(TrainConfig):
        if f.name != "loss":
            assert f.default == getattr(JaxTrainConfig, f.name), f.name
    assert dataclasses.asdict(TrainConfig().loss) == dataclasses.asdict(JaxTrainConfig().loss)
    assert TrainConfig(canonical_bs=4).true_lr(8) == JaxTrainConfig(canonical_bs=4).true_lr(8)


@pytest.mark.parametrize("overrides", [
    {},
    {"loftr_coarse": {"layer_iter_n": 1}, "match_coarse": {"max_matches": 16, "train_max_matches": 16,
                                                           "train_pad_num_gt_min": 4}},
    {"compute_dtype": "bfloat16", "loftr_fine": {"window_size": 7, "d_model": 64},
     "loftr_backbone": {"block_dims": [64, 96, 128]}, "keypoints_encoding": {"enable": False}},
])
def test_config_from_dict_equals_jax(overrides):
    with open(Path(__file__).resolve().parent.parent / "configs/experiment/train.yaml") as f:
        model = yaml.safe_load(f)["model"] or {}
    d = {**model, **overrides}
    # each package builds its own config classes (the port keeps a copy)
    assert onepose_config_from_dict(d) == to_port_config(jax_config_from_dict(d))
