"""Port parity of the train step: gradients of the whole loss against the JAX
package on both coarse-loss routes, and the port's own train step and resume
round trip. (The optimizer is held to optax in test_torch_train_optim.py.)

The model is ``tests/test_train.py``'s tiny config; weights come from the JAX
init (norms and BatchNorm statistics perturbed) through ``utils/weights.py``;
GT padding takes the rows the JAX package samples (its Gumbel top-k on a fixed
key, replayed here), so both see the same match slots.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onepose_plus_plus_tpu.models.onepose_plus as jax_onepose
from onepose_plus_plus_tpu.config import (
    CoarseMatchingConfig,
    FineConfig,
    OnePosePlusConfig,
    TransformerConfig,
)
from onepose_plus_plus_tpu.ops.matching import pad_matches_with_gt as jax_pad
from onepose_plus_plus_tpu.train import losses as jl
from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel
from onepose_plus_plus_tpu_torch.train.losses import LossConfig, compute_losses
from onepose_plus_plus_tpu_torch.train.train_step import (
    TrainConfig,
    make_optimizer,
    train_step,
)
from onepose_plus_plus_tpu_torch.utils.checkpoint import restore_train_state, save_train_state
from onepose_plus_plus_tpu_torch.utils.weights import (
    load_jax_variables,
    random_state_dict,
    state_dict_from_jax,
)
from test_torch_model import _perturbed

torch.set_num_threads(2)

PAD_KEY = jax.random.PRNGKey(11)


def _tiny_cfg(fused, thr=0.1):
    return OnePosePlusConfig(
        coarse=TransformerConfig(d_model=256, nhead=8, layer_iter_n=1),
        coarse_matching=CoarseMatchingConfig(thr=thr, max_matches=16, train_max_matches=16,
                                             train_pad_num_gt_min=4, use_fused_kernel=fused),
        fine=FineConfig(transformer=TransformerConfig(d_model=128, nhead=8, layer_iter_n=1)),
    )


def _batch(seed=1, n=2, img=64, l=32):
    """A batch whose GT fine locations lie inside their GT cells, so the fine
    loss (and K4's path) carries gradient."""
    rng = np.random.default_rng(seed)
    w_c = img // 8
    gt_cell = np.where(rng.random((n, l)) < 0.7, rng.integers(0, w_c * w_c, (n, l)), -1).astype(np.int32)
    cell = np.maximum(gt_cell, 0)
    centre = np.stack([cell % w_c, cell // w_c], -1) * 8.0
    return {
        "query_image": rng.random((n, img, img, 1), np.float32),
        "keypoints3d": rng.standard_normal((n, l, 3)).astype(np.float32),
        "descriptors3d": rng.standard_normal((n, l, 128)).astype(np.float32),
        "descriptors3d_coarse": rng.standard_normal((n, l, 256)).astype(np.float32),
        "gt_cell": gt_cell,
        "gt_fine_xy": (centre + rng.uniform(-3, 3, (n, l, 2))).astype(np.float32),
    }


def _jax_pad_rows(gt_cell, num):
    g = jax.random.gumbel(PAD_KEY, gt_cell.shape)
    return np.asarray(jax.lax.top_k(jnp.where(jnp.asarray(gt_cell) >= 0, g, -jnp.inf), num)[1])


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_whole_loss_gradients_match_jax(fused, monkeypatch):
    """Every parameter's gradient of the train loss against ``jax.grad``, plus the
    loss scalars, the match slots and the updated BatchNorm statistics.

    Bounds, per tensor: relative (Frobenius) error <= 2e-2 and cosine >=
    0.9999 everywhere; max error <= 1e-3 of the tensor's largest gradient
    outside the backbone (dense, f32) or <= 2e-2 with cosine > 0.999 (fused,
    as tests/test_pallas_coarse_loss.py holds K5: the TPU kernel rounds dL/ds
    to bf16 before its products, the plain version does not). The backbone's
    conv and BatchNorm gradients in train mode come out of cancellation
    (BatchNorm subtracts the mean and the projection on x-hat): each package
    differs from a float64 run by a few percent of the largest entry there,
    so only the norm-wise bound applies to them.

    The fused route selects with K2 (bf16 operands in JAX, the compute dtype
    in the port); thr 0.5 keeps the predicted matches clear of the threshold
    so both select the same slots.
    """
    cfg = _tiny_cfg(fused, thr=0.5 if fused else 0.1)
    batch = _batch()
    num = cfg.coarse_matching.train_pad_num_gt_min
    monkeypatch.setattr(jax_onepose, "pad_matches_with_gt",
                        lambda m, gt, rng, k: jax_pad(m, gt, PAD_KEY, k))
    jmodel = jax_onepose.OnePosePlusModel(cfg)
    init = jax.jit(lambda k, b: jmodel.init({"params": k, "matching": k}, b, train=True))
    variables = _perturbed(init(jax.random.PRNGKey(0), batch))

    def loss_fn(params):
        out, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, batch,
                                train=True, rngs={"matching": PAD_KEY}, mutable=["batch_stats"])
        loss, scalars = jl.compute_losses(out, batch, jl.LossConfig(), cfg.fine.window_size)
        return loss, (scalars, upd["batch_stats"], out["i_ids"], out["j_ids"], out["match_mask"])

    grads, (ref_sc, ref_stats, *ref_slots) = jax.jit(jax.grad(loss_fn, has_aux=True))(variables["params"])

    port = OnePosePlusModel(cfg)
    load_jax_variables(port, variables)
    port.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = port(tb, gt_pad_rows=torch.from_numpy(_jax_pad_rows(batch["gt_cell"], num).copy()))
    loss, sc = compute_losses(out, tb, LossConfig(), cfg.fine.window_size)
    loss.backward()

    ref_i, ref_j, ref_mask = (np.asarray(a) for a in ref_slots)
    np.testing.assert_array_equal(out["match_mask"].numpy(), ref_mask)
    np.testing.assert_array_equal(out["i_ids"].numpy()[ref_mask], ref_i[ref_mask])
    np.testing.assert_array_equal(out["j_ids"].numpy()[ref_mask], ref_j[ref_mask])
    assert ref_mask[:, :-num].any()  # some predicted matches, besides the GT slots
    assert float(ref_sc["loss_f"]) > 0
    for k in ("loss", "loss_c", "loss_f", "max_conf"):
        np.testing.assert_allclose(float(sc[k].detach()), float(ref_sc[k]), rtol=2e-4 if fused else 1e-4,
                                   err_msg=k)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads),
                                "batch_stats": jax.tree_util.tree_map(np.asarray, ref_stats)})
    for name, p in port.named_parameters():
        ref = want[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        scale = np.abs(ref).max()
        if scale == 0:  # the fine stage's length-1 source skips q/k in both packages
            assert not got.any(), name
            continue
        cos = (got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref))
        assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref) and cos >= 0.9999, name
        if not name.startswith("backbone."):
            assert np.abs(got - ref).max() <= (2e-2 if fused else 1e-3) * scale, name
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


# -------------------------------------------------------- the port alone


def test_train_step_loss_falls_and_resumes(tmp_path):
    """Three steps on one batch lower the loss; a saved state restored into a
    fresh model and optimizer continues exactly like the original."""
    cfg = _tiny_cfg(None)
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=3).items()}
    tc = TrainConfig(canonical_lr=1e-3)
    model = OnePosePlusModel(cfg)
    model.load_state_dict(random_state_dict(model, seed=0))
    opt, sched = make_optimizer(model, tc, tc.true_lr(2), 10)
    gen = torch.Generator().manual_seed(0)
    losses = [float(train_step(model, opt, batch, gen, tc, sched)["loss"]) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]

    save_train_state(str(tmp_path / "last_state.pt"), model, opt, sched, step=3, epoch=1)
    fresh = OnePosePlusModel(cfg)
    fresh.load_state_dict(random_state_dict(fresh, seed=9))
    fopt, fsched = make_optimizer(fresh, tc, tc.true_lr(2), 10)
    assert restore_train_state(str(tmp_path / "last_state.pt"), fresh, fopt, fsched) == (3, 1)
    rows = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]])
    a = train_step(model, opt, batch, None, tc, sched, gt_pad_rows=rows)
    b = train_step(fresh, fopt, batch, None, tc, fsched, gt_pad_rows=rows)
    assert float(a["loss"]) == float(b["loss"])
    for (n, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), n
    for (n, p), q in zip(model.named_buffers(), fresh.buffers()):
        assert torch.equal(p, q), n
