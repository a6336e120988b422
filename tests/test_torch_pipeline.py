"""The port's query-pose slice as a whole against the JAX pipeline.

- ``run_inference`` with a matcher that projects the 3D points through the GT
  pose (the torch twin of ``test_inference.MockMatcherModel``, drawing the same
  numpy correspondences) recovers the GT poses, and agrees with the JAX
  ``run_inference`` on the same scene.
- ``make_query_step`` with the narrow real model and bridged weights feeds PnP
  the same confident matches as the JAX step.
"""
import jax
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.inference.pipeline import (
    make_query_step as jax_make_query_step,
    run_inference as jax_run_inference,
)
from onepose_plus_plus_tpu.models.onepose_plus import OnePosePlusModel as JaxModel
from onepose_plus_plus_tpu_torch.inference.pipeline import make_query_step, run_inference
from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel
from onepose_plus_plus_tpu_torch.utils.weights import load_jax_variables
from synthetic_scenes import make_scene
from test_inference import MockMatcherModel
from test_torch_model import NARROW, _forward_inputs, _perturbed

torch.set_num_threads(2)


class TorchMockMatcher:
    """'Matches' by projecting the 3D points with a hidden GT pose per frame."""

    def __init__(self, gt_poses, noise=0.5, n_matches=128):
        self.gt_poses, self.noise, self.n_matches = gt_poses, noise, n_matches

    def __call__(self, batch):
        kpts3d, K = batch["keypoints3d"], batch["intrinsics"]
        b, s, _ = kpts3d.shape
        rng = np.random.default_rng(0)
        k = self.n_matches
        idx = np.stack([rng.choice(s, k, replace=False) for _ in range(b)])
        noise = rng.normal(0, self.noise, (b, k, 2)).astype(np.float32)
        Ts = torch.tensor(np.stack([self.gt_poses[i % len(self.gt_poses)] for i in range(b)]),
                          dtype=torch.float32)
        pts = torch.gather(kpts3d, 1, torch.from_numpy(idx)[..., None].expand(-1, -1, 3))
        pc = torch.einsum("bij,bkj->bki", Ts[:, :3, :3], pts) + Ts[:, None, :3, 3]
        uvw = torch.einsum("bij,bkj->bki", K, pc)
        return {
            "mkpts_3d": pts,
            "mkpts_query_f": uvw[..., :2] / uvw[..., 2:3] + torch.from_numpy(noise),
            "mconf": torch.ones(b, k),
            "match_mask": torch.ones(b, k, dtype=torch.bool),
        }


def _rot_err_deg(Ra, Rb):
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64), axis=(-2, -1))
    return np.rad2deg(2 * np.arcsin(np.clip(d / (2 * np.sqrt(2)), 0, 1)))


def test_run_inference_recovers_gt_and_agrees_with_jax():
    rng = np.random.default_rng(3)
    n_frames = 4
    K, pts, Ts = make_scene(rng, n_views=n_frames, n_pts=400)
    anno = {
        "keypoints3d": pts.astype(np.float32),
        "descriptors3d": rng.standard_normal((400, 8)).astype(np.float32),
    }
    frames = [{"image": np.zeros((64, 64), np.float32), "K": K.astype(np.float32),
               "pose_gt": Ts[i].astype(np.float32)} for i in range(n_frames)]
    gts = [Ts[i] for i in range(n_frames)]
    kw = dict(shape3d=512, frame_batch=4, reproj_threshold_px=3.0)
    res = run_inference(TorchMockMatcher(gts), frames, anno, device=torch.device("cpu"), **kw)
    assert res.poses.shape == (n_frames, 4, 4) and res.ok.all()
    assert (res.R_errs < 1.0).all() and (res.t_errs < 2.0).all()
    assert res.metrics["5cm@5degree"] == 1.0
    assert (res.num_matches == 128).all()
    ref = jax_run_inference(MockMatcherModel(gts), {}, frames, anno, **kw)
    assert ref.ok.all()
    assert (_rot_err_deg(res.poses[:, :3, :3], ref.poses[:, :3, :3]) < 0.5).all()
    assert (np.linalg.norm(res.poses[:, :3, 3] - ref.poses[:, :3, 3], axis=-1) * 100 < 1.0).all()
    np.testing.assert_allclose(res.R_errs, ref.R_errs, atol=0.5)


def test_run_inference_without_gt():
    rng = np.random.default_rng(4)
    K, pts, Ts = make_scene(rng, n_views=3, n_pts=300)
    anno = {"keypoints3d": pts.astype(np.float32),
            "descriptors3d": rng.standard_normal((300, 8)).astype(np.float32)}
    frames = [{"image": np.zeros((64, 64), np.uint8), "K": K.astype(np.float32)} for _ in range(3)]
    res = run_inference(TorchMockMatcher([Ts[0], Ts[1]]), frames, anno, shape3d=400,
                        frame_batch=2, device=torch.device("cpu"))
    assert res.metrics is None and res.R_errs is None
    assert res.poses.shape == (3, 4, 4) and res.num_matches.shape == (3,)


@pytest.mark.parametrize("unbatched_point_cloud", [False, True])
def test_query_step_matches_jax_step(unbatched_point_cloud):
    """The narrow real model with bridged weights: same confident matches into
    PnP as the JAX step on the same inputs (uint8 frames, normalised in-step)."""
    batch = _forward_inputs(False)
    del batch["query_image_scale"]
    batch["query_image"] = (batch["query_image"] * 255).astype(np.uint8)
    batch["intrinsics"] = np.tile(np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]], np.float32),
                                  (2, 1, 1))
    if unbatched_point_cloud:
        for k in ("keypoints3d", "descriptors3d", "descriptors3d_coarse"):
            batch[k] = batch[k][0]
    jmodel = JaxModel(NARROW)
    init_batch = dict(batch, query_image=batch["query_image"].astype(np.float32) / 255.0)
    for k in ("keypoints3d", "descriptors3d", "descriptors3d_coarse"):
        init_batch[k] = np.broadcast_to(init_batch[k], (2,) + init_batch[k].shape[-2:])
    variables = _perturbed(jax.jit(lambda k, b: jmodel.init(k, b, train=False))(
        jax.random.PRNGKey(0), init_batch))
    ref = jax_make_query_step(jmodel, variables, num_hypotheses=64)(batch, jax.random.PRNGKey(0), None)

    port = OnePosePlusModel(NARROW).eval()
    load_jax_variables(port, variables)
    gen = torch.Generator()
    gen.manual_seed(0)
    out = make_query_step(port, num_hypotheses=64)(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}, gen, None)
    assert len(out) == len(ref) == 6
    np.testing.assert_array_equal(out[5].numpy(), np.asarray(ref[5]))
    assert out[0].shape == (2, 4, 4) and torch.isfinite(out[0]).all()
    assert torch.isnan(out[3]).all() and torch.isnan(out[4]).all()  # no GT given
