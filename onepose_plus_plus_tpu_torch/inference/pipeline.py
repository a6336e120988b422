"""Batched query-pose inference (port of ``onepose_plus_plus_tpu/inference/pipeline.py``).

One step takes a batch of query frames through the matcher forward
(``OnePosePlusModel``, kernels K1-K3), batched RANSAC-PnP and the pose errors,
all on the model's device; frames stream through in batches of
``frame_batch`` and the host only stacks inputs and copies results back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..data.preprocessing import pad_point_cloud
from ..eval.metrics import aggregate_metrics, batched_pose_errors
from ..geometry.pnp import ransac_pnp


@dataclasses.dataclass
class InferenceResult:
    poses: np.ndarray  # [F, 4, 4] predicted world->cam
    num_inliers: np.ndarray  # [F]
    ok: np.ndarray  # [F] bool
    num_matches: Optional[np.ndarray] = None  # [F] confident matches into PnP
    R_errs: Optional[np.ndarray] = None  # [F] deg (when GT given)
    t_errs: Optional[np.ndarray] = None  # [F] cm
    metrics: Optional[dict] = None


def make_query_step(
    model: Callable[[Dict[str, torch.Tensor]], dict],
    reproj_threshold_px: float = 3.3,
    num_hypotheses: int = 512,
    conf_threshold: float = 0.0,
    planar_hypotheses: bool = True,
    p3p_hypotheses: bool = True,
    p3p_samples: int = 128,
    prescore_subset: int = 128,
    rescore_top: int = 64,
):
    """Build the batched (match + PnP [+ errors]) step.

    Returns ``step(batch, generator, pose_gt or None)`` ->
    (poses [B, 4, 4], num_inliers [B], ok [B], R_err [B], t_err [B],
    num_matches [B]), tensors on the batch's device; GT errors are NaN when
    pose_gt is None. ``batch`` carries query_image [B, H, W, 1] (float, or
    uint8 normalised here), keypoints3d, descriptors3d and optional
    descriptors3d_coarse ([B, S, ...], or [S, ...] for one object shared by
    every frame), and intrinsics [B, 3, 3]. ``generator`` is a
    ``torch.Generator`` on the batch's device (RANSAC sampling).
    """

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor], generator: torch.Generator,
             pose_gt: Optional[torch.Tensor]):
        batch = dict(batch)
        img = batch["query_image"]
        if img.dtype == torch.uint8:
            batch["query_image"] = img.float() / 255.0
        b = img.shape[0]
        for k in ("keypoints3d", "descriptors3d", "descriptors3d_coarse"):
            # the object's point cloud is frame-invariant: accept it unbatched
            if k in batch and batch[k].dim() == 2:
                batch[k] = batch[k][None].expand(b, *batch[k].shape)
        out = model(batch)
        mask = out["match_mask"].bool() & (out["mconf"] > conf_threshold)
        res = ransac_pnp(
            out["mkpts_3d"], out["mkpts_query_f"], batch["intrinsics"], mask, generator,
            reproj_threshold_px=reproj_threshold_px, num_hypotheses=num_hypotheses,
            planar_hypotheses=planar_hypotheses, p3p_hypotheses=p3p_hypotheses,
            p3p_samples=p3p_samples, prescore_subset=prescore_subset, rescore_top=rescore_top,
        )
        poses = torch.eye(4, dtype=torch.float32, device=img.device).repeat(b, 1, 1)
        poses[:, :3, :3] = res.R
        poses[:, :3, 3] = res.t
        n_match = mask.sum(dim=-1).to(torch.int32)
        if pose_gt is None:
            nan = torch.full((b,), float("nan"), device=img.device)
            return poses, res.num_inliers, res.ok, nan, nan, n_match
        R_err, t_err = batched_pose_errors(poses, pose_gt)
        return poses, res.num_inliers, res.ok, R_err, t_err, n_match

    return step


def run_inference(
    model: torch.nn.Module,
    frames: Iterable[dict],
    annotation: Dict[str, np.ndarray],
    shape3d: int = 7000,
    frame_batch: int = 16,
    reproj_threshold_px: float = 3.3,
    num_hypotheses: int = 512,
    pose_thresholds=(1, 3, 5),
    rng_seed: int = 0,
    step=None,
    device: Optional[torch.device] = None,
) -> InferenceResult:
    """Run the batched query pipeline over an object's frames.

    Args:
        model: the matcher (its device is used unless ``device`` is given).
        frames: dicts with ``image`` [H, W] (float in [0, 1] or uint8),
            ``K`` [3, 3] and optional ``pose_gt`` [4, 4].
        annotation: the object's SfM annotation, ``keypoints3d`` [m, 3],
            ``descriptors3d`` [m, Cf], optional ``descriptors3d_coarse`` [m, C].
        step: a prebuilt :func:`make_query_step` step to reuse across objects.
    """
    if device is None:
        device = next(model.parameters()).device
    gen = np.random.default_rng(rng_seed)
    fine = pad_point_cloud(annotation["keypoints3d"], annotation["descriptors3d"],
                           annotation.get("scores3d"), shape3d, gen)
    pc = {
        "keypoints3d": torch.from_numpy(fine["keypoints3d"]).to(device),
        "descriptors3d": torch.from_numpy(fine["descriptors3d"]).to(device),
    }
    if "descriptors3d_coarse" in annotation:
        coarse = pad_point_cloud(annotation["keypoints3d"], annotation["descriptors3d_coarse"],
                                 annotation.get("scores3d_coarse"), shape3d,
                                 np.random.default_rng(rng_seed))  # same subsample as fine
        pc["descriptors3d_coarse"] = torch.from_numpy(coarse["descriptors3d"]).to(device)
    if step is None:
        step = make_query_step(model, reproj_threshold_px=reproj_threshold_px,
                               num_hypotheses=num_hypotheses)
    frames = list(frames)
    has_gt = all("pose_gt" in f for f in frames)
    generator = torch.Generator(device=device)
    generator.manual_seed(rng_seed)

    outs = []
    for s in range(0, len(frames), frame_batch):
        chunk = frames[s:s + frame_batch]
        chunk_p = chunk + [chunk[-1]] * (frame_batch - len(chunk))
        imgs = np.stack([f["image"][..., None] for f in chunk_p], 0)
        if imgs.dtype != np.uint8:
            imgs = imgs.astype(np.float32)
        batch = {
            "query_image": torch.from_numpy(imgs).to(device),
            "intrinsics": torch.from_numpy(
                np.stack([f["K"] for f in chunk_p]).astype(np.float32)).to(device),
            **pc,
        }
        gt = (torch.from_numpy(np.stack([f["pose_gt"] for f in chunk_p]).astype(np.float32)).to(device)
              if has_gt else None)
        res = step(batch, generator, gt)
        outs.append([r[:len(chunk)].cpu().numpy() for r in res])

    cat = lambda i, empty: np.concatenate([o[i] for o in outs]) if outs else empty  # noqa: E731
    result = InferenceResult(
        poses=cat(0, np.zeros((0, 4, 4))),
        num_inliers=cat(1, np.zeros(0, np.int32)),
        ok=cat(2, np.zeros(0, bool)),
        num_matches=cat(5, np.zeros(0, np.int32)),
    )
    if has_gt and frames:
        result.R_errs, result.t_errs = cat(3, None), cat(4, None)
        result.metrics = aggregate_metrics(result.R_errs, result.t_errs,
                                           pose_thresholds=pose_thresholds)
    return result
