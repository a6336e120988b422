"""Batched query-pose inference (port of ``onepose_plus_plus_tpu/inference/pipeline.py``).

One step takes a batch of query frames through the matcher forward
(``OnePosePlusModel``, kernels K1-K3), batched RANSAC-PnP and the pose errors,
all on the model's device; frames stream through in batches of
``frame_batch`` and the host only stacks inputs and copies results back.

Over a data-parallel mesh (``parallel.mesh.Mesh``: one process a rank, one
device each) every rank runs its share of each batch, as the JAX package's
mesh run shards the batch over its devices, and every rank returns the whole
result.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.preprocessing import pad_point_cloud
from ..eval.metrics import aggregate_metrics, batched_pose_errors
from ..geometry.pnp import PnPGraphs, sample_hypotheses
from ..parallel.mesh import Mesh
from ..utils.profiling import annotate


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

    Returns ``step(batch, generator, pose_gt or None, rows=None)`` ->
    (poses [B, 4, 4], num_inliers [B], ok [B], R_err [B], t_err [B],
    num_matches [B]), tensors on the batch's device; GT errors are NaN when
    pose_gt is None. ``batch`` carries query_image [B, H, W, 1] (float, or
    uint8 normalised here), keypoints3d, descriptors3d and optional
    descriptors3d_coarse ([B, S, ...], or [S, ...] for one object shared by
    every frame), and intrinsics [B, 3, 3]. ``generator`` is a
    ``torch.Generator`` on the batch's device (RANSAC sampling). ``rows``
    (first, total): the batch is rows [first, first + B) of a batch of
    ``total`` split over ranks; RANSAC draws the whole batch's samples and
    keeps these rows.

    The step draws RANSAC's samples eagerly and solves them through its own
    ``geometry.pnp.PnPGraphs``: one CUDA graph replay at a batch shape it
    has seen before.
    """
    pnp = PnPGraphs()

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor], generator: torch.Generator,
             pose_gt: Optional[torch.Tensor], rows: Optional[Tuple[int, int]] = None):
        with annotate("query_step"):
            batch = dict(batch)
            img = batch["query_image"]
            b = img.shape[0]
            with annotate("query_step.forward"):
                if img.dtype == torch.uint8:
                    batch["query_image"] = img.float() / 255.0
                for k in ("keypoints3d", "descriptors3d", "descriptors3d_coarse"):
                    # the object's point cloud is frame-invariant: accept it unbatched
                    if k in batch and batch[k].dim() == 2:
                        batch[k] = batch[k][None].expand(b, *batch[k].shape)
                out = model(batch)
            with annotate("query_step.pnp"):
                mask = out["match_mask"].bool() & (out["mconf"] > conf_threshold)
                sample_idx, sub_idx = sample_hypotheses(mask, generator, num_hypotheses=num_hypotheses,
                                                        prescore_subset=prescore_subset, rows=rows)
                res = pnp(
                    out["mkpts_3d"], out["mkpts_query_f"], batch["intrinsics"], mask, sample_idx, sub_idx,
                    reproj_threshold_px=reproj_threshold_px, planar_hypotheses=planar_hypotheses,
                    p3p_hypotheses=p3p_hypotheses, p3p_samples=p3p_samples, rescore_top=rescore_top,
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
    mesh: Optional[Mesh] = None,
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
        mesh: this rank of a data-parallel mesh (``parallel.mesh.make_mesh``;
            every rank calls with the same frames, and the caller owns the
            process group). The model and the point cloud live on
            ``mesh.device``; rank r runs frames [r b, (r + 1) b) of each
            padded batch, b = frame_batch / world (every rank runs the whole
            batch where world does not divide frame_batch), and the results
            are gathered once, so that every rank returns the whole result,
            equal to a single process's.
        step: a prebuilt :func:`make_query_step` step to reuse across objects.
    """
    if mesh is not None:
        device = mesh.device
    elif device is None:
        device = next(model.parameters()).device
    frames = list(frames)
    with annotate("run_inference", frames=len(frames)):
        with annotate("run_inference.cloud"):
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
        has_gt = all("pose_gt" in f for f in frames)
        generator = torch.Generator(device=device)
        generator.manual_seed(rng_seed)
        # this rank's rows of each padded batch; every rank runs the whole batch
        # where the world does not divide it (JAX's shard_batch replicates it)
        split = mesh is not None and frame_batch % mesh.world == 0
        b = frame_batch // mesh.world if split else frame_batch
        first = mesh.rank * b if split else 0
        rows = (first, frame_batch) if split else None

        outs = []
        for s in range(0, len(frames), frame_batch):
            chunk = frames[s:s + frame_batch]
            chunk_p = (chunk + [chunk[-1]] * (frame_batch - len(chunk)))[first:first + b]
            with annotate("run_inference.batch", frames=len(chunk_p)):
                with annotate("run_inference.stack"):
                    imgs = np.stack([f["image"][..., None] for f in chunk_p], 0)
                    if imgs.dtype != np.uint8:
                        imgs = imgs.astype(np.float32)
                    K = np.stack([f["K"] for f in chunk_p]).astype(np.float32)
                    gt = np.stack([f["pose_gt"] for f in chunk_p]).astype(np.float32) if has_gt else None
                with annotate("run_inference.h2d"):
                    batch = {"query_image": torch.from_numpy(imgs).to(device),
                             "intrinsics": torch.from_numpy(K).to(device), **pc}
                    gt = torch.from_numpy(gt).to(device) if has_gt else None
                res = step(batch, generator, gt, rows)
                # a rank's shards stay on its device until the one gather below
                outs.append(res if split else [r[:len(chunk)].cpu().numpy() for r in res])
        if split and outs:
            with annotate("run_inference.gather"):
                outs = [_gather_frames(outs, len(frames), mesh.world)]

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


_POSE_WORDS = 16  # a frame's row in the gather: the pose's 16 words, then one word per other output


def _gather_frames(outs: List[Sequence[torch.Tensor]], n_frames: int, world: int) -> List[np.ndarray]:
    """Every rank's rows of every batch, in frame order, without the padding.

    ``outs`` are this rank's step outputs, one tuple a batch. Each frame
    becomes one int32 row (float32 outputs as their bits, so the gather is
    exact) and all batches go in one all-gather of fixed shape."""
    local = torch.cat([
        torch.cat([poses.reshape(len(poses), _POSE_WORDS).view(torch.int32)]
                  + [(x.view(torch.int32) if x.dtype == torch.float32 else x.to(torch.int32))[:, None]
                     for x in rest], dim=1)
        for poses, *rest in outs])
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local)
    # [rank, batch, row] -> [batch, rank, row]: rank r holds rows [r b, (r + 1) b) of every batch
    cols = local.shape[1]
    table = torch.stack(parts).reshape(world, len(outs), -1, cols).transpose(0, 1).reshape(-1, cols)
    table = table[:n_frames].cpu()
    f32 = lambda c: table[:, c].view(torch.float32).numpy()  # noqa: E731
    p = _POSE_WORDS
    return [table[:, :p].contiguous().view(torch.float32).reshape(-1, 4, 4).numpy(),
            table[:, p].numpy(), table[:, p + 1].bool().numpy(), f32(p + 2), f32(p + 3),
            table[:, p + 4].numpy()]
