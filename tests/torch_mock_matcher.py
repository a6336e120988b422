"""The torch twin of ``test_inference.MockMatcherModel`` (no JAX import, so
that spawned ranks can load it)."""
import numpy as np
import torch

from onepose_plus_plus_tpu_torch.parallel import comm


class TorchMockMatcher:
    """'Matches' by projecting the 3D points with a hidden GT pose per frame.

    The correspondences of frame i of a batch are drawn from one numpy
    generator for the whole batch. With ``frame_batch`` given, a rank that
    holds its share of a batch of ``frame_batch`` split over the ranks draws
    for the whole batch and keeps its rows, as the JAX mock, traced at the
    global batch on a mesh, does."""

    def __init__(self, gt_poses, noise=0.5, n_matches=128, frame_batch=None):
        self.gt_poses, self.noise, self.n_matches = gt_poses, noise, n_matches
        self.frame_batch = frame_batch

    def __call__(self, batch):
        kpts3d, K = batch["keypoints3d"], batch["intrinsics"]
        b, s, _ = kpts3d.shape
        total, first = b, 0
        if self.frame_batch is not None and b * comm.world_size() == self.frame_batch:
            total, first = self.frame_batch, comm.rank() * b
        rng = np.random.default_rng(0)
        k = self.n_matches
        idx = np.stack([rng.choice(s, k, replace=False) for _ in range(total)])[first:first + b]
        noise = rng.normal(0, self.noise, (total, k, 2)).astype(np.float32)[first:first + b]
        Ts = torch.tensor(np.stack([self.gt_poses[i % len(self.gt_poses)] for i in range(first, first + b)]),
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
