"""The benchmark's inputs, made from the seed by one general generator.

Every cell's traffic is a data file (``benchmark/workloads/<cell>.json``)
whose parameters these functions read:

- textured planar objects seen by a moving camera (:func:`plane_object`),
  rendered on the device through each view's plane-induced homography, as the
  query sequences and the SfM captures a user records of a flat, textured
  object; the camera path is fixed by the parameters and the texture comes
  from the seed, so every seed gives the same work;
- image pairs of an SfM capture by pose covisibility (:func:`covisibility_pairs`);
- training micro-batches of a synthetic scene with GT correspondences
  (:func:`train_batch`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def intrinsics(img: int, focal: float) -> np.ndarray:
    return np.array([[focal, 0.0, img / 2], [0.0, focal, img / 2], [0.0, 0.0, 1.0]])


def look_at_plane(yaw_deg: float, pitch_deg: float, dist: float) -> np.ndarray:
    """World->camera [4, 4] of a camera ``dist`` metres from the origin of the
    plane z = 0, on the side z < 0, looking at the origin."""
    a, b = np.deg2rad(yaw_deg), np.deg2rad(pitch_deg)
    center = dist * np.array([np.sin(a) * np.cos(b), np.sin(b), -np.cos(a) * np.cos(b)])
    z = -center / np.linalg.norm(center)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    T = np.eye(4)
    T[:3, :3] = np.stack([x, np.cross(z, x), z])
    T[:3, 3] = -T[:3, :3] @ center
    return T


def orbit_poses(n: int, path: Dict) -> np.ndarray:
    """[n, 4, 4] poses along a closed path: yaw and pitch swing as sines of
    ``yaw_cycles`` and ``pitch_cycles`` periods over the n frames, the distance
    by ``dist_amp`` about ``dist``; ``phase`` (turns) shifts the path."""
    s = np.arange(n) / n + path.get("phase", 0.0)
    yaw = path["yaw_deg"] * np.sin(2 * np.pi * path.get("yaw_cycles", 1) * s)
    pitch = path["pitch_deg"] * np.sin(2 * np.pi * path.get("pitch_cycles", 2) * s)
    dist = path["dist"] + path.get("dist_amp", 0.0) * np.cos(2 * np.pi * s)
    return np.stack([look_at_plane(*v) for v in zip(yaw, pitch, dist)])


def texture(gen: torch.Generator, blocks: int, block_px: int, device) -> torch.Tensor:
    """[blocks * block_px]^2 texture of uniform random grey blocks, in [0, 1]."""
    t = torch.rand((1, 1, blocks, blocks), generator=gen, device=device)
    return F.interpolate(t, scale_factor=block_px, mode="nearest")


def render(tex: torch.Tensor, plane_m: float, poses: np.ndarray, K: np.ndarray, img: int) -> torch.Tensor:
    """Views [n, img, img] in [0, 1] of a texture that covers the square
    [-plane_m / 2, plane_m / 2]^2 of the plane z = 0; black off the plane."""
    size = tex.shape[-1]
    S = np.array([[size / plane_m, 0, size / 2], [0, size / plane_m, size / 2], [0, 0, 1.0]])
    # pixel (u, v) -> texture pixel: S (K [r1 r2 t])^-1
    maps = np.stack([S @ np.linalg.inv(K @ np.stack([T[:3, 0], T[:3, 1], T[:3, 3]], 1)) for T in poses])
    dev = tex.device
    v, u = torch.meshgrid(torch.arange(img, device=dev, dtype=torch.float64),
                          torch.arange(img, device=dev, dtype=torch.float64), indexing="ij")
    uv1 = torch.stack([u, v, torch.ones_like(u)], -1).reshape(-1, 3)
    out = []
    for m in torch.from_numpy(maps).to(dev).split(32):
        p = torch.einsum("bij,mj->bmi", m, uv1)
        xy = p[..., :2] / p[..., 2:]
        grid = ((2 * xy + 1) / size - 1).float().reshape(len(m), img, img, 2)
        out.append(F.grid_sample(tex.expand(len(m), -1, -1, -1), grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=False)[:, 0])
    return torch.cat(out)


def plane_object(gen: torch.Generator, obj: Dict, img: int, views: Dict[str, int], device):
    """One textured planar object seen along its path: for each named set of
    views (name -> count), (views [n, img, img] float in [0, 1] on ``device``,
    poses [n, 4, 4]), every set of the one texture; and K [3, 3]. A set's path
    phase is the object's plus ``obj["offsets"][name]`` (turns), if given."""
    K = intrinsics(img, obj["focal"])
    tex = texture(gen, obj["tex_blocks"], obj["tex_block_px"], device)
    out = {}
    for name, n in views.items():
        path = dict(obj["path"], phase=obj["path"].get("phase", 0.0) + obj.get("offsets", {}).get(name, 0.0))
        poses = orbit_poses(n, path)
        out[name] = (render(tex, obj["plane_m"], poses, K, img), poses)
    return out, K


def plane_points(gen: torch.Generator, n: int, pose: np.ndarray, K: np.ndarray, img: int, margin: int):
    """n points of the plane z = 0 seen in a view, each in a coarse (8-pixel)
    cell of its own at least ``margin`` px inside the image, at a uniform pixel
    of the cell: (points [n, 3], pixels [n, 2]), float64. Distinct cells keep
    two points from sharing one descriptor."""
    lo, hi = -(-margin // 8), (img - margin) // 8
    side = hi - lo
    if n > side * side:
        raise ValueError(f"{n} points need distinct cells; a view has {side * side} inside the margin")
    cells = torch.randperm(side * side, generator=gen, device=gen.device)[:n].cpu().numpy()
    offs = torch.rand((n, 2), generator=gen, device=gen.device).double().cpu().numpy()
    uv = 8.0 * (np.stack([cells % side, cells // side], 1) + lo + offs)
    Hinv = np.linalg.inv(K @ np.stack([pose[:3, 0], pose[:3, 1], pose[:3, 3]], 1))
    p = np.c_[uv, np.ones(n)] @ Hinv.T
    xy = p[:, :2] / p[:, 2:]
    return np.c_[xy, np.zeros(n)], uv


def covisibility_pairs(poses: Sequence[np.ndarray], num_matched: int, min_rotation_deg: float) -> List[Tuple[int, int]]:
    """For each view the ``num_matched`` nearest camera centres among views at
    least ``min_rotation_deg`` away in rotation; pairs (i < j) deduplicated and
    sorted (the covisibility rule of OnePose++'s ``pairs_from_poses.py``)."""
    Rs = np.stack([p[:3, :3] for p in poses])
    centers = -np.einsum("nji,nj->ni", Rs, np.stack([p[:3, 3] for p in poses]))
    d2 = ((centers[:, None] - centers[None]) ** 2).sum(-1)
    ang = np.rad2deg(np.arccos(np.clip((np.einsum("nij,mij->nm", Rs, Rs) - 1) / 2, -1, 1)))
    ok = ang >= min_rotation_deg
    np.fill_diagonal(ok, False)
    d2 = np.where(ok, d2, np.inf)
    pairs = set()
    for i, row in enumerate(np.argsort(d2, axis=1)[:, :min(num_matched, len(poses) - 1)]):
        pairs.update((min(i, int(j)), max(i, int(j))) for j in row if np.isfinite(d2[i, j]))
    return sorted(pairs)


def train_batch(gen: torch.Generator, n: int, img: int, n_pts: int, coarse_dim: int, fine_dim: int,
                scene: Dict) -> Dict[str, torch.Tensor]:
    """A training micro-batch on the generator's device: block-textured frames,
    a point cloud in a cube of ``scene["cube_m"]`` seen by ``n`` cameras on a
    ring of radius ``scene["ring_m"]`` (one every ``scene["ring_deg"]`` degrees,
    heights from the seed), random descriptors, and the GT coarse cell and
    pixel of every point in every frame (-1 and -50 off the image)."""
    dev = gen.device
    K = intrinsics(img, scene["focal"])
    u = lambda *s: torch.rand(s, generator=gen, device=dev)  # noqa: E731
    pts = ((u(n_pts, 3) - 0.5) * scene["cube_m"]).double()
    heights = (torch.randn((n,), generator=gen, device=dev) * scene["height_sd_m"]).double().cpu().numpy()
    w_c = img // 8
    gt_cell = torch.full((n, n_pts), -1, dtype=torch.int32, device=dev)
    gt_fine = torch.full((n, n_pts, 2), -50.0, device=dev)
    for i in range(n):
        ang = np.deg2rad(scene["ring_deg"] * i)
        center = np.array([scene["ring_m"] * np.sin(ang), heights[i], scene["ring_m"] * np.cos(ang)])
        z = -center / np.linalg.norm(center)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = torch.from_numpy(np.stack([x, np.cross(z, x), z])).to(dev)
        pc = pts @ R.T - R @ torch.from_numpy(center).to(dev)
        uv = pc[:, :2] / pc[:, 2:3] * K[0, 0] + K[0, 2]
        cell = torch.round(uv / 8).long()
        inb = (cell >= 0).all(1) & (cell < w_c).all(1) & (pc[:, 2] > 0)
        gt_cell[i] = torch.where(inb, cell[:, 1] * w_c + cell[:, 0], -1).int()
        gt_fine[i] = torch.where(inb[:, None], uv.float(), gt_fine[i])
    blocks = F.interpolate(u(n, 1, img // 16, img // 16), scale_factor=16, mode="nearest")[:, 0]
    frames = (blocks + 0.05 * torch.randn((n, img, img), generator=gen, device=dev)).clamp(0, 1)
    return {
        "query_image": frames[..., None].contiguous(),
        "keypoints3d": pts.float()[None].expand(n, -1, -1).contiguous(),
        "descriptors3d": torch.randn((n, n_pts, fine_dim), generator=gen, device=dev),
        "descriptors3d_coarse": torch.randn((n, n_pts, coarse_dim), generator=gen, device=dev),
        "gt_cell": gt_cell,
        "gt_fine_xy": gt_fine,
    }
