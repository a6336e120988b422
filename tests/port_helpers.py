"""Helpers shared by the PyTorch port's parity tests (imported by ``test_torch_*.py``).

- :func:`to_port_config`: a JAX package config dataclass -> the port's class of
  the same name, field by field, so each side is built from its own config
  classes (a field one side lacks raises, and the tests catch the drift).
- :func:`perturbed`: a numpy copy of a flax variable tree with random
  BatchNorm statistics and norm parameters, so that no layer is an identity.
- :func:`textured`: block-textured grayscale frames (iid pixel noise gives
  featureless coarse cells).
- :func:`load_short_encoder_experiment`: the JAX package's K7
  (``experiments/pallas_short_encoder.py``), which does not import as a file.
- :func:`make_plane_object`, :func:`write_annotation`, :func:`write_db_model`:
  a OnePose-format object with its SfM outputs, for the CLIs.
- :func:`run_span_chunks`: the span copy of K6 and K3's span instance, done
  on bytes by the kernel's chunk plan.
"""
import dataclasses
import functools
import types
from pathlib import Path

import jax
import numpy as np
import torch

from onepose_plus_plus_tpu_torch import config as port_config


def to_port_config(cfg):
    """Convert a (nested) JAX config dataclass to the port's dataclass."""
    if not dataclasses.is_dataclass(cfg):
        return cfg
    cls = getattr(port_config, type(cfg).__name__)
    return cls(**{f.name: to_port_config(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})


def perturbed(variables, seed=0):
    """numpy copy of a variable tree with random BN statistics and norm parameters."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, variables))


def textured(rng, n, size, block=8):
    """[n, size, size, 1] float32 frames of random blocks plus a little noise."""
    blocks = rng.random((n, size // block, size // block))
    img = np.kron(blocks, np.ones((1, block, block))) + 0.05 * rng.standard_normal((n, size, size))
    return np.clip(img, 0, 1).astype(np.float32)[..., None]


def make_plane_object(root, obj="0001-toy-box", seq="toy-1", n_frames=6, img=128, seed=0):
    """A OnePose-format object whose every view renders the same textured plane
    (z = 0) through its true plane-induced homography, so that a matcher's
    correspondences satisfy the epipolar geometry (``tests/test_cli_end_to_end.py``
    builds its object the same way). Returns the object's directory name."""
    import os

    import cv2

    from synthetic_scenes import make_scene

    rng = np.random.default_rng(seed)
    K, _, Ts = make_scene(rng, n_views=n_frames, n_pts=32, img=float(img))
    seq_dir = os.path.join(root, obj, seq)
    for sub in ("color", "intrin_ba", "poses_ba"):
        os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
    tex = (np.kron(rng.random((32, 32)), np.ones((8, 8))) * 255).astype(np.uint8)
    S = np.array([[256 / 0.8, 0, 128], [0, 256 / 0.8, 128], [0, 0, 1.0]])
    for i in range(n_frames):
        R, t = Ts[i][:3, :3], Ts[i][:3, 3]
        H = K @ np.stack([R[:, 0], R[:, 1], t], axis=1) @ np.linalg.inv(S)  # plane -> image
        cv2.imwrite(os.path.join(seq_dir, "color", f"{i}.png"), cv2.warpPerspective(tex, H, (img, img)))
        np.savetxt(os.path.join(seq_dir, "intrin_ba", f"{i}.txt"), K)
        np.savetxt(os.path.join(seq_dir, "poses_ba", f"{i}.txt"), Ts[i])
    corners = np.array([[x, y, z] for z in (-0.3, 0.3) for y in (-0.3, 0.3) for x in (-0.3, 0.3)])
    np.savetxt(os.path.join(root, obj, "box3d_corners.txt"), corners)
    return obj


def write_annotation(sfm_dir, obj, n_pts, fine_dim, coarse_dim, seed=0):
    """A synthetic ``anno/anno_3d_average.npz`` (and ``_coarse``) for ``obj``:
    ``n_pts`` points on the plane object's box, random unit descriptors."""
    import os

    from onepose_plus_plus_tpu_torch.data.preprocessing import save_3d_annotation

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.3, 0.3, (n_pts, 3)).astype(np.float32)
    pts[:, 2] *= 0.1  # near the textured plane z = 0
    anno = os.path.join(sfm_dir, obj, "anno", "anno_3d_average.npz")
    for path, dim in ((anno, fine_dim), (anno.replace(".npz", "_coarse.npz"), coarse_dim)):
        desc = rng.standard_normal((n_pts, dim)).astype(np.float32)
        save_3d_annotation(path, pts, desc / np.linalg.norm(desc, axis=1, keepdims=True),
                           np.ones(n_pts, np.float32))
    return anno


def write_db_model(sfm_dir, obj, image_names, size):
    """A COLMAP model (``sfm_dir/obj/model``) whose images are ``image_names``:
    what the demo reads to pick its DB views."""
    import os

    from onepose_plus_plus_tpu_torch.data import colmap_model as cm

    cams = {1: cm.Camera(1, "PINHOLE", size, size, np.array([500.0, 500.0, size / 2, size / 2]))}
    imgs = {i + 1: cm.Image(i + 1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, name,
                            np.zeros((0, 2)), np.zeros(0, np.int64))
            for i, name in enumerate(image_names)}
    cm.write_model(cams, imgs, {}, os.path.join(sfm_dir, obj, "model"))


def write_arkit_capture(seq_dir, angles_deg, seed=0, size=(320, 240), fx=300.0):
    """A synthetic ARKit capture, as the iOS app records one and
    ``parse_scanned_data`` reads it: ``Frames.m4v`` (mp4v), ``Frames.txt``
    (per-frame intrinsics), ``ARposes.txt`` (camera to world in ARKit's axes:
    y up, the camera looking down -z) and ``Box.txt`` (the object box at the
    world origin, 0.3 x 0.3 x 0.1 m). The object is a textured plane (z = 0,
    0.5 m wide) that each frame renders through its plane-induced homography,
    seen from 0.6 m by a camera orbiting it at ``angles_deg`` about the
    vertical axis, so that a matcher's correspondences satisfy the poses."""
    import os

    import cv2
    from scipy.spatial.transform import Rotation

    os.makedirs(seq_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    w, h = size
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    tex = (np.kron(rng.random((32, 32)), np.ones((16, 16))) * 255).astype(np.uint8)
    S = np.array([[512 / 0.5, 0, 256], [0, 512 / 0.5, 256], [0, 0, 1.0]])  # plane metres -> texture pixels
    flip = np.diag([1.0, -1.0, -1.0])  # OpenCV camera axes <-> ARKit's
    video = cv2.VideoWriter(os.path.join(seq_dir, "Frames.m4v"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    poses, intrinsics = [], []
    for i, a in enumerate(np.deg2rad(np.asarray(angles_deg, np.float64))):
        center = 0.6 * np.array([np.sin(a), 0.05 * np.sin(3 * a), -np.cos(a)])
        z = -center / np.linalg.norm(center)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])  # object (= world) -> camera, OpenCV axes
        H = K @ np.stack([R[:, 0], R[:, 1], -R @ center], axis=1) @ np.linalg.inv(S)
        video.write(cv2.cvtColor(cv2.warpPerspective(tex, H, (w, h)), cv2.COLOR_GRAY2BGR))
        qx, qy, qz, qw = Rotation.from_matrix(R.T @ flip).as_quat()  # camera -> world, ARKit axes
        poses.append(f"{i / 10},{center[0]},{center[1]},{center[2]},{qw},{qx},{qy},{qz}\n")
        intrinsics.append(f"{i},{i / 10},{fx},{fx},{w / 2},{h / 2}\n")
    video.release()
    with open(os.path.join(seq_dir, "ARposes.txt"), "w") as f:
        f.writelines(poses)
    with open(os.path.join(seq_dir, "Frames.txt"), "w") as f:
        f.writelines(intrinsics)
    with open(os.path.join(seq_dir, "Box.txt"), "w") as f:
        f.write("# px,py,pz,ex,ey,ez,qw,qx,qy,qz\n0,0,0,0.3,0.3,0.1,1,0,0,0\n")


@functools.lru_cache(maxsize=None)
def load_short_encoder_experiment():
    """``experiments/pallas_short_encoder.py`` as a fresh module.

    The file opens with two string literals, so its ``from __future__ import
    annotations`` comes after the docstring and importing the file is a
    SyntaxError. The file stays as it is: its source is read, that one line is
    dropped (no annotation in it needs it), and the rest runs in a new module.
    """
    path = Path(__file__).resolve().parent.parent / "experiments" / "pallas_short_encoder.py"
    lines = path.read_text().splitlines(keepends=True)
    future = [i for i, line in enumerate(lines) if line.strip() == "from __future__ import annotations"]
    assert len(future) == 1, "the experiment's source changed"
    del lines[future[0]]
    module = types.ModuleType("pallas_short_encoder_experiment")
    module.__file__ = str(path)
    exec(compile("".join(lines), str(path), "exec"), module.__dict__)
    return module


def run_span_chunks(alloc: torch.Tensor, map_lo: int, map_hi: int, chunks, out_bytes: int) -> torch.Tensor:
    """Do what K6 (and K3's span instance) does with the chunk plan
    (``ops/cuda_patch_gather.py::patch_chunks``), on the bytes of an allocation
    (uint8) that holds the map at [map_lo, map_hi): each live chunk loads its
    two aligned vectors, takes 16 bytes from byte o on, zeroes those outside
    [lo, hi) and stores its bytes [s_lo, s_hi). Asserts that every loaded
    vector lies in the allocation and touches the map, and that the stores
    cover the output exactly once."""
    live = chunks["live"].reshape(-1)
    ch = {key: v.reshape(-1)[live] for key, v in chunks.items()}
    j = torch.arange(16)
    loads = torch.cat([ch["f0"][ch["copy"]], ch["f1"][ch["need1"]]])
    assert bool((loads % 16 == 0).all())
    assert bool((loads >= 0).all()) and bool((loads + 16 <= alloc.numel()).all())
    assert bool((loads + 16 > map_lo).all()) and bool((loads < map_hi).all())
    f0 = ch["f0"].clamp(0, alloc.numel() - 16)  # chunks with nothing to copy load nothing
    f1 = ch["f1"].clamp(0, alloc.numel() - 16)
    first, second = alloc[f0[:, None] + j], alloc[f1[:, None] + j]
    second = torch.where(ch["need1"][:, None], second, torch.full_like(second, 0xAB))  # never read
    both = torch.cat([first, second], 1)  # [M, 32]
    val = torch.gather(both, 1, ch["o"][:, None] + j)
    keep = ch["copy"][:, None] & (j >= ch["lo"][:, None]) & (j < ch["hi"][:, None])
    val = torch.where(keep, val, torch.zeros_like(val))
    store = (j >= ch["s_lo"][:, None]) & (j < ch["s_hi"][:, None])
    pos = (ch["a"][:, None] + j)[store]
    assert bool((pos >= 0).all()) and bool((pos < out_bytes).all())
    assert torch.equal(torch.bincount(pos, minlength=out_bytes), torch.ones(out_bytes, dtype=torch.long))
    out = torch.full((out_bytes,), 0xEE, dtype=torch.uint8)
    out[pos] = val[store]
    return out
