"""Helpers shared by the PyTorch port's parity tests (imported by ``test_torch_*.py``).

- :func:`to_port_config`: a JAX package config dataclass -> the port's class of
  the same name, field by field, so each side is built from its own config
  classes (a field one side lacks raises, and the tests catch the drift).
- :func:`perturbed`: a numpy copy of a flax variable tree with random
  BatchNorm statistics and norm parameters, so that no layer is an identity.
- :func:`textured`: block-textured grayscale frames (iid pixel noise gives
  featureless coarse cells).
"""
import dataclasses

import jax
import numpy as np

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
