"""COLMAP sparse-model IO (cameras/images/points3D, bin + txt).

Host-side replacement for the reference's vendored COLMAP readers
(``src/utils/colmap/read_write_model.py``) written fresh against the public
COLMAP binary/text format specification. The SfM engine stores its
triangulation results in this format so downstream consumers of the reference
(annotation builders, visualizers, eval tools) interoperate unchanged.

Unlike the reference's per-record ``struct`` loops, bulk payloads (2D points,
track elements) are packed/unpacked with vectorized numpy ``frombuffer`` views
— model IO is host-side but should not be a bottleneck for large scenes.
"""
from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Tuple

import numpy as np

# COLMAP camera model ids (public spec: src/base/camera_models.h)
CAMERA_MODEL_IDS = {
    "SIMPLE_PINHOLE": (0, 3),
    "PINHOLE": (1, 4),
    "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5),
    "OPENCV": (4, 8),
    "OPENCV_FISHEYE": (5, 8),
    "FULL_OPENCV": (6, 12),
    "FOV": (7, 5),
    "SIMPLE_RADIAL_FISHEYE": (8, 4),
    "RADIAL_FISHEYE": (9, 5),
    "THIN_PRISM_FISHEYE": (10, 12),
}
CAMERA_MODEL_NAMES = {v[0]: (k, v[1]) for k, v in CAMERA_MODEL_IDS.items()}


@dataclasses.dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # [P]

    @property
    def K(self) -> np.ndarray:
        if self.model == "SIMPLE_PINHOLE":
            f, cx, cy = self.params[:3]
            return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
        if self.model == "PINHOLE":
            fx, fy, cx, cy = self.params[:4]
            return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        raise ValueError(f"no pinhole K for model {self.model}")


@dataclasses.dataclass
class Image:
    id: int
    qvec: np.ndarray  # [4] (w, x, y, z), world->cam
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray  # [N, 2]
    point3D_ids: np.ndarray  # [N] int64, -1 = untracked

    def R(self) -> np.ndarray:
        w, x, y, z = self.qvec
        return np.array(
            [
                [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
                [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
                [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
            ]
        )

    def T(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.R()
        T[:3, 3] = self.tvec
        return T


@dataclasses.dataclass
class Point3D:
    id: int
    xyz: np.ndarray  # [3]
    rgb: np.ndarray  # [3] uint8
    error: float
    image_ids: np.ndarray  # [T]
    point2D_idxs: np.ndarray  # [T]


ColmapModel = Tuple[Dict[int, Camera], Dict[int, Image], Dict[int, Point3D]]


# ------------------------------- binary IO ---------------------------------


def _read_cameras_bin(path: str) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = CAMERA_MODEL_NAMES[model_id]
            params = np.frombuffer(f.read(8 * n_params), dtype="<f8").copy()
            cameras[cid] = Camera(cid, name, w, h, params)
    return cameras


def _write_cameras_bin(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id, n_params = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(np.asarray(cam.params, dtype="<f8")[:n_params].tobytes())


def _read_images_bin(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            qvec = np.frombuffer(f.read(32), dtype="<f8").copy()
            tvec = np.frombuffer(f.read(24), dtype="<f8").copy()
            (camera_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = struct.unpack("<Q", f.read(8))
            blob = np.frombuffer(f.read(24 * n_pts), dtype="<f8").reshape(n_pts, 3)
            xys = blob[:, :2].copy()
            p3d = blob[:, 2].view("<i8").copy()
            images[iid] = Image(
                iid, qvec, tvec, camera_id, name.decode("utf-8"), xys, p3d
            )
    return images


def _write_images_bin(images: Dict[int, Image], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(np.asarray(im.qvec, dtype="<f8").tobytes())
            f.write(np.asarray(im.tvec, dtype="<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n_pts = len(im.xys)
            f.write(struct.pack("<Q", n_pts))
            blob = np.empty((n_pts, 3), dtype="<f8")
            blob[:, :2] = im.xys
            blob[:, 2] = np.asarray(im.point3D_ids, dtype="<i8").view("<f8")
            f.write(blob.tobytes())


def _read_points3d_bin(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            pid = struct.unpack("<Q", f.read(8))[0]
            xyz = np.frombuffer(f.read(24), dtype="<f8").copy()
            rgb = np.frombuffer(f.read(3), dtype=np.uint8).copy()
            (error,) = struct.unpack("<d", f.read(8))
            (track_len,) = struct.unpack("<Q", f.read(8))
            track = np.frombuffer(f.read(8 * track_len), dtype="<i4").reshape(
                track_len, 2
            )
            points[pid] = Point3D(
                pid, xyz, rgb, error, track[:, 0].copy(), track[:, 1].copy()
            )
    return points


def _write_points3d_bin(points: Dict[int, Point3D], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", p.id))
            f.write(np.asarray(p.xyz, dtype="<f8").tobytes())
            f.write(np.asarray(p.rgb, dtype=np.uint8)[:3].tobytes())
            f.write(struct.pack("<d", float(p.error)))
            track = np.stack(
                [
                    np.asarray(p.image_ids, dtype="<i4"),
                    np.asarray(p.point2D_idxs, dtype="<i4"),
                ],
                axis=1,
            )
            f.write(struct.pack("<Q", len(track)))
            f.write(track.tobytes())


# -------------------------------- text IO ----------------------------------


def _read_cameras_txt(path: str) -> Dict[int, Camera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            cameras[cid] = Camera(
                cid,
                parts[1],
                int(parts[2]),
                int(parts[3]),
                np.array([float(x) for x in parts[4:]]),
            )
    return cameras


def _write_cameras_txt(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def _read_images_txt(path: str) -> Dict[int, Image]:
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        iid = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        arr = np.array([float(x) for x in elems]).reshape(-1, 3)
        images[iid] = Image(
            iid,
            qvec,
            tvec,
            camera_id,
            name,
            arr[:, :2],
            arr[:, 2].astype(np.int64),
        )
    return images


def _write_images_txt(images: Dict[int, Image], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            q = " ".join(repr(float(x)) for x in im.qvec)
            t = " ".join(repr(float(x)) for x in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            row = " ".join(
                f"{x} {y} {int(pid)}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)
            )
            f.write(row + "\n")


def _read_points3d_txt(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pid = int(parts[0])
            xyz = np.array([float(x) for x in parts[1:4]])
            rgb = np.array([int(x) for x in parts[4:7]], dtype=np.uint8)
            error = float(parts[7])
            track = np.array([int(x) for x in parts[8:]]).reshape(-1, 2)
            points[pid] = Point3D(pid, xyz, rgb, error, track[:, 0], track[:, 1])
    return points


def _write_points3d_txt(points: Dict[int, Point3D], path: str) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write(
            "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
            "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
        )
        for p in points.values():
            xyz = " ".join(repr(float(x)) for x in p.xyz)
            rgb = " ".join(str(int(x)) for x in p.rgb)
            track = " ".join(
                f"{int(i)} {int(j)}" for i, j in zip(p.image_ids, p.point2D_idxs)
            )
            f.write(f"{p.id} {xyz} {rgb} {float(p.error)} {track}\n")


# ------------------------------ public API ---------------------------------


def read_model(path: str, ext: str = ".bin") -> ColmapModel:
    """Read a COLMAP model directory (cameras/images/points3D + ext)."""
    if ext == ".bin":
        return (
            _read_cameras_bin(os.path.join(path, "cameras.bin")),
            _read_images_bin(os.path.join(path, "images.bin")),
            _read_points3d_bin(os.path.join(path, "points3D.bin")),
        )
    if ext == ".txt":
        return (
            _read_cameras_txt(os.path.join(path, "cameras.txt")),
            _read_images_txt(os.path.join(path, "images.txt")),
            _read_points3d_txt(os.path.join(path, "points3D.txt")),
        )
    raise ValueError(f"unknown extension {ext}")


def write_model(
    cameras: Dict[int, Camera],
    images: Dict[int, Image],
    points3d: Dict[int, Point3D],
    path: str,
    ext: str = ".bin",
) -> None:
    """Write a COLMAP model directory in binary or text format."""
    os.makedirs(path, exist_ok=True)
    if ext == ".bin":
        _write_cameras_bin(cameras, os.path.join(path, "cameras.bin"))
        _write_images_bin(images, os.path.join(path, "images.bin"))
        _write_points3d_bin(points3d, os.path.join(path, "points3D.bin"))
    elif ext == ".txt":
        _write_cameras_txt(cameras, os.path.join(path, "cameras.txt"))
        _write_images_txt(images, os.path.join(path, "images.txt"))
        _write_points3d_txt(points3d, os.path.join(path, "points3D.txt"))
    else:
        raise ValueError(f"unknown extension {ext}")


def detect_model_format(path: str) -> str:
    """Return '.bin' or '.txt' depending on which files exist."""
    if os.path.exists(os.path.join(path, "cameras.bin")):
        return ".bin"
    if os.path.exists(os.path.join(path, "cameras.txt")):
        return ".txt"
    raise FileNotFoundError(f"no COLMAP model at {path}")


def model_stats(
    cameras: Dict[int, Camera],
    images: Dict[int, Image],
    points3d: Dict[int, Point3D],
) -> dict:
    """Summary statistics equivalent to COLMAP ``model_analyzer`` output
    (parsed by reference ``triangulation.py:192-210``)."""
    n_obs = sum(len(p.image_ids) for p in points3d.values())
    n_reg = sum(1 for im in images.values() if (im.point3D_ids >= 0).any())
    track_lens = np.array([len(p.image_ids) for p in points3d.values()])
    errors = np.array([p.error for p in points3d.values()])
    # COLMAP's model_analyzer reports the observation-weighted mean (each
    # point's error is its per-observation mean, so weighting by track length
    # recovers the mean over observations); keep that so the number is
    # comparable to reference COLMAP logs when tuning thresholds
    mean_err = (
        float(np.sum(errors * track_lens) / max(n_obs, 1)) if len(errors) else 0.0
    )
    return {
        "num_cameras": len(cameras),
        "num_images": len(images),
        "num_reg_images": n_reg,
        "num_points3D": len(points3d),
        "num_observations": int(n_obs),
        "mean_track_length": float(np.mean(track_lens)) if len(track_lens) else 0.0,
        "mean_observations_per_image": (n_obs / max(n_reg, 1)),
        "mean_reprojection_error": mean_err,
    }
