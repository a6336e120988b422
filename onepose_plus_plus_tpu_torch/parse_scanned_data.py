"""ARKit capture parser: ``python -m onepose_plus_plus_tpu_torch.parse_scanned_data --scanned_object_path <dir>``.

Port of the repository's ``parse_scanned_data.py`` (reference
``parse_scanned_data.py``): decode
``Frames.m4v``, average per-frame intrinsics from ``Frames.txt``, parse
``ARposes.txt`` (camera-to-world, ARKit gravity-aligned convention with the
y/z flip) and ``Box.txt`` (object box pose + extents), compute object-space
world->cam poses ``T_oc``, reproject the 3D box to a 2D bbox, crop + resize
to hw^2 with intrinsic updates, and write the OnePose directory layout:
``color/ intrin/ poses/ bbox/ reproj_box/ M/`` + ``box3d_corners.txt``
(+ ``intrin_ba``/``poses_ba`` symlinks for the no-BA demo path).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
from pathlib import Path

import numpy as np

from .data.preprocessing import crop_img_by_bbox


def quat_to_rotmat(q):
    """(w, x, y, z) -> [3, 3] (ARposes/Box store w-first quaternions)."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def box_corners_from_extents(ex, ey, ez):
    """Reference corner ordering (parse_scanned_data.py get_bbox3d)."""
    return (
        np.array(
            [
                [-ex, -ey, -ez], [ex, -ey, -ez], [ex, -ey, ez], [-ex, -ey, ez],
                [-ex, ey, -ez], [ex, ey, -ez], [ex, ey, ez], [-ex, ey, ez],
            ]
        )
        * 0.5
    )


def parse_box_file(box_path):
    with open(box_path) as f:
        lines = f.readlines()
    data = [float(e) for e in lines[1].strip().split(",")]
    position = np.asarray(data[:3])
    ex, ey, ez = data[3:6]
    R = quat_to_rotmat(data[6:10])
    T_ow = np.eye(4)
    T_ow[:3, :3] = R
    T_ow[:3, 3] = position
    return T_ow, box_corners_from_extents(ex, ey, ez)


def parse_intrinsics(frames_txt):
    with open(frames_txt) as f:
        lines = [l.strip() for l in f if l.strip() and l[0] != "#"]
    data = np.array([[float(e) for e in l.split(",")] for l in lines])
    fx, fy, cx, cy = np.average(data, axis=0)[2:6]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def reproject(K, T, pts3d):
    pc = pts3d @ T[:3, :3].T + T[:3, 3]
    uvw = pc @ K.T
    return uvw[:, :2] / uvw[:, 2:3]


def process_capture(data_dir: str, downsample_rate: int = 1, hw: int = 512):
    import cv2

    for sub in ("color", "intrin", "poses", "bbox", "reproj_box", "M"):
        Path(osp.join(data_dir, sub)).mkdir(parents=True, exist_ok=True)

    K = parse_intrinsics(osp.join(data_dir, "Frames.txt"))
    with open(osp.join(data_dir, "intrinsics.txt"), "w") as f:
        f.write(
            f"fx: {K[0, 0]}\nfy: {K[1, 1]}\ncx: {K[0, 2]}\ncy: {K[1, 2]}"
        )
    T_ow, corners = parse_box_file(osp.join(data_dir, "Box.txt"))
    np.savetxt(osp.join(osp.dirname(data_dir), "box3d_corners.txt"), corners)

    # ARKit pose lines: timestamp, tx, ty, tz, qw, qx, qy, qz (cam-to-world)
    flip = np.diag([1.0, -1.0, -1.0])
    poses = {}
    with open(osp.join(data_dir, "ARposes.txt")) as f:
        index = 0
        for line in f:
            line = line.strip()
            if not line or line[0] == "#":
                continue
            if index % downsample_rate == 0:
                data = [float(e) for e in line.split(",")]
                position = np.asarray(data[1:4])
                R = quat_to_rotmat(data[4:8]) @ flip
                T_cw = np.eye(4)
                T_cw[:3, :3] = R
                T_cw[:3, 3] = position
                T_oc = np.linalg.inv(T_cw) @ T_ow  # object -> camera
                box2d = reproject(K, T_oc, corners)
                x0, y0 = box2d.min(0)
                x1, y1 = box2d.max(0)
                if x0 < -1000 or y0 < -1000 or x1 > 3000 or y1 > 3000:
                    index += 1
                    continue
                np.savetxt(osp.join(data_dir, "poses", f"{index}.txt"), T_oc)
                np.savetxt(
                    osp.join(data_dir, "reproj_box", f"{index}.txt"), box2d
                )
                poses[index] = T_oc
            index += 1

    # decode video, crop to the reprojected box, resize hw^2
    cap = cv2.VideoCapture(osp.join(data_dir, "Frames.m4v"))
    index = 0
    n_written = 0
    while True:
        ret, image = cap.read()
        if not ret:
            break
        if index % downsample_rate == 0 and index in poses:
            box2d = np.loadtxt(osp.join(data_dir, "reproj_box", f"{index}.txt"))
            x0, y0 = box2d.min(0)
            x1, y1 = box2d.max(0)
            gray_or_color = image
            crop, K_crop = crop_img_by_bbox(
                gray_or_color, np.array([x0, y0, x1, y1]), K, hw
            )
            cv2.imwrite(osp.join(data_dir, "color", f"{index}.png"), crop)
            np.savetxt(osp.join(data_dir, "intrin", f"{index}.txt"), K_crop)
            # crop->full transform for downstream un-cropping
            sx = hw / (x1 - x0)
            sy = hw / (y1 - y0)
            M = np.linalg.inv(
                np.array([[sx, 0, -x0 * sx], [0, sy, -y0 * sy], [0, 0, 1]])
            )
            np.savetxt(osp.join(data_dir, "M", f"{index}.txt"), M)
            box_crop = reproject(K_crop, poses[index], corners)
            np.savetxt(
                osp.join(data_dir, "bbox", f"{index}.txt"),
                np.array(
                    [box_crop[:, 0].min(), box_crop[:, 1].min(),
                     box_crop[:, 0].max(), box_crop[:, 1].max()]
                ),
            )
            n_written += 1
        index += 1
    cap.release()

    # no-BA symlinks (reference demo path)
    for src, dst in (("intrin", "intrin_ba"), ("poses", "poses_ba")):
        link = osp.join(data_dir, dst)
        if osp.islink(link) or osp.exists(link):
            if osp.islink(link):
                os.unlink(link)
        if not osp.exists(link):
            os.symlink(osp.join(data_dir, src), link)
    print(f"{data_dir}: wrote {n_written} frames")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m onepose_plus_plus_tpu_torch.parse_scanned_data")
    ap.add_argument("--scanned_object_path", required=True)
    ap.add_argument("--downsample_rate", type=int, default=1)
    ap.add_argument("--hw", type=int, default=512)
    args = ap.parse_args(argv)
    for seq in sorted(os.listdir(args.scanned_object_path)):
        seq_dir = osp.join(args.scanned_object_path, seq)
        if osp.isdir(seq_dir) and osp.exists(osp.join(seq_dir, "ARposes.txt")):
            process_capture(seq_dir, args.downsample_rate, args.hw)


if __name__ == "__main__":
    main()
