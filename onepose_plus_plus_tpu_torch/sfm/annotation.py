"""3D feature-annotation building: per-point descriptor averaging.

Behavioral port of reference ``src/sfm_utils/postprocess/feature_process.py``
(:72-650, entry ``get_kpt_ann`` :544): for every surviving 3D point, gather
the backbone descriptors of all its 2D observations across images, average
them (``mean_descriptors_and_scores``), and emit

  * ``anno/anno_3d_average.npz``   (fine descriptors, dim 128)
  * ``anno/anno_3d_average_coarse.npz`` (coarse descriptors, dim 256)
  * per-image ``anno_2d.json`` entries with the 2D-3D assign matrix
    (saved only when matches exceed ``min_match_ratio`` of the keypoints —
    the reference's 5% rule in ``save_2d_anno``).

Descriptor extraction itself is the matcher's job (LoFTR ``refine`` with
``extract_features=True`` — feature sampling is batched on device); this
module is the host-side aggregation.

The port's own copy of ``onepose_plus_plus_tpu/sfm/annotation.py`` (numpy).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.colmap_model import Image, Point3D
from ..data.preprocessing import save_2d_annotation, save_3d_annotation


def average_track_descriptors(
    points3d: Dict[int, Point3D],
    descriptors: Dict[int, np.ndarray],
    scores: Optional[Dict[int, np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Average per-observation descriptors over each 3D point's track.

    Args:
        points3d: surviving 3D points.
        descriptors: img_id -> [N_i, D] per-keypoint descriptors.
        scores: optional img_id -> [N_i] per-keypoint scores.
    Returns:
        (point_ids [m], keypoints3d [m, 3], desc3d [m, D], scores3d [m]),
        sorted by point id for determinism.
    """
    pids = sorted(points3d.keys())
    kpts, descs, scs = [], [], []
    d = next(iter(descriptors.values())).shape[1] if descriptors else 0
    for pid in pids:
        p = points3d[pid]
        acc, sacc, cnt = np.zeros(d, np.float64), 0.0, 0
        for im, k in zip(p.image_ids, p.point2D_idxs):
            im = int(im)
            if im not in descriptors:
                continue
            desc_arr = descriptors[im]
            if k >= len(desc_arr):
                continue
            acc += desc_arr[int(k)]
            sacc += float(scores[im][int(k)]) if scores else 1.0
            cnt += 1
        if cnt == 0:
            acc = np.zeros(d)
            cnt = 1
        kpts.append(p.xyz)
        descs.append(acc / cnt)
        scs.append(sacc / cnt)
    return (
        np.asarray(pids, np.int64),
        np.stack(kpts).astype(np.float32) if kpts else np.zeros((0, 3), np.float32),
        np.stack(descs).astype(np.float32) if descs else np.zeros((0, d), np.float32),
        np.asarray(scs, np.float32),
    )


def build_assign_matrix(
    image: Image, point_ids: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """2D-3D assignment for one image: pairs of (kpt_idx, 3d_row_idx).

    Mirrors reference ``get_assign_matrix``: rows index the image keypoints,
    columns index rows of the 3D annotation arrays.
    """
    pid_to_row = {int(p): i for i, p in enumerate(point_ids)}
    kpt_idx, row_idx = [], []
    for k, pid in enumerate(image.point3D_ids):
        if pid >= 0 and int(pid) in pid_to_row:
            kpt_idx.append(k)
            row_idx.append(pid_to_row[int(pid)])
    return np.asarray(kpt_idx, np.int64), np.asarray(row_idx, np.int64)


def build_annotations(
    images: Dict[int, Image],
    points3d: Dict[int, Point3D],
    fine_descriptors: Dict[int, np.ndarray],
    coarse_descriptors: Optional[Dict[int, np.ndarray]] = None,
    scores: Optional[Dict[int, np.ndarray]] = None,
    out_dir: Optional[str] = None,
    image_paths: Optional[Dict[int, str]] = None,
    min_match_ratio: float = 0.05,
) -> dict:
    """Build (and optionally persist) the full annotation set for one object.

    Returns dict with keys ``point_ids``, ``keypoints3d``, ``descriptors3d``,
    ``scores3d``, optional ``descriptors3d_coarse``, and ``anno_2d`` (list of
    per-image entries).
    """
    pids, kpts3d, desc3d, sc3d = average_track_descriptors(
        points3d, fine_descriptors, scores
    )
    out = {
        "point_ids": pids,
        "keypoints3d": kpts3d,
        "descriptors3d": desc3d,
        "scores3d": sc3d,
    }
    if coarse_descriptors is not None:
        _, _, desc3d_c, sc3d_c = average_track_descriptors(
            points3d, coarse_descriptors, scores
        )
        out["descriptors3d_coarse"] = desc3d_c
        out["scores3d_coarse"] = sc3d_c

    anno_2d: List[dict] = []
    for iid in sorted(images):
        im = images[iid]
        kpt_idx, row_idx = build_assign_matrix(im, pids)
        if len(im.xys) == 0 or len(kpt_idx) < min_match_ratio * len(im.xys):
            continue  # the reference's 5%-of-keypoints save gate
        if scores is not None and iid in scores:
            sc2d = np.asarray(scores[iid])[kpt_idx].reshape(-1, 1).tolist()
        else:
            sc2d = np.ones((len(kpt_idx), 1)).tolist()
        anno_2d.append(
            {
                "img_id": int(iid),
                "img_file": (
                    image_paths[iid] if image_paths else im.name
                ),
                "keypoints2d": im.xys[kpt_idx].tolist(),
                "scores2d": sc2d,
                "assign_matrix": np.stack([kpt_idx, row_idx]).tolist(),
            }
        )
    out["anno_2d"] = anno_2d

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        save_3d_annotation(
            os.path.join(out_dir, "anno_3d_average.npz"), kpts3d, desc3d, sc3d
        )
        if coarse_descriptors is not None:
            save_3d_annotation(
                os.path.join(out_dir, "anno_3d_average_coarse.npz"),
                kpts3d,
                out["descriptors3d_coarse"],
                out["scores3d_coarse"],
            )
        save_2d_annotation(os.path.join(out_dir, "anno_2d.json"), anno_2d)
    return out
