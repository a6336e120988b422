"""Batched detector-free coarse matching for SfM.

Replaces the reference coarse-matching stage
(``src/KeypointFreeSfM/coarse_match/coarse_match.py:35-215`` +
``coarse_match_worker.py:16-178``), which fans out one-pair-at-a-time LoFTR
inference over 4 fractional-GPU Ray workers. Port of
``onepose_plus_plus_tpu/sfm/coarse_match.py`` (numpy; unchanged): pairs are
**batched** through one LoFTR coarse forward (the scaling axis is the
pair-batch dimension), and the host merges results:

  1. ``run_pairs``: fixed-capacity coarse matches for every covisible pair in
     batches of ``pair_batch`` (one device dispatch per batch, not per pair);
     images of mixed shapes are padded bottom-right to one square with coarse
     masks, as LoFTR's MegaDepth loader pads each view (:func:`pad_batch`).
  2. ``merge_keypoints``: quantize matched endpoints to integer pixels and
     aggregate duplicates per image by score sum (reference
     ``points2D_worker`` / ``agg_groupby_2d``), producing pseudo-keypoints.
  3. matches are rewritten as per-pair (kpt_idx0, kpt_idx1) index arrays
     (reference ``update_matches``) ready for track building.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from ..utils.profiling import annotate

Pair = Tuple[int, int]
DF = 8  # LoFTR's coarse grid: one cell per 8 x 8 pixels (resolution (8, 2))


@dataclasses.dataclass
class PairMatches:
    """Raw matches of one image pair in original-image pixel coords."""

    pair: Pair
    pts0: np.ndarray  # [M, 2] float
    pts1: np.ndarray  # [M, 2] float
    conf: np.ndarray  # [M]


@dataclasses.dataclass
class SceneKeypoints:
    """Per-image merged keypoints + index matches per pair."""

    keypoints: Dict[int, np.ndarray]  # img_id -> [Ni, 2] float (pixel centers)
    scores: Dict[int, np.ndarray]  # img_id -> [Ni] aggregated score sums
    match_indices: Dict[Pair, np.ndarray]  # pair -> [M, 2] int (idx0, idx1)
    match_confs: Dict[Pair, np.ndarray]  # pair -> [M]


def pad_batch(images: Sequence[np.ndarray], side: int, df: int = DF) -> Tuple[np.ndarray, np.ndarray]:
    """Images [H, W] padded bottom-right with zeros to ``side`` x ``side``
    (LoFTR's ``pad_bottom_right``) -> ([B, side, side, 1], coarse masks
    [B, side / df, side / df] bool): a coarse cell is valid where the pixel at
    its top-left corner is, the nearest-neighbour downsampling by 1 / df of
    the pixel mask that LoFTR's loader does."""
    img = np.zeros((len(images), side, side, 1), dtype=images[0].dtype)
    mask = np.zeros((len(images), side // df, side // df), dtype=bool)
    for b, im in enumerate(images):
        h, w = im.shape
        img[b, :h, :w, 0] = im
        mask[b, : -(-h // df), : -(-w // df)] = True
    return img, mask


def run_pairs(
    coarse_match_fn: Callable,
    images: Dict[int, np.ndarray],
    scales: Dict[int, np.ndarray],
    pairs: Sequence[Pair],
    pair_batch: int = 8,
) -> List[PairMatches]:
    """Run batched coarse matching over all pairs.

    Args:
        coarse_match_fn: batched fn (img0 [B,H,W,1], img1 [B,H,W,1]) -> dict
            with ``mkpts0_c``/``mkpts1_c`` [B,K,2], ``mconf`` [B,K],
            ``match_mask`` [B,K] (the LoFTRMatcher ``match_coarse`` surface),
            and ``mkpts0_f``/``mkpts1_f`` where it refines them (the
            ``match`` surface, ``models.build.make_loftr_match_fn``), which
            are then the matches returned. Where the images' shapes differ it
            is called with coarse masks too: fn(img0, img1, mask0, mask1).
        images: img_id -> [H, W] float grayscale. Of one shape, they are
            stacked as they are and no mask is passed; of mixed shapes, each
            is padded bottom-right to the square of the longest side rounded
            up to the coarse cell (:func:`pad_batch`), so the matches stay in
            each image's own pixels.
        scales: img_id -> [2] (w_orig/w_net, h_orig/h_net) from the loader.
        pairs: (i, j) image-id pairs.
        pair_batch: device batch; the tail batch is padded by repetition.
    Returns:
        one PairMatches per input pair (masked slots removed, conf-sorted).
    After each batch's ``sfm.unpack``, an empty ``sfm.count`` span carries the
    batch's valid ``matches`` and its pairs whose valid matches fill every
    slot (``slots_full``), counted from the host's masks outside the timed
    spans.
    """
    out: List[PairMatches] = []
    pairs = list(pairs)
    shapes = {im.shape for im in images.values()}
    side = -(-max(max(sh) for sh in shapes) // DF) * DF if len(shapes) > 1 else None
    with annotate("run_pairs", pairs=len(pairs)):
        for s in range(0, len(pairs), pair_batch):
            chunk = pairs[s : s + pair_batch]
            pad = pair_batch - len(chunk)
            chunk_p = chunk + [chunk[-1]] * pad
            if side is None:
                with annotate("sfm.stack"):
                    img0 = np.stack([images[i][..., None] for i, _ in chunk_p])
                    img1 = np.stack([images[j][..., None] for _, j in chunk_p])
                res = coarse_match_fn(img0, img1)
            else:
                with annotate("sfm.pad"):
                    img0, mask0 = pad_batch([images[i] for i, _ in chunk_p], side)
                    img1, mask1 = pad_batch([images[j] for _, j in chunk_p], side)
                res = coarse_match_fn(img0, img1, mask0, mask1)
            with annotate("sfm.unpack"):
                fine = "mkpts0_f" in res
                mk0 = np.asarray(res["mkpts0_f" if fine else "mkpts0_c"])
                mk1 = np.asarray(res["mkpts1_f" if fine else "mkpts1_c"])
                conf = np.asarray(res["mconf"])
                mask = np.asarray(res["match_mask"]).astype(bool)
                for b, (i, j) in enumerate(chunk):
                    m = mask[b]
                    p0 = mk0[b][m] * scales[i][None, :]
                    p1 = mk1[b][m] * scales[j][None, :]
                    out.append(PairMatches((i, j), p0, p1, conf[b][m]))
            real = mask[: len(chunk)]
            with annotate("sfm.count", matches=int(real.sum()), slots_full=int(real.all(1).sum())):
                pass
    return out


def _agg_groupby_2d(
    pts: np.ndarray, conf: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group integer 2D points, summing confidences.

    Vectorized equivalent of reference ``agg_groupby_2d``
    (``coarse_match/utils.py:5-60``): unique integer locations become the
    keypoint set; scores are per-location confidence sums.

    Returns (unique_pts [U, 2] int, scores [U], inverse [M] mapping).
    """
    ipts = np.round(pts).astype(np.int64)
    uniq, inverse = np.unique(ipts, axis=0, return_inverse=True)
    scores = np.zeros(len(uniq), np.float64)
    np.add.at(scores, inverse, conf.astype(np.float64))
    return uniq, scores, inverse


def merge_keypoints(raw: Sequence[PairMatches]) -> SceneKeypoints:
    """Merge per-pair matches into per-image keypoint sets + index matches."""
    # gather all endpoints per image
    per_img_pts: Dict[int, List[np.ndarray]] = {}
    per_img_conf: Dict[int, List[np.ndarray]] = {}
    spans: Dict[Pair, Tuple[int, int, int]] = {}  # pair -> (off0, off1, m)
    for pm in raw:
        i, j = pm.pair
        for img_id, pts in ((i, pm.pts0), (j, pm.pts1)):
            per_img_pts.setdefault(img_id, [])
            per_img_conf.setdefault(img_id, [])
        off0 = sum(len(a) for a in per_img_pts[i])
        per_img_pts[i].append(pm.pts0)
        per_img_conf[i].append(pm.conf)
        off1 = sum(len(a) for a in per_img_pts[j])
        per_img_pts[j].append(pm.pts1)
        per_img_conf[j].append(pm.conf)
        spans[pm.pair] = (off0, off1, len(pm.pts0))

    keypoints: Dict[int, np.ndarray] = {}
    scores: Dict[int, np.ndarray] = {}
    inverses: Dict[int, np.ndarray] = {}
    for img_id in per_img_pts:
        allpts = (
            np.concatenate(per_img_pts[img_id])
            if per_img_pts[img_id]
            else np.zeros((0, 2))
        )
        allconf = (
            np.concatenate(per_img_conf[img_id])
            if per_img_conf[img_id]
            else np.zeros(0)
        )
        uniq, sc, inv = _agg_groupby_2d(allpts, allconf)
        keypoints[img_id] = uniq.astype(np.float64)
        scores[img_id] = sc
        inverses[img_id] = inv

    match_indices: Dict[Pair, np.ndarray] = {}
    match_confs: Dict[Pair, np.ndarray] = {}
    for pm in raw:
        i, j = pm.pair
        off0, off1, m = spans[pm.pair]
        idx0 = inverses[i][off0 : off0 + m]
        idx1 = inverses[j][off1 : off1 + m]
        # deduplicate collapsed matches (multiple raw matches may quantize to
        # the same keypoint pair); keep max-confidence instance
        key = idx0.astype(np.int64) * (2**31) + idx1
        order = np.argsort(-pm.conf, kind="stable")
        _, first = np.unique(key[order], return_index=True)
        sel = order[first]
        match_indices[pm.pair] = np.stack([idx0[sel], idx1[sel]], axis=1)
        match_confs[pm.pair] = pm.conf[sel]
    return SceneKeypoints(keypoints, scores, match_indices, match_confs)
