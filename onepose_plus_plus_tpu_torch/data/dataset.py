"""Train/val/inference datasets producing fixed-shape device batches.

Behavioral port of reference ``src/datasets/OnePosePlus_dataset.py`` (458 LoC)
and ``OnePosePlus_inference_dataset.py``, restructured for the TPU pipeline:

  * manifests are plain JSON lists (one record per query frame:
    ``img_file``, ``pose_file``/``pose``, ``intrin_file``/``K``,
    ``avg_anno3d_file``, optional ``assign_pairs`` [2, k]); a COCO-json
    reader (:func:`records_from_coco`) accepts the reference's merged
    annotation format unchanged.
  * GT supervision is SPARSE: instead of the reference's dense
    ``conf_matrix_gt [shape3d, h_c*w_c]`` + ``fine_location_matrix_gt``
    (``OnePosePlus_dataset.py:341-444``), each example carries
    ``gt_cell [shape3d]`` (coarse cell id of each 3D point's GT match, -1 if
    none) and ``gt_fine_xy [shape3d, 2]`` (exact projected pixel) — the same
    information at 1/S the memory, matching the losses in
    :mod:`~onepose_plus_plus_tpu_torch.train.losses`.
  * the homography warp adaptation (``image_warp_adapt``) doubles the dataset
    with warped copies, warping the projected GT accordingly.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .homography import sample_homography, warp_image, warp_points
from .image_io import imread_gray, resize_image
from .preprocessing import load_3d_annotation, pad_point_cloud


@dataclasses.dataclass
class FrameRecord:
    img_file: str
    pose: Optional[np.ndarray] = None  # [4, 4] world->cam GT
    K: Optional[np.ndarray] = None  # [3, 3]
    avg_anno3d_file: Optional[str] = None
    assign_pairs: Optional[np.ndarray] = None  # [2, k] (kpt2d_idx, p3d_row)


def load_manifest(path: str) -> List[FrameRecord]:
    """Read a JSON manifest into frame records (paths resolved relative to it)."""
    base = os.path.dirname(os.path.abspath(path))

    def resolve(p):
        return p if os.path.isabs(p) else os.path.join(base, p)

    with open(path) as f:
        raw = json.load(f)
    out = []
    for r in raw:
        rec = FrameRecord(img_file=resolve(r["img_file"]))
        if "pose" in r:
            rec.pose = np.asarray(r["pose"], np.float64)
        elif "pose_file" in r:
            rec.pose = np.loadtxt(resolve(r["pose_file"])).reshape(4, 4)
        if "K" in r:
            rec.K = np.asarray(r["K"], np.float64)
        elif "intrin_file" in r:
            rec.K = np.loadtxt(resolve(r["intrin_file"])).reshape(3, 3)
        if "avg_anno3d_file" in r:
            rec.avg_anno3d_file = resolve(r["avg_anno3d_file"])
        if "assign_pairs" in r:
            rec.assign_pairs = np.asarray(r["assign_pairs"], np.int64)
        out.append(rec)
    return out


def records_from_coco(anno_file: str) -> List[FrameRecord]:
    """Read the reference's merged COCO-style annotation json
    (``merge.py`` output: images[].img_file + annotations[].avg_anno3d_file /
    anno2d_file) into frame records."""
    with open(anno_file) as f:
        coco = json.load(f)
    ann_by_img: Dict[int, dict] = {}
    for a in coco.get("annotations", []):
        ann_by_img[a["image_id"]] = a
    out = []
    for im in coco.get("images", []):
        a = ann_by_img.get(im["id"], {})
        rec = FrameRecord(img_file=im["img_file"])
        rec.avg_anno3d_file = a.get("avg_anno3d_file")
        # pose/intrinsics live beside the image in the OnePose layout
        img_dir = os.path.dirname(im["img_file"])
        stem = os.path.splitext(os.path.basename(im["img_file"]))[0]
        pose_p = os.path.join(os.path.dirname(img_dir), "poses_ba", stem + ".txt")
        intr_p = os.path.join(os.path.dirname(img_dir), "intrin_ba", stem + ".txt")
        if os.path.exists(pose_p):
            rec.pose = np.loadtxt(pose_p).reshape(4, 4)
        if os.path.exists(intr_p):
            rec.K = np.loadtxt(intr_p).reshape(3, 3)
        if "assign_matrix" in a:
            # merge.py inlines the per-image [2, M] assign matrix in the
            # annotation entry (the per-object anno_2d.json it also points to
            # is a LIST of per-image entries, not directly indexable here)
            rec.assign_pairs = np.asarray(a["assign_matrix"], np.int64)
        elif "anno2d_file" in a and os.path.exists(a["anno2d_file"]):
            with open(a["anno2d_file"]) as f:
                a2d = json.load(f)
            if isinstance(a2d, dict) and "assign_matrix" in a2d:
                rec.assign_pairs = np.asarray(a2d["assign_matrix"], np.int64)
        out.append(rec)
    return out


class OnePosePlusTrainDataset:
    """Map-style dataset yielding fixed-shape numpy training examples.

    Each example:
        query_image [H, W, 1] f32, keypoints3d [S, 3], descriptors3d [S, 128],
        descriptors3d_coarse [S, 256] (if present), gt_cell [S] i32,
        gt_fine_xy [S, 2] f32, pose_gt [4, 4], intrinsics [3, 3].
    """

    def __init__(
        self,
        records: Sequence[FrameRecord],
        img_size: int = 512,
        shape3d: int = 7000,
        coarse_stride: int = 8,
        image_warp_adapt: bool = False,
        image_warp_all: bool = False,
        load_coarse_descriptors: bool = True,
        augmentor=None,
        seed: int = 0,
    ):
        self.records = list(records)
        self.img_size = img_size
        self.shape3d = shape3d
        self.coarse_stride = coarse_stride
        self.image_warp_adapt = image_warp_adapt
        # warp the "original" half too (each half gets an independent
        # epoch-fresh homography). The reference's image_warp_adapt keeps
        # originals + warped copies; with few mapping views that leaves a
        # positional-encoding lookup shortcut on the static half — measured
        # epoch-40 5cm@5deg: 0.96 on mapped views vs 0.04 held-out, with the
        # held-out high-confidence matches being wrong (view memorization).
        # Warping every sample removes the static-view channel entirely, so
        # confidence can only come from appearance. Without image_warp_adapt
        # this warps every (undoubled) sample rather than silently no-opping.
        self.image_warp_all = image_warp_all
        self.load_coarse = load_coarse_descriptors
        self.augmentor = augmentor
        self.seed = seed
        self._epoch = 0
        self._anno_cache: Dict[str, dict] = {}
        # augmentors hold one shared np Generator; serialize their draws so
        # multi-worker loading stays race-free
        self._aug_lock = threading.Lock()

    def __len__(self):
        return len(self.records) * (2 if self.image_warp_adapt else 1)

    def set_epoch(self, epoch: int) -> None:
        """Make the warp-adaptation homographies epoch-fresh.

        With a fixed per-index warp the doubled dataset is just 2N static
        images, and a long schedule memorizes them all: the round-4 on-chip
        diagnosis showed the trained matcher at cell-precision 0.40 on
        mapped views but 0.06 on held-out views *while confident* (0.64
        mean conf) — view memorization, not appearance matching. Epoch-
        varying warps make the warped half a stream of ~N x epochs distinct
        geometries, which forces appearance-based matching. Called by
        ``TrainLoader.epoch``; resume-safe (epoch index is restored)."""
        self._epoch = int(epoch)

    def _load_anno(self, path: str) -> dict:
        if path not in self._anno_cache:
            anno = load_3d_annotation(path)
            if self.load_coarse:
                stem, ext = os.path.splitext(path)
                cpath = stem + "_coarse" + ext
                if os.path.exists(cpath):
                    anno["descriptors3d_coarse"] = load_3d_annotation(cpath)[
                        "descriptors3d"
                    ]
            self._anno_cache[path] = anno
        return self._anno_cache[path]

    def _load_image(self, rec: FrameRecord) -> tuple:
        img = imread_gray(rec.img_file)
        h, w = img.shape
        scale = np.array(
            [w / self.img_size, h / self.img_size], np.float32
        )  # orig/net
        img = resize_image(img, (self.img_size, self.img_size))
        if self.augmentor is not None:
            with self._aug_lock:
                img = self.augmentor(img)
        K = rec.K.copy().astype(np.float32)
        K[0] /= scale[0]
        K[1] /= scale[1]
        return img, K

    def __getitem__(self, index: int) -> dict:
        warped = False
        half = 0
        if self.image_warp_adapt:
            half = index % 2
            warped = half == 1 or self.image_warp_all
            index //= 2
        elif self.image_warp_all:
            # warp_all without warp_adapt: every sample warped, no doubling
            warped = True
        rec = self.records[index]
        rng = np.random.default_rng(self.seed * 1_000_003 + index * 2 + half)

        img, K = self._load_image(rec)
        anno = self._load_anno(rec.avg_anno3d_file)

        keep_idx = (
            rec.assign_pairs[1] if rec.assign_pairs is not None else None
        )
        pc = pad_point_cloud(
            anno["keypoints3d"],
            anno["descriptors3d"],
            anno.get("scores3d"),
            self.shape3d,
            rng,
            keep_idx=keep_idx,
        )
        out = {
            "keypoints3d": pc["keypoints3d"],
            "descriptors3d": pc["descriptors3d"],
            "scores3d": pc["scores3d"],
            "pose_gt": rec.pose.astype(np.float32),
            "intrinsics": K,
        }
        if "descriptors3d_coarse" in anno:
            # same slot layout as the fine descriptors (same orig_idx)
            dc = anno["descriptors3d_coarse"]
            slot_desc = np.zeros((self.shape3d, dc.shape[1]), np.float32)
            real = pc["orig_idx"] >= 0
            slot_desc[real] = dc[pc["orig_idx"][real]]
            out["descriptors3d_coarse"] = slot_desc

        # --- GT supervision: project REAL matched points with the GT pose
        gt_cell = np.full(self.shape3d, -1, np.int32)
        gt_fine = np.full((self.shape3d, 2), -50.0, np.float32)
        s_grid = self.img_size // self.coarse_stride
        matched_rows = (
            set(rec.assign_pairs[1].tolist())
            if rec.assign_pairs is not None
            else None
        )
        real_slots = np.flatnonzero(pc["orig_idx"] >= 0)
        pts = pc["keypoints3d"][real_slots]
        pcam = pts @ rec.pose[:3, :3].T.astype(np.float32) + rec.pose[
            :3, 3
        ].astype(np.float32)
        uvw = pcam @ K.T
        uv = uvw[:, :2] / np.clip(uvw[:, 2:3], 1e-6, None)

        if warped:
            # epoch-dependent rng: a FRESH homography per (sample, epoch) —
            # see set_epoch. Separate generator so every other draw in this
            # example (point padding, GT subsampling) keeps its original
            # per-index stream.
            # `half` keys the stream so with image_warp_all the two copies
            # of a record draw INDEPENDENT homographies (still 2N distinct
            # geometries per epoch)
            wrng = np.random.default_rng(
                (self.seed, 7, index, half, self._epoch)
            )
            H = sample_homography(self.img_size, self.img_size, wrng)
            img = warp_image(img, H)
            uv = warp_points(uv, H).astype(np.float32)

        cell_x = np.round(uv[:, 0] / self.coarse_stride).astype(np.int64)
        cell_y = np.round(uv[:, 1] / self.coarse_stride).astype(np.int64)
        inb = (
            (cell_x >= 0)
            & (cell_x < s_grid)
            & (cell_y >= 0)
            & (cell_y < s_grid)
            & (pcam[:, 2] > 1e-6)
        )
        for local_i in np.flatnonzero(inb):
            slot = real_slots[local_i]
            orig_row = int(pc["orig_idx"][slot])
            if matched_rows is not None and orig_row not in matched_rows:
                continue  # only SfM-observed correspondences supervise
            gt_cell[slot] = cell_y[local_i] * s_grid + cell_x[local_i]
            gt_fine[slot] = uv[local_i]

        out["query_image"] = img[..., None].astype(np.float32)
        out["gt_cell"] = gt_cell
        out["gt_fine_xy"] = gt_fine
        return out


class OnePosePlusInferenceDataset:
    """Per-object inference data: one shared annotation + per-frame queries
    (reference ``OnePosePlus_inference_dataset.py``)."""

    def __init__(
        self,
        anno_3d_file: str,
        records: Sequence[FrameRecord],
        img_size: int = 512,
        demo_mode: bool = False,
    ):
        self.annotation = load_3d_annotation(anno_3d_file)
        stem, ext = os.path.splitext(anno_3d_file)
        cpath = stem + "_coarse" + ext
        if os.path.exists(cpath):
            self.annotation["descriptors3d_coarse"] = load_3d_annotation(cpath)[
                "descriptors3d"
            ]
        self.records = list(records)
        self.img_size = img_size
        self.demo_mode = demo_mode

    def __len__(self):
        return len(self.records)

    def __getitem__(self, index: int) -> dict:
        rec = self.records[index]
        img = imread_gray(rec.img_file)
        h, w = img.shape
        scale = np.array([w / self.img_size, h / self.img_size], np.float32)
        img = resize_image(img, (self.img_size, self.img_size))
        K = rec.K.copy().astype(np.float32)
        K[0] /= scale[0]
        K[1] /= scale[1]
        out = {"image": img.astype(np.float32), "K": K}
        if not self.demo_mode and rec.pose is not None:
            out["pose_gt"] = rec.pose.astype(np.float32)
        return out

    def frames(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]


def batch_examples(examples: Sequence[dict]) -> Dict[str, np.ndarray]:
    """Stack per-example dicts into a batch (all fixed-shape by design)."""
    keys = examples[0].keys()
    return {k: np.stack([e[k] for e in examples], axis=0) for k in keys}


class TrainLoader:
    """Shuffling, batching, epoch-aware host loader with worker threads and
    batch prefetch.

    Equivalent of the reference's multi-worker torch DataLoader (bs 4,
    shuffle; ``src/datamodules/OnePosePlus_datamodule.py:9-108``):
    ``num_workers`` threads decode/assemble examples in parallel (image
    decode + GT projection release the GIL in numpy/cv2) and a background
    producer keeps up to ``prefetch`` assembled batches queued ahead of the
    consumer, so the accelerator step overlaps host-side input work.
    Variable-size collation never happens because every example is
    fixed-shape. Determinism: the batch order and every example's rng depend
    only on (seed, epoch, index), not on worker scheduling.

    Data-parallel ranks (``rank`` of ``world``) share one order of global
    batches of ``batch_size * world`` samples (``drop_last`` on the global
    batch, as the JAX package's loader over its mesh) and each loads its own
    ``batch_size`` of every global batch.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        seed: int = 0,
        drop_last=True,
        num_workers: int = 4,
        prefetch: int = 2,
        rank: int = 0,
        world: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.rank = rank
        self.world = world

    def _batch_starts(self, order: np.ndarray):
        """Start of this rank's shard in each global batch."""
        n, step = len(order), self.batch_size * self.world
        end = n - (n % step) if self.drop_last else n
        return range(self.rank * self.batch_size, end, step)

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        if hasattr(self.dataset, "set_epoch"):
            # epoch-fresh warp-adaptation homographies (set before the
            # producer thread starts; workers only read it afterwards)
            self.dataset.set_epoch(epoch_idx)
        order = np.random.default_rng(self.seed + epoch_idx).permutation(
            len(self.dataset)
        )
        if self.num_workers <= 0:
            for s in self._batch_starts(order):
                idxs = order[s : s + self.batch_size]
                yield batch_examples([self.dataset[int(i)] for i in idxs])
            return

        import queue
        from concurrent.futures import ThreadPoolExecutor

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as ex:
                    for s in self._batch_starts(order):
                        if stop.is_set():
                            return
                        idxs = [int(i) for i in order[s : s + self.batch_size]]
                        examples = list(ex.map(self.dataset.__getitem__, idxs))
                        q.put(batch_examples(examples))
                q.put(None)
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock the producer if the consumer bailed early
            while t.is_alive():
                try:
                    q.get_nowait()
                except Exception:
                    t.join(timeout=0.05)
