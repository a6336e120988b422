"""High-resolution pairs of mixed orientation through LoFTR's whole forward:
``run_pairs`` with the full-match surface (``models.build.make_loftr_match_fn``:
coarse and fine matching in one call), the images padded and masked as
LoFTR's MegaDepth loader does.

Set-up renders ``scenes`` textured planar scenes of ``views_per_scene`` views
each, as the SfM cell renders them, at ``long_side`` x ``short_side``: every
``portrait_every``-th view is portrait (``short_side`` wide), the others
landscape, each the centre band of a square render of side ``long_side``
(the same camera with the sensor turned). Pairs come from pose covisibility.
The window takes the pairs as a ring, ``pair_batch`` at a time, one batch a
unit; ``run_pairs`` pads each view bottom-right to ``long_side`` squared.

The numbers compared once the window has closed (PERF.md §6):

- ``unshared_confident``: the plain reference
  (``benchmark/reference/loftr_outdoor.py``, float32, its own padding and
  masks, every mutual match kept) matches each pair of ``check.batches``
  batches drawn from the seed, one pair at a time; the share of the confident
  coarse matches (``check.confident`` and above) of either side that the
  other side lacks.
- ``padded_matches``: the share of the program's valid matches, over every
  pair of the window, of which either end lies in a padded cell or in the
  band of ``border_rm`` cells inside its image's valid extent, where LoFTR
  keeps none. A sound run reads 0.
- ``fine_input_gap``: the program's merged fine windows (``merge_feat``'s
  output, kept for ``check.fine_pairs`` pairs of the first ``check.fine_units``
  units) against the reference's at the matches both sides found, as
  ‖program − reference‖ / ‖reference‖; 1 where no window was compared.

Reported beside them, not compared (``benchmark.readings`` prints them):
``fine_*``, the fine positions of those matches against the reference's, in
pixels; the slots' fill (``matches_max``, the most valid matches of any pair
of the window, sizes ``max_matches``). The control runs the program's int8
backbone.
"""
from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .. import traffic as tf
from ..harness import clock
from ..reference import exact_fp32
from ..reference.loftr_outdoor import LoFTROutdoor
from ..weights import centre_coarse_descriptors, draw_state_dict


class Driver:
    def __init__(self, ctx):
        self.ctx, self.tr, self.dev = ctx, ctx.traffic, ctx.device
        self.model_cfg = copy.deepcopy(ctx.config["model"])
        if ctx.control:  # the program's own int8 backbone in place of bf16
            self.model_cfg.setdefault("backbone", {})["quant_int8"] = True
        self.reference_s = 0.0  # set-up spent in the reference, left out of setup_s

    # ------------------------------------------------------------ set-up
    def setup(self):
        from onepose_plus_plus_tpu_torch.models.build import loftr_matcher_from_dict, make_loftr_match_fn

        t, dev = self.tr, self.dev
        with torch.device("meta"):
            template = LoFTROutdoor(self.model_cfg).state_dict()
        weights = draw_state_dict(template, self.ctx.seed, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.ctx.seed)
        self.images: Dict[int, np.ndarray] = {}
        self.pairs: List[tuple] = []
        first = None
        long, short = t["long_side"], t["short_side"]
        lo = (long - short) // 2
        for o in range(t["scenes"]):
            spec = copy.deepcopy(t["object"])
            spec["path"]["phase"] = o * t["phase_step"]
            sets, _ = tf.plane_object(gen, spec, long, {"seq": t["views_per_scene"]}, dev)
            views, poses = sets["seq"]
            first = views[:t["centre_views"]] if first is None else first
            base = o * t["views_per_scene"]
            for i in range(len(views)):
                portrait = i % t["portrait_every"] == t["portrait_every"] - 1
                band = views[i][:, lo:lo + short] if portrait else views[i][lo:lo + short]
                self.images[base + i] = band.contiguous().cpu().numpy()
            self.pairs += [(base + i, base + j)
                           for i, j in tf.covisibility_pairs(poses, t["covis_num"], t["min_rotation_deg"])]
        t0 = clock(dev)
        ref = LoFTROutdoor(self.model_cfg).to(dev).eval()
        ref.load_state_dict(weights)
        with exact_fp32():  # the coarse descriptors centred on the first scene's views
            self.weights = centre_coarse_descriptors(weights, ref.backbone, first,
                                                     self.ctx.config["weights"]["coarse_descriptor_gain"])
        del ref, first
        self.reference_s += clock(dev) - t0
        self.matcher = loftr_matcher_from_dict(self.model_cfg)
        self.matcher.load_state_dict(self.weights)
        self.matcher.eval().to(dev)
        self.matcher.fine_preprocess.register_forward_hook(self._keep_windows)
        self.match_fn = make_loftr_match_fn(self.matcher)
        self.scales = {i: np.ones(2) for i in self.images}
        self.next = 0
        self.done: List[tuple] = []  # (pairs, the match surface's outputs) of every unit
        c = self.tr["check"]
        rng = np.random.default_rng([self.ctx.seed, 1])
        self.keep = {u: sorted(int(b) for b in rng.choice(t["pair_batch"], size=c["fine_pairs"], replace=False))
                     for u in range(c["fine_units"])}
        self.windows: Dict[int, tuple] = {}  # unit -> kept rows of the merged fine windows (side 0, side 1)
        self.rows = None
        self.last = None

    def _keep_windows(self, module, inputs, output):
        """A copy of the kept pairs' merged fine windows (no sync)."""
        if self.rows:
            self.windows[len(self.done)] = (output[0][self.rows].clone(), output[1][self.rows].clone())

    def _match(self, *args):
        """The full-match surface, its outputs kept (host tensors, no copy)."""
        self.last = self.match_fn(*args)
        return self.last

    def _batch(self) -> List[tuple]:
        pb = self.tr["pair_batch"]
        chunk = [self.pairs[(self.next + k) % len(self.pairs)] for k in range(pb)]
        self.next += pb
        return chunk

    def _run(self, chunk, rows=None):
        from onepose_plus_plus_tpu_torch.sfm.coarse_match import run_pairs

        self.rows = rows
        raw = run_pairs(self._match, self.images, self.scales, chunk, pair_batch=self.tr["pair_batch"])
        self.rows = None
        return raw

    def warm(self):
        self._run(self._batch())
        self.next = 0

    def unit(self) -> Dict[str, float]:
        chunk = self._batch()
        u = len(self.done)
        self._run(chunk, self.keep.get(u))
        self.done.append((chunk, self.last))
        return {"pairs": len(chunk), "units": 1}

    def drain(self):
        pass

    def shapes(self) -> Dict:
        """The model and sizes, for readers that count a kernel's work: the
        padded side, the match slots and the pairs a batch."""
        return {"model": self.model_cfg, "img": self.tr["long_side"],
                "slots": self.model_cfg["match_coarse"]["max_matches"], "pair_batch": self.tr["pair_batch"]}

    def release(self):
        del self.matcher, self.match_fn

    # ------------------------------------------------------------- check
    def _padded(self, pair_id: int):
        """One view padded bottom-right to the square, and its coarse mask
        [1, h_c, w_c]: the pixel mask downsampled by nearest neighbour, as
        LoFTR's loader does (the reference's padding, apart from the program's)."""
        side, df = self.tr["long_side"], self.ctx.config["pairs"]["df"]
        im = torch.from_numpy(self.images[pair_id]).to(self.dev)
        img = F.pad(im, (0, side - im.shape[1], 0, side - im.shape[0]))[None, ..., None]
        mask = F.pad(torch.ones_like(im), (0, side - im.shape[1], 0, side - im.shape[0]))
        mask = F.interpolate(mask[None, None], scale_factor=1.0 / df, mode="nearest")[0].bool()
        return img, mask

    def _bad_cells(self, pts: np.ndarray, pair_id: int) -> np.ndarray:
        """Matches of which this end lies in padding or in the valid extent's border band."""
        df, bd = self.ctx.config["pairs"]["df"], self.model_cfg["match_coarse"]["border_rm"]
        h, w = self.images[pair_id].shape
        hc, wc = -(-h // df), -(-w // df)
        c, r = np.floor(pts[:, 0] / df), np.floor(pts[:, 1] / df)
        return (r < bd) | (c < bd) | (r >= hc - bd) | (c >= wc - bd)

    def check(self) -> Dict[str, float]:
        """The numbers of the module's docstring."""
        c = self.tr["check"]
        bad = total = full = pairs = most = 0
        for chunk, res in self.done:
            mask = np.asarray(res["match_mask"]).astype(bool)
            for b, (i, j) in enumerate(chunk):
                m = mask[b]
                p0, p1 = np.asarray(res["mkpts0_c"][b])[m], np.asarray(res["mkpts1_c"][b])[m]
                bad += int((self._bad_cells(p0, i) | self._bad_cells(p1, j)).sum())
                total += int(m.sum())
                full += int(m.all())
                most = max(most, int(m.sum()))
                pairs += 1
        rng = np.random.default_rng(self.ctx.seed)
        picks = sorted(rng.choice(len(self.done), size=min(c["batches"], len(self.done)), replace=False))
        ref = LoFTROutdoor(self.model_cfg).to(self.dev).eval()
        ref.load_state_dict(self.weights)
        tally = np.zeros(3)  # lacking (either side), confident (either side), the reference's lacking
        fine = {"num": 0.0, "den": 0.0, "gaps": []}
        for p in sorted(set(picks) | set(self.windows)):
            chunk, res = self.done[p]
            for b in range(len(chunk)):
                kept = p in self.windows and b in self.keep.get(p, [])
                if p in picks or kept:
                    t = self._check_pair(ref, chunk[b], res, b, fine if kept else None,
                                         self.keep[p].index(b) if kept else None, p)
                    if p in picks:
                        tally += t
        g = np.concatenate(fine["gaps"]) if fine["gaps"] else np.zeros(1)
        return {"unshared_confident": float(tally[0] / max(tally[1], 1)),
                "lost_confident": float(tally[2] / max(tally[1], 1)),
                "padded_matches": float(bad / max(total, 1)),
                "fine_input_gap": float(np.sqrt(fine["num"] / fine["den"])) if fine["den"] else 1.0,
                "fine_p50_px": float(np.quantile(g, 0.5)), "fine_p90_px": float(np.quantile(g, 0.9)),
                "fine_max_px": float(g.max()), "matches_per_pair": float(total / max(pairs, 1)),
                "matches_max": float(most), "slots_full_pairs": float(full)}

    @torch.no_grad()
    def _check_pair(self, ref, pair, res, b, fine, row, unit) -> np.ndarray:
        """(confident matches of either side the other lacks, confident matches
        of either side, those of the reference the program lacks) of one pair;
        where ``fine`` is given, the merged windows' and fine positions' gaps at
        the matches both found added to it. A match is its pair of coarse cells,
        in pixels."""
        i, j = pair
        (img0, m0), (img1, m1) = self._padded(i), self._padded(j)
        with exact_fp32():
            r = ref(img0, img1, m0, m1)[0]
        mask = np.asarray(res["match_mask"][b]).astype(bool)
        prog0, prog1 = np.asarray(res["mkpts0_c"][b])[mask], np.asarray(res["mkpts1_c"][b])[mask]
        pconf = np.asarray(res["mconf"][b])[mask]
        key = lambda a, z: [(*p, *q) for p, q in zip(a.astype(np.int64).tolist(), z.astype(np.int64).tolist())]  # noqa: E731
        prog = key(prog0, prog1)
        want = key(r["mkpts0_c"].cpu().numpy(), r["mkpts1_c"].cpu().numpy())
        rconf = r["mconf"].cpu().numpy()
        sure = self.tr["check"]["confident"]
        p_set, r_set = set(prog), set(want)
        r_sure = [k for k, cf in zip(want, rconf) if cf >= sure]
        p_sure = [k for k, cf in zip(prog, pconf) if cf >= sure]
        r_lost = sum(k not in p_set for k in r_sure)
        if fine is not None:
            slot = np.nonzero(mask)[0]
            where = {k: s for k, s in zip(prog, slot)}
            common = [(where[k], n) for n, k in enumerate(want) if k in where]
            if common:
                ps = torch.tensor([a for a, _ in common], device=self.dev)
                rs = torch.tensor([n for _, n in common], device=self.dev)
                w0, w1 = self.windows[unit]
                got = torch.cat([w0[row][ps], w1[row][ps]]).float()
                exp = torch.cat([r["win0"][rs], r["win1"][rs]])
                fine["num"] += float(((got - exp) ** 2).sum())
                fine["den"] += float((exp ** 2).sum())
                mk1 = torch.from_numpy(np.asarray(res["mkpts1_f"][b])).to(self.dev)[ps]
                fine["gaps"].append((mk1 - r["mkpts1_f"][rs]).norm(dim=-1).cpu().numpy())
        return np.array([r_lost + sum(k not in r_set for k in p_sure), len(r_sure) + len(p_sure), r_lost])
