"""Keypoint-free SfM matching: covisible image pairs through LoFTR's coarse
matching (``run_pairs``, the ``match_coarse`` surface) and then fine
refinement of those matches (``run_fine_refinement``, the ``refine`` surface).

Set-up renders ``objects`` textured planar objects of ``frames_per_object``
views each, as a user's mapping capture, and lists their pairs by pose
covisibility. The window takes the pairs as a ring, ``pair_batch`` at a
time: one unit is one batch through both surfaces, as the SfM runner drives
them.

The numbers compared once the window has closed (PERF.md §6):

- ``unshared_confident``: the reference matches the pairs of ``check.batches``
  batches drawn from the seed in float32; the share of the confident matches
  (``check.confident`` and above) of either side that the other side lacks.
- ``fine_map_gap``: the program's 1/2 maps in ``refine`` (the fine stage's
  input) against the reference's, for ``check.fine_pairs`` pairs of each of
  the first ``check.fine_units`` units drawn from the seed, whose maps the
  window keeps (a copy of those rows as the backbone returns them).

Reported beside them, not compared (``benchmark.readings`` prints them):
``refine_*``, the refinement followed from the program's own state, the
reference's fine stage on the program's kept maps and coarse matches against
the program's refined positions. At random weights it does not separate the
control from sound runs by the factor three a limit needs (PERF.md §6), so
refinement is timed and not compared.

The control runs the program's int8 backbone, and in the fine stage, which
has no lower-precision path of its own, the reference with float8 operands in
the program's place.
"""
from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from .. import traffic as tf
from ..harness import clock
from ..reference import exact_fp32
from ..reference.model import LoFTR, fp8
from ..weights import centre_coarse_descriptors, draw_state_dict


class Driver:
    def __init__(self, ctx):
        self.ctx, self.tr, self.dev = ctx, ctx.traffic, ctx.device
        self.model_cfg = copy.deepcopy(ctx.config["model"])
        if ctx.control:  # the program's own int8 backbone in place of bf16
            self.model_cfg.setdefault("backbone", {})["quant_int8"] = True
        self.reference_s = 0.0  # set-up spent in the reference, left out of setup_s

    def setup(self):
        from onepose_plus_plus_tpu_torch.models.build import loftr_config_from_dict, make_loftr_fns
        from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher

        t, dev = self.tr, self.dev
        with torch.device("meta"):
            template = LoFTR(self.model_cfg).state_dict()
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.ctx.seed)
        weights = draw_state_dict(template, self.ctx.seed, dev)
        self.images: Dict[int, np.ndarray] = {}
        self.pairs: List[tuple] = []
        first = None
        for o in range(t["objects"]):
            spec = copy.deepcopy(t["object"])
            spec["path"]["phase"] = o * t["phase_step"]
            sets, _ = tf.plane_object(gen, spec, t["img"], {"seq": t["frames_per_object"]}, dev)
            first = sets["seq"][0] if first is None else first
            views, poses = sets["seq"][0].cpu().numpy(), sets["seq"][1]
            base = o * t["frames_per_object"]
            self.images.update({base + i: views[i] for i in range(len(views))})
            self.pairs += [(base + i, base + j)
                           for i, j in tf.covisibility_pairs(poses, t["covis_num"], t["min_rotation_deg"])]
        t0 = clock(dev)
        ref = LoFTR(self.model_cfg).to(dev).eval()
        ref.load_state_dict(weights)
        with exact_fp32():  # the coarse descriptors centred on the first object's views
            self.weights = centre_coarse_descriptors(weights, ref.backbone, first,
                                                     self.ctx.config["weights"]["coarse_descriptor_gain"])
        del ref, first
        self.reference_s += clock(dev) - t0
        self.matcher = LoFTRMatcher(loftr_config_from_dict(self.model_cfg))
        self.matcher.load_state_dict(self.weights)
        self.matcher.eval().to(dev)
        self.matcher.backbone.register_forward_hook(self._keep_fine_map)
        self.coarse_fn, self.refine_fn, _ = make_loftr_fns(self.matcher)
        self.scales = {i: np.ones(2) for i in self.images}
        self.next = 0
        self.done: List[tuple] = []  # (pairs, coarse matches) of every unit
        c = self.tr["check"]
        rng = np.random.default_rng([self.ctx.seed, 1])
        self.keep = {u: sorted(int(b) for b in rng.choice(t["pair_batch"], size=c["fine_pairs"], replace=False))
                     for u in range(c["fine_units"])}
        self.fine_maps: Dict[int, torch.Tensor] = {}  # unit -> kept rows of refine's 1/2 maps
        self.refined: Dict[int, dict] = {}  # unit -> run_fine_refinement's output
        self.rows = None

    def _keep_fine_map(self, module, inputs, output):
        """A copy of the kept pairs' rows of refine's 1/2 maps (images 0, then 1)."""
        if self.rows:
            pb = self.tr["pair_batch"]
            self.fine_maps[len(self.done)] = output[1][self.rows + [pb + b for b in self.rows]]

    def _batch(self) -> List[tuple]:
        pb = self.tr["pair_batch"]
        chunk = [self.pairs[(self.next + k) % len(self.pairs)] for k in range(pb)]
        self.next += pb
        return chunk

    def _run(self, chunk, rows=None):
        from onepose_plus_plus_tpu_torch.sfm.coarse_match import run_pairs
        from onepose_plus_plus_tpu_torch.sfm.post_optimization import RefinementPair, run_fine_refinement

        pb = self.tr["pair_batch"]
        raw = run_pairs(self.coarse_fn, self.images, self.scales, chunk, pair_batch=pb)
        refine = [RefinementPair(pm.pair, pm.pts0, pm.pts1, np.arange(len(pm.pts0))) for pm in raw]
        self.rows = rows
        refined = run_fine_refinement(self.refine_fn, self.images, refine,
                                      match_capacity=self.model_cfg["match_coarse"]["max_matches"], pair_batch=pb)
        self.rows = None
        return raw, refined

    def warm(self):
        self._run(self._batch())
        self.next = 0

    def unit(self) -> Dict[str, float]:
        chunk = self._batch()
        u = len(self.done)
        raw, refined = self._run(chunk, self.keep.get(u))
        if u in self.keep:
            self.refined[u] = refined
        self.done.append((chunk, raw))
        return {"pairs": len(chunk), "units": 1}

    def drain(self):
        pass

    def shapes(self) -> Dict:
        """The model and sizes, and the bytes a K6 launch must move on these
        matches: its windows written once and the distinct fine-map pixels they
        cover read once (mean over the first batches of the window)."""
        t, cfg = self.tr, self.model_cfg
        w, slots, img = cfg["fine_window_size"], cfg["match_coarse"]["max_matches"], t["img"]
        h_f, half = img // 2, cfg["fine_window_size"] // 2
        per_launch = []
        for chunk, raw in self.done[:8]:
            for side in (0, 1):
                pix = 0
                for pm in raw:
                    mk = np.zeros((slots, 2))
                    pts = pm.pts0 if side == 0 else pm.pts1
                    mk[:len(pts)] = pts[:slots]
                    c = np.round(mk / 2).astype(np.int64)
                    offs = np.arange(w) - half
                    r = np.broadcast_to((c[:, 1, None] + offs)[:, :, None], (slots, w, w))
                    q = np.broadcast_to((c[:, 0, None] + offs)[:, None, :], (slots, w, w))
                    ok = (r >= 0) & (r < h_f) & (q >= 0) & (q < h_f)
                    pix += np.unique((r * h_f + q)[ok]).size
                per_launch.append(len(raw) * slots * w * w * 128 * 2 + pix * 128 * 2 + len(raw) * slots * 8)
        return {"model": cfg, "img": img, "pair_batch": t["pair_batch"], "slots": slots,
                "k6_bytes": float(np.mean(per_launch)) if per_launch else 0.0}

    def release(self):
        del self.matcher, self.coarse_fn, self.refine_fn

    # ------------------------------------------------------------- check
    def check(self) -> Dict[str, float]:
        """The numbers of the module's docstring; ``lost_confident`` (the
        reference's confident matches the program lacks alone) and the refined
        positions' quantiles beside them."""
        c = self.tr["check"]
        rng = np.random.default_rng(self.ctx.seed)
        picks = sorted(rng.choice(len(self.done), size=min(c["batches"], len(self.done)), replace=False))
        ref = LoFTR(self.model_cfg).to(self.dev).eval()
        ref.load_state_dict(self.weights)
        tally = np.zeros(3)  # lacking (either side), confident (either side), the reference's lacking
        for p in picks:
            tally += self._check_batch(ref, *self.done[p])
        out = {"unshared_confident": float(tally[0] / max(tally[1], 1)),
               "lost_confident": float(tally[2] / max(tally[1], 1))}
        out.update(self._check_refine(ref))
        return out

    @torch.no_grad()
    def _check_batch(self, ref, chunk, raw) -> np.ndarray:
        """(confident matches of either side the other lacks, confident matches
        of either side, those of the reference the program lacks) of one batch:
        a match is its pair of coarse cells, in pixels."""
        img0 = torch.from_numpy(np.stack([self.images[i] for i, _ in chunk]))[..., None].to(self.dev)
        img1 = torch.from_numpy(np.stack([self.images[j] for _, j in chunk]))[..., None].to(self.dev)
        with exact_fp32():
            mk0, mk1, mconf, mask = (x.cpu().numpy() for x in ref.match_coarse(img0, img1))
        sure = self.tr["check"]["confident"]
        def key(a, z):
            return [(*p, *q) for p, q in zip(a.astype(np.int64).tolist(), z.astype(np.int64).tolist())]
        tally = np.zeros(3)
        for b, pm in enumerate(raw):
            prog = key(pm.pts0, pm.pts1)
            want = key(mk0[b][mask[b]], mk1[b][mask[b]])
            p_set, r_set = set(prog), set(want)
            r_sure = [k for k, cf in zip(want, mconf[b][mask[b]]) if cf >= sure]
            p_sure = [k for k, cf in zip(prog, pm.conf) if cf >= sure]
            r_lost = sum(k not in p_set for k in r_sure)
            tally += (r_lost + sum(k not in r_set for k in p_sure), len(r_sure) + len(p_sure), r_lost)
        return tally

    @torch.no_grad()
    def _check_refine(self, ref) -> Dict[str, float]:
        """``fine_map_gap`` and the refined positions' gaps (pixels) of the kept
        pairs; in the control, float8 operands take the program's fine stage."""
        img, pb = self.tr["img"], self.tr["pair_batch"]
        num = den = 0.0
        gaps = []
        with exact_fp32():
            for u, fmap in sorted(self.fine_maps.items()):
                chunk, raw = self.done[u]
                rows = self.keep[u]
                ids = [chunk[b][0] for b in rows] + [chunk[b][1] for b in rows]
                views = torch.from_numpy(np.stack([self.images[i] for i in ids]))[..., None].to(self.dev)
                f_ref = ref.fine_map(views)
                f_prog = fmap.float()
                num += float(((f_prog - f_ref) ** 2).sum())
                den += float((f_ref ** 2).sum())
                for k, b in enumerate(rows):
                    pm = raw[b]
                    if not len(pm.pts0):
                        continue
                    mk0 = torch.from_numpy(pm.pts0.astype(np.float32))[None].to(self.dev)
                    mk1 = torch.from_numpy(pm.pts1.astype(np.float32))[None].to(self.dev)
                    f0, f1 = f_prog[k:k + 1], f_prog[len(rows) + k:len(rows) + k + 1]
                    want = ref.refine_stage(f0, f1, mk0, mk1, img)[0]
                    if self.ctx.control:
                        got = ref.refine_stage(f0, f1, mk0, mk1, img, rnd=fp8)[0]
                    else:
                        got = torch.from_numpy(np.asarray(self.refined[u][pm.pair]["mkpts1_f"], np.float32))
                        got = got.to(self.dev)
                    gaps.append((got - want).norm(dim=-1).cpu().numpy())
        g = np.concatenate(gaps) if gaps else np.zeros(1)  # no kept pair had a match: nothing moved
        return {"fine_map_gap": float(np.sqrt(num / den)) if den else 0.0,
                "refine_p50_px": float(np.quantile(g, 0.5)), "refine_p90_px": float(np.quantile(g, 0.9)),
                "refine_p99_px": float(np.quantile(g, 0.99)), "refine_max_px": float(g.max()),
                "refine_over_half_px": float(np.mean(g > 0.5))}
