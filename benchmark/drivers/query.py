"""Query-pose inference: objects' test sequences through ``run_inference``.

Set-up renders ``objects`` textured planar objects, each a sequence of
``frames_per_object`` uint8 frames along the object's camera path, and gives
each a ``shape3d``-point cloud whose fine and coarse descriptors the plain
reference computes, with the same weights, at the points' pixels in
``ref_views`` views of the same path, ``ref_offset`` of their spacing past
the sequence's own views (the coarse one less the keypoint
encoding the matcher adds). So the published threshold admits real matches
and PnP works on real inlier sets. The window cycles the objects through
``run_inference(..., frame_batch=...)``, one object a unit.

The number compared once the window has closed (PERF.md §6):

- ``match_tail``: the reference runs the matcher in float32 on frames drawn
  from the seed; the program's matches are read from its model's outputs as
  the step made them (the window keeps a reference to each, no copy). A match
  is off where both found it and its confidence moved by more than
  ``check.conf_step``, or where one side lacks it although its confidence on
  the other side is ``conf_step`` or more above what the lacking side would
  have kept (the threshold, or its least kept confidence where its slots are
  full). The number is the share of the union that is off.

Reported beside it, not compared (``benchmark.readings`` prints them): at
random weights neither separates the control from sound runs by the factor
three a limit needs (PERF.md §6), so the fine stage and PnP are timed and
not compared.

- ``fine_map_gap``: the program's 1/2 map (the fine stage's input) against
  the reference's, at ``check.fine_frames`` frames of the first
  ``check.fine_units`` units drawn from the seed, whose maps the window keeps
  (a copy of those rows as the backbone returns them).
- ``fine_*``: the fine stage followed from the program's own state: the
  reference's fine stage on the program's kept map and matches, against the
  program's fine positions.

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
from ..reference.model import OnePosePlus, fp8, normalize_keypoints
from ..weights import centre_coarse_descriptors, draw_state_dict


class Driver:
    def __init__(self, ctx):
        self.ctx, self.tr, self.dev = ctx, ctx.traffic, ctx.device
        self.model_cfg = copy.deepcopy(ctx.config["model"])
        if ctx.control:  # the program's own int8 backbone in place of bf16
            self.model_cfg["loftr_backbone"]["quant_int8"] = True
        self.reference_s = 0.0  # set-up spent in the reference, left out of setup_s

    # ------------------------------------------------------------ set-up
    def setup(self):
        from onepose_plus_plus_tpu_torch.inference.pipeline import make_query_step
        from onepose_plus_plus_tpu_torch.models.build import onepose_config_from_dict
        from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel

        ctx = self.ctx
        with torch.device("meta"):
            template = OnePosePlus(self.model_cfg).state_dict()
        self.weights = draw_state_dict(template, ctx.seed, self.dev)
        self.objects = self._objects()
        ev = ctx.config["eval_metrics"]
        self.model = OnePosePlusModel(onepose_config_from_dict(self.model_cfg))
        self.model.load_state_dict(self.weights)
        self.model.eval().to(self.dev)
        self.model.backbone.register_forward_hook(self._keep_fine_map)
        self.step = make_query_step(self._recording_model, reproj_threshold_px=ev["pnp_reproj_thr"],
                                    num_hypotheses=ctx.config["inference"]["num_hypotheses"])
        self.records: List[tuple] = []
        self.done: List[tuple] = []  # (object index, its first record)
        self.next = 0
        self.keep = self._fine_plan()
        self.fine_maps: Dict[tuple, torch.Tensor] = {}
        self.unit_index, self.unit_first, self.rows = None, 0, None

    def _fine_plan(self) -> Dict[tuple, List[int]]:
        """(unit, step) -> the rows of that step's batch whose fine maps the
        window keeps: ``check.fine_frames`` frames of the first
        ``check.fine_units`` units, drawn from the seed."""
        c, n, fb = self.tr["check"], self.tr["frames_per_object"], self.tr["frame_batch"]
        rng = np.random.default_rng([self.ctx.seed, 1])
        keep: Dict[tuple, List[int]] = {}
        for p in sorted(rng.choice(c["fine_units"] * n, size=c["fine_frames"], replace=False)):
            u, f = divmod(int(p), n)
            keep.setdefault((u, f // fb), []).append(f % fb)
        return keep

    def _objects(self) -> List[Dict]:
        """Frames, K, GT poses and the reference-made point cloud of every
        object; the weights' coarse descriptors centred on the first object's
        reference views (``benchmark.weights.centre_coarse_descriptors``)."""
        t, dev = self.tr, self.dev
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.ctx.seed)
        rendered = []
        for o in range(t["objects"]):
            spec = copy.deepcopy(t["object"])
            spec["path"]["phase"] = o * t["phase_step"]
            spec["offsets"] = {"ref": t["ref_offset"] / t["ref_views"]}
            rendered.append(tf.plane_object(gen, spec, t["img"], {"seq": t["frames_per_object"],
                                                                 "ref": t["ref_views"]}, dev))
        t0 = clock(dev)
        ref = OnePosePlus(self.model_cfg).to(dev).eval()
        ref.load_state_dict(self.weights)
        with exact_fp32():
            self.weights = centre_coarse_descriptors(self.weights, ref.backbone, rendered[0][0]["ref"][0],
                                                     self.ctx.config["weights"]["coarse_descriptor_gain"])
        ref.load_state_dict(self.weights)
        self.reference_s += clock(dev) - t0
        objs = []
        for o, (sets, K) in enumerate(rendered):
            (views, poses), (ref_views, ref_poses) = sets["seq"], sets["ref"]
            frames = (views * 255).round().to(torch.uint8).cpu().numpy()
            cloud = self._cloud(ref, gen, ref_views, ref_poses, K)
            objs.append({"frames": [{"image": frames[i], "K": K.astype(np.float32),
                                     "pose_gt": poses[i].astype(np.float32)} for i in range(len(frames))],
                         "cloud": cloud, "index": o})
        del ref
        return objs

    @torch.no_grad()
    def _cloud(self, ref, gen, views, poses, K) -> Dict[str, np.ndarray]:
        """The points (drawn from the seed), then their descriptors by the
        reference (its time left out of set-up)."""
        t = self.tr
        per = t["shape3d"] // t["ref_views"]
        drawn = [tf.plane_points(gen, per + (t["shape3d"] - per * t["ref_views"] if v == 0 else 0), poses[v], K,
                                 t["img"], t["point_margin_px"]) for v in range(t["ref_views"])]
        t0 = clock(self.dev)
        coarse, fine = [], []
        with exact_fp32():
            for v, (_, uv) in enumerate(drawn):
                fc, ff = ref.coarse_map(views[v][None, ..., None])
                cell = torch.from_numpy(np.floor(uv).astype(np.int64)).to(self.dev)
                coarse.append(fc[0, cell[:, 1] // 8, cell[:, 0] // 8])
                fine.append(ff[0, cell[:, 1] // 2, cell[:, 0] // 2])
            kp = torch.from_numpy(np.concatenate([p for p, _ in drawn]).astype(np.float32)).to(self.dev)
            coarse = torch.cat(coarse) - ref.kpt_3d_pos_encoding.encoder(normalize_keypoints(kp[None]))[0]
        cloud = {"keypoints3d": kp.cpu().numpy(), "descriptors3d": torch.cat(fine).cpu().numpy(),
                 "descriptors3d_coarse": coarse.cpu().numpy()}
        self.reference_s += clock(self.dev) - t0
        return cloud

    def _recording_model(self, batch):
        """The model, with a reference kept to what each call matched (no copy, no sync)."""
        unit = self.unit_index
        self.rows = None if unit is None else self.keep.get((unit, len(self.records) - self.unit_first))
        out = self.model(batch)
        self.records.append((batch["keypoints3d"][0], out["i_ids"], out["j_ids"], out["mconf"], out["match_mask"],
                             out["mkpts_query_f"]))
        return out

    def _keep_fine_map(self, module, inputs, output):
        """A copy of the kept rows of the backbone's 1/2 map (none in most steps)."""
        if self.rows:
            self.fine_maps[(self.unit_index, len(self.records) - self.unit_first)] = output[1][self.rows]

    # ------------------------------------------------------------ window
    def _run(self, obj):
        from onepose_plus_plus_tpu_torch.inference.pipeline import run_inference
        t = self.tr
        return run_inference(self.model, obj["frames"], obj["cloud"], shape3d=t["shape3d"],
                             frame_batch=t["frame_batch"], rng_seed=obj["index"], step=self.step, device=self.dev)

    def warm(self):
        self._run(self.objects[0])
        self.records.clear()

    def unit(self) -> Dict[str, float]:
        obj = self.objects[self.next % len(self.objects)]
        self.next += 1
        self.unit_index, self.unit_first = len(self.done), len(self.records)
        self._run(obj)
        self.done.append((obj["index"], self.unit_first))
        self.unit_index = self.rows = None
        return {"frames": len(obj["frames"]), "objects": 1, "units": 1}

    def drain(self):
        pass

    def shapes(self) -> Dict:
        t = self.tr
        return {"model": self.model_cfg, "img": t["img"], "n_points": t["shape3d"], "frame_batch": t["frame_batch"],
                "slots": self.model_cfg["match_coarse"]["max_matches"]}

    def release(self):
        del self.model, self.step

    # ------------------------------------------------------------- check
    def check(self) -> Dict[str, float]:
        """The numbers of the module's docstring; ``conf_tail`` (the share of
        the matches both found whose confidence moved by more than the step)
        and the fine-position quantiles beside them."""
        c = self.tr["check"]
        rng = np.random.default_rng(self.ctx.seed)
        n_obj = len(self.objects[0]["frames"])
        picks = rng.choice(len(self.done) * n_obj, size=min(c["frames"], len(self.done) * n_obj), replace=False)
        ref = OnePosePlus(self.model_cfg).to(self.dev).eval()
        ref.load_state_dict(self.weights)
        tally = np.zeros(4)  # off, union, moved, common
        for d in sorted(set(picks // n_obj)):
            o, first = self.done[d]
            tally += self._check_object(ref, self.objects[o], first, np.sort(picks[picks // n_obj == d] % n_obj))
        out = {"match_tail": float(tally[0] / tally[1]) if tally[1] else 1.0,
               "conf_tail": float(tally[2] / tally[3]) if tally[3] else 1.0}
        out.update(self._check_fine(ref))
        return out

    @torch.no_grad()
    def _reference_matches(self, ref, obj, frames) -> Dict[str, np.ndarray]:
        cloud = {k: torch.from_numpy(v).to(self.dev) for k, v in obj["cloud"].items()}
        out = []
        blk = self.tr["check"]["ref_block"]
        with exact_fp32():
            for s in range(0, len(frames), blk):
                idx = frames[s:s + blk]
                img = torch.from_numpy(np.stack([obj["frames"][i]["image"] for i in idx])).to(self.dev)
                n = len(idx)
                r = ref(img[..., None].float() / 255.0, cloud["keypoints3d"][None].expand(n, -1, -1),
                        cloud["descriptors3d"][None].expand(n, -1, -1),
                        cloud["descriptors3d_coarse"][None].expand(n, -1, -1))
                out.append({k: r[k].cpu().numpy() for k in ("i_ids", "j_ids", "mconf", "mask")})
        return {k: np.concatenate([o[k] for o in out]) for k in out[0]}

    @staticmethod
    def _perm(obj, kp: torch.Tensor) -> np.ndarray:
        """The benchmark's point id of each row of the cloud the program was given
        (the program permutes the cloud)."""
        lookup = {row.tobytes(): i for i, row in enumerate(obj["cloud"]["keypoints3d"])}
        return np.array([lookup[row.tobytes()] for row in kp.cpu().numpy()])

    def _program_matches(self, obj, first: int, n_frames: int):
        """The program's matches of one object by frame, with the point ids of
        the benchmark's own cloud."""
        fb = self.tr["frame_batch"]
        steps = self.records[first:first + -(-n_frames // fb)]
        perm = self._perm(obj, steps[0][0])
        cat = lambda j: np.concatenate([s[j].cpu().numpy() for s in steps])  # noqa: E731
        frames = np.concatenate([s * fb + np.arange(len(st[1])) for s, st in enumerate(steps)])
        return frames, {"i_ids": perm[cat(1).astype(np.int64)], "j_ids": cat(2), "mconf": cat(3), "mask": cat(4)}

    def _check_object(self, ref, obj, first, wanted) -> np.ndarray:
        """(off, union, moved, common) over the wanted frames of one object; a
        match is its (point, cell)."""
        frames, prog = self._program_matches(obj, first, len(obj["frames"]))
        keep = np.isin(frames, wanted)  # a padded batch repeats its last frame
        prog = {k: v[keep] for k, v in prog.items()}
        want = self._reference_matches(ref, obj, list(frames[keep]))
        cells = (self.tr["img"] // 8) ** 2
        step, thr = self.tr["check"]["conf_step"], self.model_cfg["match_coarse"]["thr"]
        tally = np.zeros(4)
        for row in range(len(want["mask"])):
            pm, rm = prog["mask"][row], want["mask"][row]
            pkey = prog["i_ids"][row][pm].astype(np.int64) * cells + prog["j_ids"][row][pm]
            rkey = want["i_ids"][row][rm].astype(np.int64) * cells + want["j_ids"][row][rm]
            pc, rc = prog["mconf"][row][pm], want["mconf"][row][rm]
            _, a, b = np.intersect1d(pkey, rkey, assume_unique=True, return_indices=True)
            moved = int((np.abs(pc[a] - rc[b]) > step).sum())
            # what each side would have kept: its threshold, or its least confidence where its slots are full
            floor_p = pc.min() if pm.all() else thr
            floor_r = rc.min() if rm.all() else thr
            p_only, r_only = np.ones(len(pkey), bool), np.ones(len(rkey), bool)
            p_only[a], r_only[b] = False, False
            lacking = int((r_only & (rc >= floor_p + step)).sum() + (p_only & (pc >= floor_r + step)).sum())
            tally += (moved + lacking, len(pkey) + len(rkey) - len(a), moved, len(a))
        return tally

    @torch.no_grad()
    def _check_fine(self, ref) -> Dict[str, float]:
        """``fine_map_gap`` and the fine stage's position gaps (pixels) on the
        kept frames; in the control, float8 operands take the program's fine stage."""
        fb, img = self.tr["frame_batch"], self.tr["img"]
        h_c = img // 8
        num = den = 0.0
        gaps = []
        with exact_fp32():
            for (u, s), fmap in sorted(self.fine_maps.items()):
                o, first = self.done[u]
                obj, rows = self.objects[o], self.keep[(u, s)]
                kp, i_prog, j_ids, _, mask, mk_f = self.records[first + s]
                idx = [s * fb + r for r in rows]
                frames = torch.from_numpy(np.stack([obj["frames"][i]["image"] for i in idx])).to(self.dev)
                f_ref = ref.coarse_map(frames[..., None].float() / 255.0)[1]
                f_prog = fmap.float()
                num += float(((f_prog - f_ref) ** 2).sum())
                den += float((f_ref ** 2).sum())
                i_ids = torch.from_numpy(self._perm(obj, kp)).to(self.dev)[i_prog[rows].long()]
                d0 = torch.from_numpy(obj["cloud"]["descriptors3d"]).to(self.dev)[i_ids]
                j = j_ids[rows]
                want, _ = ref.fine_stage(f_prog, d0, j, (h_c, h_c), img)
                got = ref.fine_stage(f_prog, d0, j, (h_c, h_c), img, rnd=fp8)[0] if self.ctx.control \
                    else mk_f[rows].float()
                gaps.append((got - want).norm(dim=-1)[mask[rows]].cpu().numpy())
        g = np.concatenate(gaps) if gaps else np.zeros(0)
        if not g.size:  # no kept frame had a match: the fine stage moved nothing
            g = np.zeros(1)
        return {"fine_map_gap": float(np.sqrt(num / den)), "fine_p50_px": float(np.quantile(g, 0.5)),
                "fine_p90_px": float(np.quantile(g, 0.9)), "fine_p99_px": float(np.quantile(g, 0.99)),
                "fine_max_px": float(g.max()), "fine_over_half_px": float(np.mean(g > 0.5))}
