"""The port's own entry points chained: SfM -> evaluation -> merge -> demo, and
the demo pipeline (parse a capture -> SfM -> demo).

``tests/test_cli_end_to_end.py`` chains the JAX package's CLIs (``run.py``,
``inference.py``, ``demo.py``, ``merge.py``; marked slow). This is the port's
chain, and each stage reads what the one before it wrote: the SfM CLI
(``python -m onepose_plus_plus_tpu_torch.sfm``) reconstructs a plane-rendered
object, the evaluation CLI (``...inference``) estimates the poses of its
frames against that SfM annotation, the merge CLI (``...merge``) collects the
SfM's 2D annotation into a COCO file, and the demo (``...demo``) tracks the
object with DB views named by the SfM ``model/`` directory. Every ``main`` runs
in this process (the command line's own config path, ``load_config`` over its
argv) with ``device=cpu``, float32 and the narrow widths of
``tests/test_torch_sfm_cli.py`` (matcher) and ``tests/test_torch_inference_cli.py``
(``NARROW_ARGS``), random weights from the CLIs' own seeds. The SfM's
descriptor extraction pads every image to 4096 keypoint slots; here an image
holds a few dozen at most, so the chain pads to 256 and checks that no
keypoint is left out. The chains run with h5py and matplotlib blocked, as
on the card's machine: the SfM writes its h5 exports and its match gallery
without them, and the chain reads both h5 files back with the port's reader
against ``raw_matches.pkl``. ``chip_smoke.py`` phase 11 runs the same chains
on the card at full width.

The second test is ``scripts/torch_demo_pipeline.sh`` in process: a synthetic
ARKit capture (``port_helpers.write_arkit_capture``) parsed by
``parse_scanned_data``, the SfM with ``+preprocess=sfm_demo`` on its annotate
sequence and the demo on its test sequence, at the same narrow widths.

With random weights the narrow matcher finds only a few consistent matches
a pair, so the SfM triangulates a few points and the poses are far off: the
chain checks that every stage runs on the last one's output and writes its
files, and holds the counts to bands around what runs of this file gave on
the CPU (6 frames of 128², the seeds above; each band's run value beside it),
wide enough for another CPU's summation order.
"""
import functools
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu_torch import demo, merge, parse_scanned_data
from onepose_plus_plus_tpu_torch.data.image_io import grouped_load_h5
from onepose_plus_plus_tpu_torch.inference import cli as inference_cli
from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher
from onepose_plus_plus_tpu_torch.sfm import cli as sfm_cli
from onepose_plus_plus_tpu_torch.sfm import runner
from port_helpers import make_plane_object, write_arkit_capture
from test_torch_inference_cli import NARROW_ARGS
from test_torch_sfm_cli import NARROW as NARROW_MATCHER

pytest.importorskip("cv2")
torch.set_num_threads(2)

N_FRAMES = 6
KEYPOINT_SLOTS = 256


@pytest.fixture
def narrow_matchers(monkeypatch):
    """Both CLIs that build a LoFTR matcher get the narrow one (random weights),
    and the SfM extracts descriptors over 256 keypoint slots an image."""
    monkeypatch.setattr(sfm_cli, "build_loftr_matcher",
                        lambda cfg_dict, device: LoFTRMatcher(NARROW_MATCHER).eval().to(device))
    monkeypatch.setattr(demo, "build_loftr_matcher",
                        lambda device: LoFTRMatcher(NARROW_MATCHER).eval().to(device))
    extract = runner.extract_keypoint_descriptors

    @functools.wraps(extract)
    def fewer_slots(extract_fn, images, colmap_images, **kwargs):
        assert max(len(im.xys) for im in colmap_images.values()) <= KEYPOINT_SLOTS
        return extract(extract_fn, images, colmap_images, kpt_capacity=KEYPOINT_SLOTS, **kwargs)

    monkeypatch.setattr(runner, "extract_keypoint_descriptors", fewer_slots)


@pytest.fixture
def card_modules(monkeypatch):
    """The card's machine has neither h5py nor matplotlib."""
    for name in ("h5py", "matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)


def check_hloc_exports(root, names):
    """Both h5 files, read with the port's reader, hold ``raw_matches.pkl``'s
    matches: per image the raw end points rounded to pixels (merged) with
    their summed confidences, per pair one index match per distinct rounded
    raw match with its largest confidence."""
    with open(root / "raw_matches.pkl", "rb") as f:
        raw = pickle.load(f)["raw"]
    feats, matches = grouped_load_h5(str(root / "feats-loftr.h5")), grouped_load_h5(str(root / "matches-loftr.h5"))
    ends = {}
    for pm in raw:
        for img, pts in zip(pm.pair, (pm.pts0, pm.pts1)):
            for p, c in zip(map(tuple, np.round(pts)), pm.conf):
                ends[img, p] = ends.get((img, p), 0.0) + c
    assert set(feats) == {names[i] for i, _ in ends}
    for i, name in names.items():
        if name not in feats:
            continue
        f = feats[name]
        kp = {tuple(p): s for p, s in zip(f["keypoints"].astype(np.float64), f["scores"])}
        assert kp.keys() == {p for j, p in ends if j == i} and len(kp) == len(f["keypoints"])
        np.testing.assert_allclose([kp[p] for p in kp], [ends[i, p] for p in kp], rtol=1e-6)
        assert f["descriptors"].shape == (256, len(kp)) and not f["descriptors"].any()
    assert set(matches) == {f"{names[i]}_{names[j]}" for i, j in (pm.pair for pm in raw)}
    for pm in raw:
        (i, j), m = pm.pair, matches[f"{names[pm.pair[0]]}_{names[pm.pair[1]]}"]
        got = np.c_[feats[names[i]]["keypoints"][m["matches"][:, 0]], feats[names[j]]["keypoints"][m["matches"][:, 1]]]
        best = {}
        for row, c in zip(map(tuple, np.c_[np.round(pm.pts0), np.round(pm.pts1)]), pm.conf):
            best[row] = max(best.get(row, -1.0), c)
        assert m["matches"].dtype == np.int64 and len(got) == len(best)
        assert {tuple(r) for r in got.astype(np.float64)} == set(best)
        np.testing.assert_allclose(m["matching_scores"], [best[tuple(r)] for r in got.astype(np.float64)], rtol=1e-6)
    return len(raw)


def test_sfm_then_inference_then_merge_then_demo(tmp_path, narrow_matchers, card_modules, monkeypatch, capsys):
    data, sfm, results = tmp_path / "data", tmp_path / "sfm_outputs", tmp_path / "results"
    obj = make_plane_object(str(data), obj="0001-toy-box", seq="toy-1", n_frames=N_FRAMES, img=128)
    root = sfm / obj

    # 1. SfM on the object's frames
    sfm_cli.main(["+preprocess=sfm_inference_onepose", "ids=null", f"dataset.data_dir={data}",
                  f"dataset.outputs_dir={sfm}", "dataset.down_ratio=1", "sfm.pair_batch=4",
                  "sfm.covis_num=5", "sfm.max_epipolar_error_px=8.0", "model.compute_dtype=float32",
                  "device=cpu"])
    for f in ("raw_matches.pkl", "feats-loftr.h5", "matches-loftr.h5", "stats.json",
              "model/cameras.bin", "model/images.bin", "model/points3D.bin",
              "anno/anno_3d_average.npz", "anno/anno_3d_average_coarse.npz", "anno/anno_2d.json",
              "vis3d/point_cloud_pre_filter.ply", "vis3d/point_cloud_post_filter.ply"):
        assert (root / f).exists(), f
    n_pairs = check_hloc_exports(root, {i: f"{i}.png" for i in range(N_FRAMES)})
    gallery = sorted(os.listdir(root / "vis3d" / "matches"))
    assert len(gallery) == min(6, n_pairs) and all(g.endswith(".png") for g in gallery)  # match_gallery_num: 6
    stats = json.loads((root / "stats.json").read_text())
    with np.load(root / "anno" / "anno_3d_average.npz") as z:
        n_pts = len(z["keypoints3d"])
        assert z["descriptors3d"].shape == (32, n_pts)
    assert stats["num_points3D"] == n_pts
    assert 4 <= n_pts <= 32, stats  # 8 points in the runs
    assert stats["mean_track_length"] >= 2.0, stats  # 2.125
    assert stats["mean_reprojection_error"] < 3.0, stats  # 2.215 px
    assert stats["num_reg_images"] >= 4, stats  # 6

    # 2. evaluation of the frames against the SfM annotation
    inference_cli.main(["+experiment=inference_onepose", "ids=null", f"dataset.data_dir={data}",
                        f"dataset.sfm_outputs_dir={sfm}", "dataset.img_resize=128", "dataset.shape3d=128",
                        "inference.num_hypotheses=64", f"output_dir={results}", "device=cpu", *NARROW_ARGS])
    lines = (results / "metrics.txt").read_text().splitlines()
    assert obj in "\n".join(lines) and lines[-1].startswith("ALL: {"), lines
    errors = json.loads((results / f"errors_{obj}.json").read_text())
    assert set(errors) == {"frames", "R_errs_deg", "t_errs_cm", "num_inliers", "num_matches"}
    assert len(errors["frames"]) == N_FRAMES
    assert all(np.isfinite(errors["R_errs_deg"])) and all(np.isfinite(errors["t_errs_cm"]))
    assert 1 <= sum(errors["num_matches"]) <= 8 * N_FRAMES  # 13 matches over the 6 frames

    # 3. merge: the SfM's 2D annotation as one COCO file
    merged = tmp_path / "train_anno.json"
    merge.main(["+preprocess=merge_anno", f"dataset.sfm_outputs_dir={sfm}",
                f"dataset.out_train_file={merged}", "dataset.out_val_file=null"])
    blob = json.loads(merged.read_text())
    n_anno2d = len(json.loads((root / "anno" / "anno_2d.json").read_text()))
    assert len(blob["images"]) == len(blob["annotations"]) == n_anno2d
    assert 4 <= n_anno2d <= N_FRAMES  # 6
    assert all(a["avg_anno3d_file"] == str(root / "anno" / "anno_3d_average.npz") for a in blob["annotations"])

    # 4. the tracking demo, its DB views named by the SfM model
    views = []
    detector = demo.LocalFeatureObjectDetector
    monkeypatch.setattr(demo, "LocalFeatureObjectDetector",
                        lambda fn, db, **kw: views.append(db.shape) or detector(fn, db, **kw))
    frames, video = tmp_path / "frames", tmp_path / "demo.mp4"
    demo.main(["+experiment=inference_demo", f"dataset.data_dir={data}", f"dataset.sfm_outputs_dir={sfm}",
               "dataset.img_resize=128", "dataset.shape3d=128", "demo.num_hypotheses=64",
               "demo.num_ref_views=3", f"demo.frames_dir={frames}", f"demo.output_video={video}",
               "device=cpu", *NARROW_ARGS])
    out = capsys.readouterr().out
    assert f"demo: {obj} on cpu" in out
    assert views == [(3, 128, 128)]  # frames the SfM model registered, not the blank fallback view
    assert sorted(os.listdir(frames)) == [f"{i:06d}.png" for i in range(N_FRAMES)]
    assert video.exists() and video.stat().st_size > 0


def test_demo_pipeline_parse_then_sfm_demo_then_demo(tmp_path, narrow_matchers, card_modules, capsys):
    """``scripts/torch_demo_pipeline.sh``'s three steps in process: a
    synthetic ARKit capture (a 30-frame annotate and an 8-frame test
    sequence of a textured plane) parsed at 128^2, the SfM with
    ``+preprocess=sfm_demo`` (every 5th frame: 6) on the annotate sequence,
    the demo on the test sequence with the SfM's model and annotation."""
    data, obj = tmp_path / "demo", "0001-plane"
    write_arkit_capture(str(data / obj / "plane-annotate"), np.linspace(-40, 40, 30), seed=0)
    write_arkit_capture(str(data / obj / "plane-test"), np.linspace(-25, 25, 8), seed=0)
    parse_scanned_data.main(["--scanned_object_path", str(data / obj), "--hw", "128"])
    for seq, n in (("plane-annotate", 30), ("plane-test", 8)):
        assert len(os.listdir(data / obj / seq / "color")) == n
        assert (data / obj / seq / "intrin_ba").is_dir() and (data / obj / seq / "poses_ba").is_dir()
    assert (data / obj / "box3d_corners.txt").exists()

    sfm = data / "sfm_model"
    sfm_cli.main(["+preprocess=sfm_demo", f"dataset.data_dir={data}", f"dataset.outputs_dir={sfm}",
                  "sfm.pair_batch=4", "sfm.max_epipolar_error_px=8.0", "model.compute_dtype=float32", "device=cpu"])
    assert "mapping 1 object(s) on cpu" in capsys.readouterr().out
    root = sfm / obj
    for f in ("raw_matches.pkl", "feats-loftr.h5", "matches-loftr.h5", "model/images.bin",
              "anno/anno_3d_average.npz", "anno/anno_2d.json", "vis3d/point_cloud_post_filter.ply"):
        assert (root / f).exists(), f
    paths = sfm_cli.load_sequence(str(data / obj / "plane-annotate"))[0][::5]  # sfm_demo: down_ratio 5
    check_hloc_exports(root, {i: os.path.basename(p) for i, p in enumerate(paths)})
    stats = json.loads((root / "stats.json").read_text())
    assert stats["num_points3D"] > 0 and stats["num_reg_images"] >= 2, stats

    frames, video = tmp_path / "frames", tmp_path / "demo.mp4"
    demo.main(["+experiment=inference_demo", f"dataset.data_dir={data}", f"dataset.sfm_outputs_dir={sfm}",
               "dataset.img_resize=128", "dataset.shape3d=128", "demo.num_hypotheses=64", "demo.num_ref_views=3",
               f"demo.frames_dir={frames}", f"demo.output_video={video}", "device=cpu", *NARROW_ARGS])
    assert f"demo: {obj} on cpu" in capsys.readouterr().out
    assert len(os.listdir(frames)) == 8 and video.exists() and video.stat().st_size > 0


@pytest.mark.parametrize("script,reference", [
    ("torch_demo_pipeline.sh", "demo_pipeline.sh"),
    ("torch_parse_linemod_objs.sh", "parse_linemod_objs.sh"),
])
def test_port_scripts_mirror_the_jax_scripts(script, reference):
    """``scripts/torch_*.sh`` parse as bash and run the JAX scripts' steps in
    the same order, each as ``python -m onepose_plus_plus_tpu_torch.<name>``
    of a port entry point that exists (``run.py``'s SfM is the ``sfm``
    package)."""
    import importlib
    import importlib.util
    import re
    import subprocess

    scripts = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
    assert subprocess.run(["bash", "-n", os.path.join(scripts, script)]).returncode == 0
    with open(os.path.join(scripts, script)) as f:
        steps = re.findall(r"python -m onepose_plus_plus_tpu_torch\.(\w+)", f.read())
    with open(os.path.join(scripts, reference)) as f:
        reference_steps = re.findall(r"(\w+)\.py", f.read())
    assert steps == [{"run": "sfm"}.get(s, s) for s in reference_steps] and steps
    for name in set(steps):
        module = f"onepose_plus_plus_tpu_torch.{name}"
        if importlib.util.find_spec(module).submodule_search_locations:  # a package: its __main__
            module += ".__main__"
        assert callable(importlib.import_module(module).main), module
