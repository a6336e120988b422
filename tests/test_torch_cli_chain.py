"""The port's own entry points chained on the CPU: SfM -> evaluation -> merge -> demo.

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
keypoint is left out. The card's machine has no h5py (the SfM writes its
features to h5), so the chain runs on the CPU only.

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

import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu_torch import demo, merge
from onepose_plus_plus_tpu_torch.inference import cli as inference_cli
from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher
from onepose_plus_plus_tpu_torch.sfm import cli as sfm_cli
from onepose_plus_plus_tpu_torch.sfm import runner
from port_helpers import make_plane_object
from test_torch_inference_cli import NARROW_ARGS
from test_torch_sfm_cli import NARROW as NARROW_MATCHER

pytest.importorskip("cv2")
pytest.importorskip("h5py")
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


def test_sfm_then_inference_then_merge_then_demo(tmp_path, narrow_matchers, monkeypatch, capsys):
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
