"""The port's tracking demo (``python -m onepose_plus_plus_tpu_torch.demo``) on the CPU.

A narrow matcher and a narrow LoFTR (random weights) on a plane-rendered
object of 128² frames with a synthetic annotation and a COLMAP model naming
its DB views. The demo writes a frame per input and the mp4, and runs the
detector exactly on the frames the inlier rule sends to it: frame 0, and each
frame after one whose PnP failed or had fewer than ``demo.min_track_inliers``
inliers; the others crop by the previous pose.
"""
import os

import pytest
import torch

from onepose_plus_plus_tpu_torch import demo
from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher
from port_helpers import make_plane_object, to_port_config, write_annotation, write_db_model
from test_torch_inference_cli import NARROW_ARGS
from test_torch_loftr import NARROW as NARROW_LOFTR

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)


@pytest.fixture
def setup(tmp_path, monkeypatch):
    obj = make_plane_object(str(tmp_path / "data"), obj="0001-toy", seq="toy-1", n_frames=6, img=128)
    write_annotation(str(tmp_path / "sfm"), obj, 300, 32, 64)
    write_db_model(str(tmp_path / "sfm"), obj, [f"{i}.png" for i in range(6)], 128)
    monkeypatch.setattr(demo, "build_loftr_matcher",
                        lambda device: LoFTRMatcher(to_port_config(NARROW_LOFTR)).eval().to(device))
    calls = {"coarse": 0, "views": []}

    def counted_fns(matcher, real=demo.make_loftr_fns):
        coarse, refine, extract = real(matcher)

        def counted(img0, img1):
            calls["coarse"] += 1
            calls["views"].append(img0.shape[0])
            return coarse(img0, img1)
        return counted, refine, extract

    monkeypatch.setattr(demo, "make_loftr_fns", counted_fns)
    argv = ["+experiment=inference_demo", f"dataset.data_dir={tmp_path / 'data'}",
            f"dataset.sfm_outputs_dir={tmp_path / 'sfm'}", "dataset.img_resize=128", "dataset.shape3d=200",
            "device=cpu", "demo.num_hypotheses=64", "demo.num_ref_views=3",
            f"demo.frames_dir={tmp_path / 'frames'}", f"demo.output_video={tmp_path / 'demo.mp4'}",
            *NARROW_ARGS]
    return tmp_path, argv, calls


def _expected_modes(log, min_inliers):
    modes = ["detect"]
    for prev in log[:-1]:
        modes.append("detect" if not prev["ok"] or prev["inliers"] < min_inliers else "track")
    return modes


def test_demo_writes_frames_and_video(setup, capsys):
    tmp_path, argv, calls = setup
    cfg = demo.load_config(str(demo.CONFIGS_DIR), argv + ["demo.min_track_inliers=4"])
    log = demo.demo(cfg)
    assert "WARNING: no onepose_weights" in capsys.readouterr().out
    assert len(log) == 6
    assert sorted(os.listdir(tmp_path / "frames")) == [f"{i:06d}.png" for i in range(6)]
    assert cv2.imread(str(tmp_path / "frames" / "000000.png")).shape == (128, 128, 3)
    assert os.path.getsize(tmp_path / "demo.mp4") > 0
    assert [r["mode"] for r in log] == _expected_modes(log, 4)
    assert calls["coarse"] == sum(r["mode"] == "detect" for r in log)
    assert set(calls["views"]) == {3}  # demo.num_ref_views DB views a detection
    assert all(r["seconds"] > 0 for r in log)


def test_demo_switches_by_the_inlier_rule(setup, monkeypatch):
    """The step's inlier counts and success flags are scripted: the modes
    follow the rule frame by frame."""
    tmp_path, argv, calls = setup
    script = [(30, True), (5, True), (25, True), (25, False), (3, True), (40, True)]

    def scripted_step(model, real=demo.make_query_step, **kwargs):
        step, it = real(model, **kwargs), iter(script)

        def run(batch, generator, gt):
            out = list(step(batch, generator, gt))
            n, ok = next(it)
            out[1], out[2] = torch.tensor([n]), torch.tensor([ok])
            return tuple(out)
        return run

    monkeypatch.setattr(demo, "make_query_step", scripted_step)
    log = demo.demo(demo.load_config(str(demo.CONFIGS_DIR), argv))  # min_track_inliers 20
    assert [r["mode"] for r in log] == ["detect", "track", "detect", "track", "detect", "detect"]
    assert [(r["inliers"], r["ok"]) for r in log] == script
    assert calls["coarse"] == 4


def test_demo_entry_point_usage():
    with pytest.raises(SystemExit):
        demo.main([])
