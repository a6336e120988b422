"""Port parity: the SfM stages and one whole ``run_sfm`` against the JAX package.

Stage tests feed both packages the same numpy inputs (simulated matches of
``tests/synthetic_scenes.py`` scenes, a synthetic COLMAP model) and run the
port's device stages on the CPU in float32. The last test runs ``run_sfm`` of
both packages on a tiny plane-rendered object with the same narrow LoFTR
weights (JAX ``init``, carried by ``utils.weights``).

Tolerances: host stages (pairs, keypoint merging, tracks, filtering,
annotation assembly) exact; triangulated points 1e-3 (float32 eigensolves of
two libraries); refined depths and points 1e-4 relative; descriptors 1e-4.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.config import (
    CoarseMatchingConfig,
    LoFTRConfig,
    ResNetFPNConfig,
    TransformerConfig,
)
from onepose_plus_plus_tpu.data import colmap_model as jax_colmap
from onepose_plus_plus_tpu.models.build import make_loftr_fns as jax_make_loftr_fns
from onepose_plus_plus_tpu.models.loftr import LoFTRMatcher as JaxLoFTR
from onepose_plus_plus_tpu.sfm import annotation as jax_annotation
from onepose_plus_plus_tpu.sfm import coarse_match as jax_cm
from onepose_plus_plus_tpu.sfm import filtering as jax_filtering
from onepose_plus_plus_tpu.sfm import pairs as jax_pairs
from onepose_plus_plus_tpu.sfm import post_optimization as jax_post
from onepose_plus_plus_tpu.sfm import runner as jax_runner
from onepose_plus_plus_tpu.sfm import tracks as jax_tracks
from onepose_plus_plus_tpu.sfm.triangulate import triangulate_scene as jax_triangulate_scene
from onepose_plus_plus_tpu_torch.data import colmap_model
from onepose_plus_plus_tpu_torch.models.build import make_loftr_fns
from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher
from onepose_plus_plus_tpu_torch.sfm import annotation, coarse_match, filtering, pairs, post_optimization, runner, tracks
from onepose_plus_plus_tpu_torch.sfm.cli import load_sequence
from onepose_plus_plus_tpu_torch.sfm.triangulate import triangulate_scene
from onepose_plus_plus_tpu_torch.utils.weights import load_jax_variables
from port_helpers import make_plane_object, perturbed, to_port_config
from synthetic_scenes import make_scene
from test_post_optimization import build_synthetic_model
from test_sfm_pipeline import simulate_matcher

torch.set_num_threads(2)


def _port_model(cams, imgs, pts):
    """A JAX package COLMAP model as the port's classes (deep copies)."""
    conv = lambda cls, d: {k: cls(**{f.name: np.copy(getattr(v, f.name)) if isinstance(  # noqa: E731
        getattr(v, f.name), np.ndarray) else getattr(v, f.name) for f in dataclasses.fields(v)})
        for k, v in d.items()}
    return conv(colmap_model.Camera, cams), conv(colmap_model.Image, imgs), conv(colmap_model.Point3D, pts)


def _assert_same_points(a, b, atol=0.0, rtol=0.0):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].xyz, b[k].xyz, atol=atol, rtol=rtol)
        np.testing.assert_array_equal(a[k].image_ids, b[k].image_ids)
        np.testing.assert_array_equal(a[k].point2D_idxs, b[k].point2D_idxs)


def _scene(noise=0.3, seed=0, outliers=0.2):
    rng = np.random.default_rng(seed)
    K, pts, Ts = make_scene(rng, n_views=6, n_pts=40)
    raw = simulate_matcher(K, Ts, pts, noise=noise, seed=seed, drop_frac=0.2)
    for pm in raw:
        n_bad = int(outliers * len(pm.pts0))
        pm.pts1[:n_bad] += rng.uniform(40, 80, (n_bad, 2))
    return raw, {i: K for i in range(6)}, {i: Ts[i] for i in range(6)}, pts


def test_pairs_match_jax():
    _, _, Ts = make_scene(np.random.default_rng(0), n_views=12)
    for nm, mr in ((3, 10.0), (10, 5.0)):
        assert pairs.pose_covisibility_pairs(list(Ts), nm, mr) == jax_pairs.pose_covisibility_pairs(list(Ts), nm, mr)
    assert pairs.exhaustive_pairs(7) == jax_pairs.exhaustive_pairs(7)
    assert pairs.index_window_pairs(9, 3) == jax_pairs.index_window_pairs(9, 3)


def test_run_pairs_and_merge_keypoints_match_jax():
    raw, _, _, _ = _scene()
    a, b = coarse_match.merge_keypoints(raw), jax_cm.merge_keypoints(raw)
    for field in ("keypoints", "scores", "match_indices", "match_confs"):
        da, db = getattr(a, field), getattr(b, field)
        assert da.keys() == db.keys()
        for k in da:
            np.testing.assert_array_equal(da[k], db[k])
    rng = np.random.default_rng(1)

    def fake_fn(img0, img1):
        n = img0.shape[0]
        return {"mkpts0_c": torch.from_numpy(rng.uniform(0, 64, (n, 8, 2)).astype(np.float32)),
                "mkpts1_c": torch.from_numpy(rng.uniform(0, 64, (n, 8, 2)).astype(np.float32)),
                "mconf": torch.from_numpy(rng.random((n, 8)).astype(np.float32)),
                "match_mask": torch.from_numpy(rng.random((n, 8)) > 0.4)}

    images = {i: np.zeros((32, 32), np.float32) for i in range(4)}
    scales = {i: np.array([2.0, 1.5], np.float32) for i in range(4)}
    prs = [(0, 1), (0, 2), (1, 3), (2, 3), (1, 2)]
    rng = np.random.default_rng(1)
    out_port = coarse_match.run_pairs(fake_fn, images, scales, prs, pair_batch=2)
    rng = np.random.default_rng(1)
    out_jax = jax_cm.run_pairs(lambda a, b: {k: v.numpy() for k, v in fake_fn(a, b).items()},
                               images, scales, prs, pair_batch=2)
    for pa, pb in zip(out_port, out_jax):
        assert pa.pair == pb.pair
        for f in ("pts0", "pts1", "conf"):
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))


def test_tracks_match_jax():
    raw, Ks, Ts, _ = _scene()
    scene = jax_cm.merge_keypoints(raw)
    counts = {i: len(k) for i, k in scene.keypoints.items()}
    got = tracks.build_tracks(counts, scene.match_indices, scene.match_confs)
    assert got == jax_tracks.build_tracks(counts, scene.match_indices, scene.match_confs, use_native=False)
    assert got == jax_tracks.build_tracks(counts, scene.match_indices, scene.match_confs)
    pa = tracks.tracks_to_arrays(got, scene.keypoints, Ks, Ts, 4)
    pb = jax_tracks.tracks_to_arrays(got, scene.keypoints, Ks, Ts, 4)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])


def test_triangulate_scene_matches_jax():
    raw, Ks, Ts, pts = _scene()
    scene = jax_cm.merge_keypoints(raw)
    sizes = {i: (512, 512) for i in range(6)}
    a = triangulate_scene(scene, Ks, Ts, sizes, device="cpu")
    b = jax_triangulate_scene(scene, Ks, Ts, sizes)
    _assert_same_points(a.points3d, b.points3d, atol=1e-3)
    for i in b.images:
        np.testing.assert_array_equal(a.images[i].point3D_ids, b.images[i].point3D_ids)
        np.testing.assert_allclose(a.images[i].qvec, b.images[i].qvec, atol=1e-6)
    assert a.stats["num_points3D"] == b.stats["num_points3D"] > 20
    assert abs(a.stats["mean_reprojection_error"] - b.stats["mean_reprojection_error"]) < 1e-3


@pytest.mark.parametrize("solver", ["lm", "first_order"])
def test_post_optimize_matches_jax(solver):
    model = build_synthetic_model(noise=0.3, perturb_depth=0.15)[:3]
    port = _port_model(*model)
    s_port = post_optimization.post_optimize(*port, solver=solver, device="cpu")
    s_jax = jax_post.post_optimize(*model, solver=solver)
    assert s_port["num_keyframes"] == s_jax["num_keyframes"]
    assert s_port["num_optimized"] == s_jax["num_optimized"] > 0
    np.testing.assert_allclose(s_port["mean_depth_change"], s_jax["mean_depth_change"], rtol=1e-4)
    _assert_same_points(port[2], model[2], rtol=1e-4, atol=1e-6)
    for i in model[1]:
        np.testing.assert_allclose(port[1][i].xys, model[1][i].xys, atol=1e-3)


def test_filtering_and_annotations_match_jax(tmp_path):
    model = build_synthetic_model(n_views=4, n_pts=30)[:3]
    model[2][1].xyz = model[2][0].xyz + 1e-5  # a pair to merge
    for pid in range(8):  # short tracks
        model[2][pid].image_ids = model[2][pid].image_ids[:2]
        model[2][pid].point2D_idxs = model[2][pid].point2D_idxs[:2]
    port = _port_model(*model)
    corners = np.array([[x, y, z] for z in (-0.25, 0.25) for y in (-0.2, 0.2) for x in (-0.25, 0.25)])
    results = []
    for pkg_f, pkg_a, (cams, imgs, p3d), out in ((filtering, annotation, port, "port"),
                                                 (jax_filtering, jax_annotation, model, "jax")):
        p3d = pkg_f.filter_by_3d_box(imgs, p3d, corners)
        tkl = pkg_f.track_length_for_budget(p3d, 15)
        p3d = pkg_f.filter_track_length(imgs, p3d, tkl)
        p3d = pkg_f.merge_close_points(imgs, p3d, 1e-3)
        rng = np.random.default_rng(0)
        desc = {i: rng.standard_normal((len(im.xys), 8)).astype(np.float32) for i, im in imgs.items()}
        res = pkg_a.build_annotations(imgs, p3d, desc, coarse_descriptors=desc,
                                      out_dir=str(tmp_path / out))
        results.append((tkl, p3d, imgs, res))
    (ta, pa, ia, ra), (tb, pb, ib, rb) = results
    assert ta == tb
    _assert_same_points(pa, pb)
    for i in ib:
        np.testing.assert_array_equal(ia[i].point3D_ids, ib[i].point3D_ids)
    for k in ("point_ids", "keypoints3d", "descriptors3d", "scores3d", "descriptors3d_coarse"):
        np.testing.assert_array_equal(ra[k], rb[k])
    assert ra["anno_2d"] == rb["anno_2d"]
    for f in ("anno_3d_average.npz", "anno_3d_average_coarse.npz", "anno_2d.json"):
        assert os.path.exists(tmp_path / "port" / f)


# ------------------------------------------------------------- whole run_sfm

NARROW = LoFTRConfig(
    backbone=ResNetFPNConfig(initial_dim=32, block_dims=(32, 48, 64)),
    coarse=TransformerConfig(d_model=64, nhead=8, layer_iter_n=2),
    coarse_matching=CoarseMatchingConfig(thr=1e-6, temperature=0.1, border_rm=2,
                                         border_two_sided=True, max_matches=128),
    fine=TransformerConfig(d_model=32, nhead=8, layer_iter_n=1),
)


def test_run_sfm_matches_jax(tmp_path):
    """Both packages' run_sfm on a 5-frame object of 128^2 with the same narrow
    LoFTR weights: the same matches, points, refined depths and annotations."""
    obj = make_plane_object(str(tmp_path / "data"), n_frames=5, img=128)
    paths, poses, Ks, corners = load_sequence(str(tmp_path / "data" / obj / "toy-1"))
    jm = JaxLoFTR(NARROW)
    probe = np.zeros((1, 128, 128, 1), np.float32)
    variables = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), probe, probe))
    port = LoFTRMatcher(to_port_config(NARROW)).eval()
    load_jax_variables(port, variables)
    kw = dict(down_ratio=1, covis_num=3, pair_batch=4, max_epipolar_error_px=8.0,
              save_vis3d=False, match_gallery_num=0)
    stats_port = runner.run_sfm(paths, poses, Ks, str(tmp_path / "port"), *make_loftr_fns(port)[:1],
                                refine_fn=make_loftr_fns(port)[1], extract_fn=make_loftr_fns(port)[2],
                                box_corners_3d=corners, cfg=runner.SfMConfig(**kw), device="cpu")
    jfns = jax_make_loftr_fns(jm, variables)
    stats_jax = jax_runner.run_sfm(paths, poses, Ks, str(tmp_path / "jax"), jfns[0], refine_fn=jfns[1],
                                   extract_fn=jfns[2], box_corners_3d=corners,
                                   cfg=jax_runner.SfMConfig(**kw))
    assert stats_port.keys() == stats_jax.keys()
    assert stats_port["num_points3D"] == stats_jax["num_points3D"] > 0
    for k in ("num_observations", "num_reg_images", "min_track_length"):
        assert stats_port[k] == stats_jax[k], k
    for k in ("mean_track_length", "mean_reprojection_error"):
        np.testing.assert_allclose(stats_port[k], stats_jax[k], rtol=1e-3, atol=1e-4)
    a = colmap_model.read_model(str(tmp_path / "port" / "model"))
    b = jax_colmap.read_model(str(tmp_path / "jax" / "model"))
    _assert_same_points(a[2], b[2], rtol=1e-3, atol=1e-4)  # coarse points 1e-3, then the depth solve
    with np.load(tmp_path / "port" / "anno" / "anno_3d_average.npz") as za, \
            np.load(tmp_path / "jax" / "anno" / "anno_3d_average.npz") as zb:
        assert za.files == zb.files
        np.testing.assert_allclose(za["keypoints3d"], zb["keypoints3d"], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(za["descriptors3d"], zb["descriptors3d"], atol=1e-4)
    with open(tmp_path / "port" / "anno" / "anno_2d.json") as fa, \
            open(tmp_path / "jax" / "anno" / "anno_2d.json") as fb:
        ja, jb = json.load(fa), json.load(fb)
    assert [e["assign_matrix"] for e in ja] == [e["assign_matrix"] for e in jb]
