"""The port's own copies of the JAX package's host modules, held to the originals.

The port imports nothing of the JAX package, so it keeps copies of the host
code it needs: ``config.py``, ``data/`` (preprocessing, image_io, homography,
dataset, augment, colmap_model), ``utils/config_loader.py``, the numpy
functions of ``eval/`` (metrics, cad, trajectory),
``utils/visualization.py``, ``utils/template_utils.py`` and
``data/colmap_database.py``. Each copy must behave as its original on the same
inputs: exactly, since both are the same numpy code.
"""
import dataclasses
import inspect
import os
from pathlib import Path

import numpy as np
import pytest

from onepose_plus_plus_tpu import config as jax_config
from onepose_plus_plus_tpu.data import augment as jax_augment
from onepose_plus_plus_tpu.data import colmap_database as jax_colmap_db
from onepose_plus_plus_tpu.data import colmap_model as jax_colmap
from onepose_plus_plus_tpu.data import dataset as jax_dataset
from onepose_plus_plus_tpu.data import preprocessing as jax_pre
from onepose_plus_plus_tpu import eval as jax_eval
from onepose_plus_plus_tpu.eval.metrics import aggregate_metrics as jax_aggregate
from onepose_plus_plus_tpu.utils import template_utils as jax_template
from onepose_plus_plus_tpu.utils import visualization as jax_vis
from onepose_plus_plus_tpu.utils.config_loader import load_config as jax_load_config
from onepose_plus_plus_tpu_torch import config as port_config
from onepose_plus_plus_tpu_torch.data import augment as port_augment
from onepose_plus_plus_tpu_torch.data import colmap_database as port_colmap_db
from onepose_plus_plus_tpu_torch.data import colmap_model as port_colmap
from onepose_plus_plus_tpu_torch.data import dataset as port_dataset
from onepose_plus_plus_tpu_torch.data import preprocessing as port_pre
from onepose_plus_plus_tpu_torch import eval as port_eval
from onepose_plus_plus_tpu_torch.eval.metrics import aggregate_metrics
from onepose_plus_plus_tpu_torch.utils import template_utils as port_template
from onepose_plus_plus_tpu_torch.utils import visualization as port_vis
from onepose_plus_plus_tpu_torch.utils.config_loader import load_config
from port_helpers import to_port_config
from synthetic_scenes import make_scene

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
CONFIG_CLASSES = sorted(n for n, c in vars(jax_config).items()
                        if inspect.isclass(c) and dataclasses.is_dataclass(c))
YAMLS = sorted(str(p.relative_to(CONFIGS)) for p in CONFIGS.glob("*/*.yaml"))


def _fields(cls):
    return [(f.name, f.type) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_dataclasses_have_the_same_fields_and_defaults(name):
    jcls, pcls = getattr(jax_config, name), getattr(port_config, name)
    assert _fields(pcls) == _fields(jcls)
    assert pcls() == to_port_config(jcls())  # defaults, recursively
    assert pcls.__dataclass_params__.frozen and jcls.__dataclass_params__.frozen
    for prop in ("layer_sequence",):
        if hasattr(jcls, prop):
            assert getattr(pcls(), prop) == getattr(jcls(), prop)


def test_config_copy_has_every_class():
    port_classes = sorted(n for n, c in vars(port_config).items()
                          if inspect.isclass(c) and dataclasses.is_dataclass(c))
    assert port_classes == CONFIG_CLASSES


@pytest.mark.parametrize("yaml_file", YAMLS)
def test_load_config_matches_on_every_yaml(yaml_file):
    group, fname = yaml_file.split("/")
    argv = [f"+{group}={fname}", "a.b=1e-6", "model.compute_dtype=float32", "ids=null"]
    assert load_config(str(CONFIGS), argv) == jax_load_config(str(CONFIGS), argv)


def test_load_config_root_and_bad_arguments():
    assert load_config(str(CONFIGS), []) == jax_load_config(str(CONFIGS), [])
    for bad in (["nokey"], ["+experiment=missing.yaml"]):
        with pytest.raises((ValueError, FileNotFoundError)):
            load_config(str(CONFIGS), bad)


def test_pad_point_cloud_matches():
    rng = np.random.default_rng(0)
    for n, cap in ((50, 80), (120, 80)):
        kpts = rng.standard_normal((n, 3)).astype(np.float32)
        desc = rng.standard_normal((n, 16)).astype(np.float32)
        scores = rng.random(n).astype(np.float32)
        keep = np.arange(0, n, 7)
        a = port_pre.pad_point_cloud(kpts, desc, scores, cap, rng=np.random.default_rng(1), keep_idx=keep)
        b = jax_pre.pad_point_cloud(kpts, desc, scores, cap, rng=np.random.default_rng(1), keep_idx=keep)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_aggregate_metrics_matches():
    rng = np.random.default_rng(1)
    R, t = rng.uniform(0, 6, 40), rng.uniform(0, 6, 40)
    flags = rng.random(40) > 0.5
    assert aggregate_metrics(R, t, flags, ~flags) == jax_aggregate(R, t, flags, ~flags)
    assert aggregate_metrics([], []) == jax_aggregate([], [])


def _model(pkg, seed=0):
    """A small COLMAP model built from one package's classes."""
    rng = np.random.default_rng(seed)
    cams = {i: pkg.Camera(i, "PINHOLE", 640, 480, rng.uniform(100, 500, 4)) for i in (1, 2)}
    imgs = {}
    for i in (1, 2, 3):
        q = rng.standard_normal(4)
        imgs[i] = pkg.Image(i, q / np.linalg.norm(q), rng.standard_normal(3), 1 + i % 2, f"{i}.png",
                            rng.uniform(0, 480, (9, 2)), rng.integers(-1, 5, 9).astype(np.int64))
    pts = {p: pkg.Point3D(p, rng.standard_normal(3), rng.integers(0, 255, 3).astype(np.uint8),
                          float(rng.random()), np.array([1, 2, 3], np.int64), np.array([0, 4, 8], np.int64))
           for p in range(5)}
    return cams, imgs, pts


def _same_model(a, b):
    for da, db in zip(a, b):
        assert da.keys() == db.keys()
        for k in da:
            for f in dataclasses.fields(da[k]):
                va, vb = getattr(da[k], f.name), getattr(db[k], f.name)
                if isinstance(va, np.ndarray):
                    np.testing.assert_array_equal(va, vb)
                else:
                    assert va == vb


@pytest.mark.parametrize("ext", [".bin", ".txt"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_colmap_model_written_by_one_package_is_read_by_the_other(tmp_path, ext, writer):
    w, r = (port_colmap, jax_colmap) if writer == "port" else (jax_colmap, port_colmap)
    model = _model(w)
    w.write_model(*model, str(tmp_path), ext=ext)
    _same_model(r.read_model(str(tmp_path), ext=ext), model)
    assert r.model_stats(*model) == w.model_stats(*model)


def _records(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    n_pts = 40
    K, pts, Ts = make_scene(rng, n_views=2, n_pts=n_pts, img=96.0)
    anno = str(tmp_path / "anno_3d_average.npz")
    jax_pre.save_3d_annotation(anno, pts.astype(np.float32),
                               rng.standard_normal((n_pts, 8)).astype(np.float32),
                               np.ones(n_pts, np.float32))
    jax_pre.save_3d_annotation(str(tmp_path / "anno_3d_average_coarse.npz"), pts.astype(np.float32),
                               rng.standard_normal((n_pts, 16)).astype(np.float32),
                               np.ones(n_pts, np.float32))
    out = []
    for i in range(2):
        p = str(tmp_path / f"{i}.png")
        cv2.imwrite(p, (rng.random((96, 96)) * 255).astype(np.uint8))
        out.append(dict(img_file=p, pose=Ts[i], K=K, avg_anno3d_file=anno,
                        assign_pairs=np.stack([np.arange(n_pts), np.arange(n_pts)])))
    return out


def test_train_dataset_examples_match(tmp_path):
    pytest.importorskip("cv2")
    recs = _records(tmp_path)
    examples = []
    for pkg, aug in ((port_dataset, port_augment), (jax_dataset, jax_augment)):
        records = [pkg.FrameRecord(**r) for r in recs]
        ds = pkg.OnePosePlusTrainDataset(records, img_size=64, shape3d=48, image_warp_adapt=True,
                                         augmentor=aug.build_augmentor("dark", 3), seed=3)
        ds.set_epoch(1)
        examples.append([ds[i] for i in range(len(ds))])
    assert len(examples[0]) == len(examples[1]) == 4  # two frames and their warped copies
    for a, b in zip(*examples):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_port_config_loader_has_no_compile_cache_hook():
    from onepose_plus_plus_tpu_torch.utils import config_loader

    assert not hasattr(config_loader, "_enable_persistent_compile_cache")
    assert "jax" not in Path(config_loader.__file__).read_text()
    assert os.path.basename(config_loader.__file__) == "config_loader.py"


EVAL_NAMES = ("query_pose_error", "add_metric", "projection_2d_error", "model_diameter_from_bbox",
              "aggregate_metrics", "SYMMETRIC_OBJ_IDS", "load_ply_vertices", "sample_points_on_cad",
              "model_diameter_from_vertices", "load_cad_for_eval", "umeyama_alignment",
              "absolute_trajectory_error", "camera_centers_from_poses", "batched_pose_errors")


def test_eval_package_exports_the_same_names():
    assert set(n for n in dir(jax_eval) if not n.startswith("_")) >= set(EVAL_NAMES)
    for name in EVAL_NAMES:
        assert hasattr(port_eval, name), name
    assert port_eval.SYMMETRIC_OBJ_IDS == jax_eval.SYMMETRIC_OBJ_IDS


def _poses(rng, n):
    K, _, Ts = make_scene(rng, n_views=n, n_pts=8)
    noisy = Ts.copy()
    noisy[:, :3, 3] += rng.normal(0, 0.01, (n, 3))
    return K, Ts, noisy


@pytest.mark.parametrize("symmetric", [False, True])
def test_pose_metrics_match(symmetric):
    rng = np.random.default_rng(2)
    K, Ts, noisy = _poses(rng, 4)
    pts = rng.uniform(-0.1, 0.1, (300, 3))
    for a, b in zip(noisy, Ts):
        assert port_eval.query_pose_error(a, b) == jax_eval.query_pose_error(a, b)
        for d in (0.05, 0.2):
            assert (port_eval.add_metric(a, b, pts, d, symmetric=symmetric)
                    == jax_eval.add_metric(a, b, pts, d, symmetric=symmetric))
        for thr in (1.0, 5.0):
            assert (port_eval.projection_2d_error(a, b, pts, K, thr)
                    == jax_eval.projection_2d_error(a, b, pts, K, thr))
    corners = rng.uniform(-1, 1, (8, 3))
    assert port_eval.model_diameter_from_bbox(corners) == jax_eval.model_diameter_from_bbox(corners)


def _write_ply(path, verts, binary):
    header = (f"ply\nformat {'binary_little_endian' if binary else 'ascii'} 1.0\nelement vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\nproperty uchar red\n"
              "element face 0\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        for v in verts:
            if binary:
                import struct
                f.write(struct.pack("<fffB", *v, 7))
            else:
                f.write(f"{v[0]} {v[1]} {v[2]} 7\n".encode())


@pytest.mark.parametrize("binary", [False, True])
def test_cad_helpers_match(tmp_path, binary):
    verts = np.random.default_rng(3).uniform(-50, 50, (1500, 3)).astype(np.float32)
    path = str(tmp_path / "m.ply")
    _write_ply(path, verts, binary)
    a, b = port_eval.load_ply_vertices(path), jax_eval.load_ply_vertices(path)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, verts, rtol=1e-6)
    np.testing.assert_array_equal(port_eval.sample_points_on_cad(a, 100, seed=4),
                                  jax_eval.sample_points_on_cad(a, 100, seed=4))
    assert port_eval.model_diameter_from_vertices(a) == jax_eval.model_diameter_from_vertices(a)
    pa, da = port_eval.load_cad_for_eval(path, n_points=200, unit_scale=0.001)
    pb, db = jax_eval.load_cad_for_eval(path, n_points=200, unit_scale=0.001)
    np.testing.assert_array_equal(pa, pb)
    assert da == db


@pytest.mark.parametrize("align,with_scale", [(True, True), (True, False), (False, True)])
def test_trajectory_helpers_match(align, with_scale):
    rng = np.random.default_rng(5)
    _, Ts, noisy = _poses(rng, 12)
    est, gt = port_eval.camera_centers_from_poses(noisy), port_eval.camera_centers_from_poses(Ts)
    np.testing.assert_array_equal(est, jax_eval.camera_centers_from_poses(noisy))
    est = 1.7 * est + 0.3  # a similarity away from the GT
    for x, y in zip(port_eval.umeyama_alignment(est, gt, with_scale),
                    jax_eval.umeyama_alignment(est, gt, with_scale)):
        np.testing.assert_array_equal(x, y)
    a = port_eval.absolute_trajectory_error(est, gt, align, with_scale)
    b = jax_eval.absolute_trajectory_error(est, gt, align, with_scale)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_visualization_matches(tmp_path):
    pytest.importorskip("cv2")
    rng = np.random.default_rng(6)
    K, Ts, _ = _poses(rng, 3)
    corners = np.array([[x, y, z] for z in (-0.2, 0.2) for y in (-0.2, 0.2) for x in (-0.2, 0.2)])
    assert port_vis.BOX_EDGES == jax_vis.BOX_EDGES
    image = rng.random((128, 160)).astype(np.float32)
    paths = {}
    for name, vis in (("port", port_vis), ("jax", jax_vis)):
        uv = vis.project_box_corners(corners, Ts[0], K)
        np.testing.assert_array_equal(uv, jax_vis.project_box_corners(corners, Ts[0], K))
        np.testing.assert_array_equal(vis.draw_3d_box(image, uv), jax_vis.draw_3d_box(image, uv))
        garbage = np.full((8, 2), 1e12)  # poses before tracking locks on project far away
        np.testing.assert_array_equal(vis.draw_3d_box(image, garbage), jax_vis.draw_3d_box(image, garbage))
        paths[name] = []
        for i, T in enumerate(Ts):
            paths[name].append(str(tmp_path / name / f"{i}.png"))
            vis.save_demo_frame(image, T, K, corners, paths[name][-1], inliers=i)
        vis.make_video(paths[name], str(tmp_path / name / "v.mp4"), fps=5)
    for a, b in zip(paths["port"], paths["jax"]):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    assert (tmp_path / "port" / "v.mp4").stat().st_size > 0


def test_visualization_line_fallback_without_cv2(monkeypatch):
    """Without OpenCV the copy draws lines point by point, as the original."""
    monkeypatch.setattr(port_vis, "_HAS_CV2", False)
    monkeypatch.setattr(jax_vis, "_HAS_CV2", False)
    image = np.zeros((64, 64, 3), np.uint8)
    uv = np.array([[5, 5], [50, 5], [50, 50], [5, 50]] * 2, np.float64)
    a, b = port_vis.draw_3d_box(image, uv), jax_vis.draw_3d_box(image, uv)
    np.testing.assert_array_equal(a, b)
    assert a.any()


# ------------------------------------ colmap_database and template_utils


def _db_rows(path):
    """Every row of every table of a sqlite file, in key order."""
    import sqlite3

    conn = sqlite3.connect(path)
    tables = sorted(r[0] for r in conn.execute("SELECT name FROM sqlite_master WHERE type='table'"))
    rows = {t: conn.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall() for t in tables}
    conn.close()
    return rows


def test_colmap_database_export_matches(tmp_path):
    """The same matched scene written by both copies: equal tables row by row,
    and each copy reads back the other's keypoints and matches."""
    rng = np.random.default_rng(4)
    kpts = {i: rng.uniform(0, 500, (20 + i, 2)).astype(np.float32) for i in range(3)}
    matches = {(0, 1): rng.integers(0, 20, (7, 2)), (2, 1): rng.integers(0, 20, (5, 2))}
    Ks = {i: np.array([[500.0 + i, 0, 256], [0, 501.0, 240], [0, 0, 1]]) for i in range(3)}
    sizes = {i: (480, 512) for i in range(3)}
    names = {i: f"frame_{i}.png" for i in range(3)}
    for mod, tag in ((jax_colmap_db, "jax"), (port_colmap_db, "port")):
        mod.export_scene_to_database(str(tmp_path / f"{tag}.db"), kpts, matches, Ks, sizes, image_names=names)
    ref, got = _db_rows(str(tmp_path / "jax.db")), _db_rows(str(tmp_path / "port.db"))
    assert got == ref and len(ref["matches"]) == 2 and len(ref["keypoints"]) == 3
    for reader, path in ((port_colmap_db, "jax.db"), (jax_colmap_db, "port.db")):
        db = reader.COLMAPDatabase(str(tmp_path / path))
        assert db.read_images() == {1: "frame_0.png", 2: "frame_1.png", 3: "frame_2.png"}
        np.testing.assert_array_equal(db.read_keypoints(3), kpts[2] + 0.5)
        np.testing.assert_array_equal(db.read_matches(3, 2), matches[(2, 1)])
        db.close()


@pytest.mark.parametrize("ids", [(1, 2), (7, 3), (2**31 - 2, 5)])
def test_colmap_pair_ids_match(ids):
    pid = port_colmap_db.pair_id_from_image_ids(*ids)
    assert pid == jax_colmap_db.pair_id_from_image_ids(*ids)
    assert port_colmap_db.image_ids_from_pair_id(pid) == jax_colmap_db.image_ids_from_pair_id(pid)


def test_template_utils_match(capsys):
    cfg = {"trainer": {"epochs": 3, "milestones": [3, 6]}, "seed": 1, "model": {"fine": {"thr": None}},
           "name": "x"}
    assert port_template.format_config(cfg) == jax_template.format_config(cfg)
    assert port_template.flatten_config(cfg) == jax_template.flatten_config(cfg)
    port_template.print_config(cfg)
    a = capsys.readouterr().out
    jax_template.print_config(cfg)
    assert a == capsys.readouterr().out

    class Writer:
        def __init__(self):
            self.calls = []

        def add_hparams(self, hp, metrics):
            self.calls.append(("hparams", hp))

        def add_text(self, tag, text):
            self.calls.append((tag, text))

    class Refusing(Writer):
        def add_hparams(self, hp, metrics):
            raise TypeError("no hparams")

    for cls in (Writer, Refusing):
        w_port, w_jax = cls(), cls()
        port_template.log_hparams(cfg, w_port)
        jax_template.log_hparams(cfg, w_jax)
        assert w_port.calls == w_jax.calls and w_port.calls
