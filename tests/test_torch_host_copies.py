"""The port's own copies of the JAX package's host modules, held to the originals.

The port imports nothing of the JAX package, so it keeps copies of the host
code it needs: ``config.py``, ``data/`` (preprocessing, image_io, homography,
dataset, augment, colmap_model), ``utils/config_loader.py`` and
``eval.metrics.aggregate_metrics``. Each copy must behave as its original on
the same inputs: exactly, since both are the same numpy code.
"""
import dataclasses
import inspect
import os
from pathlib import Path

import numpy as np
import pytest

from onepose_plus_plus_tpu import config as jax_config
from onepose_plus_plus_tpu.data import augment as jax_augment
from onepose_plus_plus_tpu.data import colmap_model as jax_colmap
from onepose_plus_plus_tpu.data import dataset as jax_dataset
from onepose_plus_plus_tpu.data import preprocessing as jax_pre
from onepose_plus_plus_tpu.eval.metrics import aggregate_metrics as jax_aggregate
from onepose_plus_plus_tpu.utils.config_loader import load_config as jax_load_config
from onepose_plus_plus_tpu_torch import config as port_config
from onepose_plus_plus_tpu_torch.data import augment as port_augment
from onepose_plus_plus_tpu_torch.data import colmap_model as port_colmap
from onepose_plus_plus_tpu_torch.data import dataset as port_dataset
from onepose_plus_plus_tpu_torch.data import preprocessing as port_pre
from onepose_plus_plus_tpu_torch.eval.metrics import aggregate_metrics
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
