"""The port's HDF5 writer and reader (``data/image_io.py``: struct and numpy,
no h5py) against h5py and against the JAX package's h5py-backed functions.

The port writes the subset of the HDF5 format that h5py writes by default
(superblock 0, symbol-table groups, version-1 object headers, contiguous
datasets). h5py must read its files equal to the dicts written, the port must
read the JAX package's files of the same dicts equal, and both directions
must hold at the SfM's sizes (one group a pair: a few thousand members, which
takes a B-tree of two levels). With h5py blocked the port still writes and
reads.
"""
import sys
import types

import numpy as np
import pytest

from onepose_plus_plus_tpu_torch.data import image_io as io
from onepose_plus_plus_tpu_torch.sfm import runner


def _flat():
    rng = np.random.default_rng(0)
    return {"keypoints": rng.random((7, 2)).astype(np.float32), "matches": np.arange(12, dtype=np.int64).reshape(6, 2),
            "empty": np.zeros((0, 2), np.float32), "none": np.zeros(0, np.int64), "scalar": np.float32(2.5),
            "half": np.ones((2, 3), np.float16), "f64": rng.random(4), "u8": np.arange(5, dtype=np.uint8),
            "i8": -np.arange(5, dtype=np.int8), "u64": np.arange(3, dtype=np.uint64), "i16": np.arange(4, dtype=np.int16),
            "big": rng.random((256, 300)).astype(np.float32), "a/b/c": np.arange(3, dtype=np.int64)}


def _grouped(n: int = 2000):
    """One group a member, as the matches export has one a pair: a few keys
    each, some empty, a "/" in a key (nested groups below the member)."""
    rng = np.random.default_rng(1)
    out = {f"{i:04d}.png_{i + 1:04d}.png": {"matches": rng.integers(0, 99, (i % 5, 2)),
                                            "matching_scores": rng.random(i % 5).astype(np.float32)}
           for i in range(n)}
    out["0000.png_0001.png"]["nested/key"] = np.arange(4, dtype=np.int64)
    out["no_datasets"] = {}
    return out


def _equal(a, b):
    assert set(a) == set(b), (sorted(set(a) ^ set(b)))[:5]
    for k in a:
        if isinstance(a[k], dict):
            _equal(a[k], b[k])
        else:
            want = np.asarray(b[k])
            assert a[k].dtype == want.dtype and a[k].shape == want.shape and np.array_equal(a[k], want), k


def _h5py_flat(path):
    h5py = pytest.importorskip("h5py")
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()]) if isinstance(obj, h5py.Dataset) else None)
    return out


def _h5py_grouped(path):
    h5py = pytest.importorskip("h5py")
    with h5py.File(path, "r") as f:
        return {g: {k: v[()] for k, v in _walk(f[g])} for g in f.keys()}


def _walk(group, prefix=""):
    for k, v in group.items():
        if hasattr(v, "keys"):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_flat_round_trip(tmp_path):
    data = _flat()
    io.save_h5(data, str(tmp_path / "flat.h5"))
    _equal(io.load_h5(str(tmp_path / "flat.h5")), data)


@pytest.mark.parametrize("n", [0, 1, 8, 9, 256, 257, 2000])
def test_grouped_round_trip(tmp_path, n):
    """Groups of 0 to 2000 members: one symbol table node (8 entries), one
    B-tree node (32 nodes, 256 entries), and above that a second level."""
    data = _grouped(n) if n else {"no_datasets": {}}
    io.grouped_save_h5(data, str(tmp_path / "g.h5"))
    _equal(io.grouped_load_h5(str(tmp_path / "g.h5")), data)


def test_h5py_reads_the_ports_files(tmp_path):
    flat, grouped = _flat(), _grouped()
    io.save_h5(flat, str(tmp_path / "flat.h5"))
    io.grouped_save_h5(grouped, str(tmp_path / "g.h5"))
    _equal(_h5py_flat(str(tmp_path / "flat.h5")), flat)
    _equal(_h5py_grouped(str(tmp_path / "g.h5")), grouped)


def test_h5py_can_modify_the_ports_files(tmp_path):
    """HDF5's own B-tree code inserts into and removes from the port's
    two-level group tree (it splits nodes by the file's K values)."""
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "g.h5")
    grouped = _grouped()
    io.grouped_save_h5(grouped, path)
    with h5py.File(path, "r+") as f:
        f.create_dataset("0007.png_0008.png/added", data=np.arange(3))
        f.create_group("0500.5").create_dataset("x", data=np.ones(2, np.float32))
        del f["0001.png_0002.png"]
    grouped["0007.png_0008.png"]["added"] = np.arange(3)
    grouped["0500.5"] = {"x": np.ones(2, np.float32)}
    del grouped["0001.png_0002.png"]
    _equal(io.grouped_load_h5(path), grouped)


def test_the_port_reads_the_jax_packages_files(tmp_path):
    pytest.importorskip("h5py")
    from onepose_plus_plus_tpu.data import image_io as jax_io

    flat, grouped = _flat(), _grouped()
    jax_io.save_h5(flat, str(tmp_path / "flat.h5"))
    jax_io.grouped_save_h5(grouped, str(tmp_path / "g.h5"))
    _equal(io.load_h5(str(tmp_path / "flat.h5")), flat)
    _equal(io.grouped_load_h5(str(tmp_path / "g.h5")), grouped)
    # and the JAX package's reader reads the port's files
    io.save_h5(flat, str(tmp_path / "port_flat.h5"))
    _equal(jax_io.load_h5(str(tmp_path / "port_flat.h5")), flat)


def _scene(n_images: int = 20, n_kpts: int = 3000, seed: int = 2):
    """A merged scene as ``export_hloc_artifacts`` takes it, at the SfM's
    sizes: 20 images, 100 pairs of a few hundred matches."""
    rng = np.random.default_rng(seed)
    kp = {i: rng.uniform(0, 512, (n_kpts, 2)) for i in range(n_images)}
    pairs = [(i, j) for i in range(n_images) for j in range(i + 1, min(i + 6, n_images))]
    idx = {p: rng.integers(0, n_kpts, (int(rng.integers(0, 600)), 2)) for p in pairs}
    return types.SimpleNamespace(keypoints=kp, scores={i: rng.random(n_kpts) for i in kp}, match_indices=idx,
                                 match_confs={p: rng.random(len(m)) for p, m in idx.items()})


def test_sfm_exports_read_back_equal(tmp_path):
    """``export_hloc_artifacts`` keeps its file names and keys; h5py and the
    port read both files equal to the arrays written."""
    scene = _scene()
    names = {i: f"{i:04d}.png" for i in scene.keypoints}
    runner.export_hloc_artifacts(scene, names, str(tmp_path))
    feats = {names[i]: {"keypoints": k.astype(np.float32), "descriptors": np.zeros((256, len(k)), np.float32),
                        "scores": scene.scores[i].astype(np.float32)} for i, k in scene.keypoints.items()}
    matches = {f"{names[i]}_{names[j]}": {"matches": m.astype(np.int64),
                                          "matching_scores": scene.match_confs[(i, j)].astype(np.float32)}
               for (i, j), m in scene.match_indices.items()}
    for name, want in (("feats-loftr.h5", feats), ("matches-loftr.h5", matches)):
        _equal(io.grouped_load_h5(str(tmp_path / name)), want)
        _equal(_h5py_grouped(str(tmp_path / name)), want)


def test_without_h5py(tmp_path, monkeypatch):
    """The card's machine has no h5py: writing and reading never import it."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    flat, grouped = _flat(), _grouped(300)
    io.save_h5(flat, str(tmp_path / "flat.h5"))
    io.grouped_save_h5(grouped, str(tmp_path / "g.h5"))
    _equal(io.load_h5(str(tmp_path / "flat.h5")), flat)
    _equal(io.grouped_load_h5(str(tmp_path / "g.h5")), grouped)


@pytest.mark.parametrize("bad", [np.array([True, False]), np.array(["a"]), np.zeros(2, np.complex64),
                                 np.array([1, 2], object)])
def test_other_dtypes_raise(tmp_path, bad):
    with pytest.raises(TypeError, match="HDF5 export takes"):
        io.save_h5({"x": bad}, str(tmp_path / "bad.h5"))


def test_a_name_that_is_both_a_group_and_a_dataset_raises(tmp_path):
    with pytest.raises(ValueError):
        io.save_h5({"a": np.zeros(1), "a/b": np.zeros(1)}, str(tmp_path / "bad.h5"))
