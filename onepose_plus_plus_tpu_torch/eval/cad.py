"""CAD model utilities: PLY loading, vertex sampling, object diameter.

The port's own copy of ``onepose_plus_plus_tpu/eval/cad.py`` (numpy only).

Behavioral port of reference ``src/utils/sample_points_on_cad.py:6-88``
(``load_points_from_cad``, ``model_diameter_from_bbox``) without the
open3d/plyfile dependencies — a minimal PLY reader (ascii +
binary_little_endian) covers the LINEMOD model files.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


def load_ply_vertices(path: str) -> np.ndarray:
    """Read vertex positions [N, 3] from an ascii or binary-LE PLY file."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_vertex = 0
        props: list = []
        in_vertex = False
        for line in header:
            if line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n_vertex = int(cnt)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] == "list":
                    continue
                props.append((parts[2], parts[1]))

        type_map = {
            "float": ("f", 4), "float32": ("f", 4),
            "double": ("d", 8), "float64": ("d", 8),
            "uchar": ("B", 1), "uint8": ("B", 1),
            "char": ("b", 1), "int8": ("b", 1),
            "short": ("h", 2), "ushort": ("H", 2),
            "int": ("i", 4), "int32": ("i", 4),
            "uint": ("I", 4), "uint32": ("I", 4),
        }
        xyz_idx = [i for i, (name, _) in enumerate(props) if name in ("x", "y", "z")]
        if fmt == "ascii":
            out = np.zeros((n_vertex, 3))
            for i in range(n_vertex):
                vals = f.readline().split()
                out[i] = [float(vals[j]) for j in xyz_idx[:3]]
            return out
        # binary little endian
        fmt_str = "<" + "".join(type_map[t][0] for _, t in props)
        size = struct.calcsize(fmt_str)
        out = np.zeros((n_vertex, 3))
        for i in range(n_vertex):
            vals = struct.unpack(fmt_str, f.read(size))
            out[i] = [vals[j] for j in xyz_idx[:3]]
        return out


def sample_points_on_cad(
    vertices: np.ndarray, n_points: int = 1000, seed: int = 0
) -> np.ndarray:
    """Random vertex subsample (reference samples model points for ADD)."""
    if len(vertices) <= n_points:
        return vertices
    idx = np.random.default_rng(seed).choice(len(vertices), n_points, replace=False)
    return vertices[idx]


def model_diameter_from_vertices(vertices: np.ndarray) -> float:
    """Bbox-diagonal diameter (reference ``model_diameter_from_bbox``)."""
    lo, hi = vertices.min(axis=0), vertices.max(axis=0)
    return float(np.linalg.norm(hi - lo))


def load_cad_for_eval(
    path: str, n_points: int = 1000, unit_scale: float = 1.0
) -> Tuple[np.ndarray, float]:
    """(sampled model points [n, 3], diameter) ready for ADD evaluation."""
    v = load_ply_vertices(path) * unit_scale
    return sample_points_on_cad(v, n_points), model_diameter_from_vertices(v)
