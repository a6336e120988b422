"""COLMAP sqlite database IO (interop with COLMAP/hloc tooling): a copy of
``onepose_plus_plus_tpu/data/colmap_database.py``, which the port may not import.

Fresh implementation of the public COLMAP database schema (the reference
vendors ``src/utils/colmap/database.py``; the sqlite file is how keypoints
and matches were shipped to the COLMAP C++ binaries,
``src/sfm_utils/triangulation.py:38-141``). The pipeline itself never
needs this file — tracks flow through numpy — but exporting one lets users
run any COLMAP-ecosystem tool on this framework's outputs.
"""
from __future__ import annotations

import sqlite3
from typing import Dict, Optional, Tuple

import numpy as np

MAX_IMAGE_ID = 2**31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB,
    qvec BLOB, tvec BLOB);
"""


def pair_id_from_image_ids(image_id1: int, image_id2: int) -> int:
    """COLMAP's canonical pair id (smaller id first)."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def image_ids_from_pair_id(pair_id: int) -> Tuple[int, int]:
    return pair_id // MAX_IMAGE_ID, pair_id % MAX_IMAGE_ID


class COLMAPDatabase:
    """Thin sqlite wrapper writing/reading the COLMAP schema."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)

    # ------------------------------ write -------------------------------

    def add_camera(
        self,
        model_id: int,
        width: int,
        height: int,
        params: np.ndarray,
        camera_id: Optional[int] = None,
        prior_focal: bool = False,
    ) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (
                camera_id,
                int(model_id),
                int(width),
                int(height),
                np.asarray(params, np.float64).tobytes(),
                int(prior_focal),
            ),
        )
        return cur.lastrowid

    def add_image(
        self,
        name: str,
        camera_id: int,
        qvec: Optional[np.ndarray] = None,
        tvec: Optional[np.ndarray] = None,
        image_id: Optional[int] = None,
    ) -> int:
        q = qvec if qvec is not None else (None,) * 4
        t = tvec if tvec is not None else (None,) * 3
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *[None if v is None else float(v) for v in q],
             *[None if v is None else float(v) for v in t]),
        )
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray) -> None:
        """[N, 2|4|6] float32 keypoints (COLMAP convention: +0.5 px origin
        handled by the caller, reference ``import_features`` adds 0.5)."""
        kp = np.asarray(keypoints, np.float32)
        self.conn.execute(
            "INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, kp.shape[0], kp.shape[1], kp.tobytes()),
        )

    def add_descriptors(self, image_id: int, descriptors: np.ndarray) -> None:
        d = np.asarray(descriptors, np.uint8)
        self.conn.execute(
            "INSERT OR REPLACE INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id, d.shape[0], d.shape[1], d.tobytes()),
        )

    def add_matches(
        self, image_id1: int, image_id2: int, matches: np.ndarray
    ) -> None:
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()
        self.conn.execute(
            "INSERT OR REPLACE INTO matches VALUES (?, ?, ?, ?)",
            (
                pair_id_from_image_ids(image_id1, image_id2),
                m.shape[0],
                m.shape[1],
                m.tobytes(),
            ),
        )

    def add_two_view_geometry(
        self,
        image_id1: int,
        image_id2: int,
        matches: np.ndarray,
        F: Optional[np.ndarray] = None,
        E: Optional[np.ndarray] = None,
        config: int = 2,
    ) -> None:
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()
        blob = lambda a: (
            np.asarray(a, np.float64).tobytes() if a is not None else None
        )
        self.conn.execute(
            "INSERT OR REPLACE INTO two_view_geometries VALUES "
            "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (
                pair_id_from_image_ids(image_id1, image_id2),
                m.shape[0],
                m.shape[1],
                m.tobytes(),
                config,
                blob(F if F is not None else np.eye(3)),
                blob(E if E is not None else np.eye(3)),
                blob(np.eye(3)),
                None,
                None,
            ),
        )

    # ------------------------------- read -------------------------------

    def read_keypoints(self, image_id: int) -> Optional[np.ndarray]:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?",
            (image_id,),
        ).fetchone()
        if row is None:
            return None
        r, c, data = row
        return np.frombuffer(data, np.float32).reshape(r, c).copy()

    def read_matches(self, image_id1: int, image_id2: int) -> Optional[np.ndarray]:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?",
            (pair_id_from_image_ids(image_id1, image_id2),),
        ).fetchone()
        if row is None:
            return None
        r, c, data = row
        m = np.frombuffer(data, np.uint32).reshape(r, c).copy()
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()
        return m

    def read_images(self) -> Dict[int, str]:
        return {
            i: n
            for i, n in self.conn.execute("SELECT image_id, name FROM images")
        }

    def commit(self) -> None:
        self.conn.commit()

    def close(self) -> None:
        self.conn.commit()
        self.conn.close()


def export_scene_to_database(
    path: str,
    keypoints: Dict[int, np.ndarray],
    match_indices: Dict[Tuple[int, int], np.ndarray],
    Ks: Dict[int, np.ndarray],
    image_sizes: Dict[int, Tuple[int, int]],
    image_names: Optional[Dict[int, str]] = None,
) -> None:
    """Dump a matched scene into a COLMAP-compatible database file.

    Keypoints get COLMAP's +0.5 pixel-center offset (reference
    ``triangulation.py:62-104`` import_features/import_matches behavior).
    """
    db = COLMAPDatabase(path)
    id_map = {}
    for img_id in sorted(keypoints):
        K = Ks[img_id]
        h, w = image_sizes[img_id]
        cam = db.add_camera(
            1, w, h, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]
        )  # PINHOLE
        name = image_names[img_id] if image_names else f"{img_id:06d}.png"
        db_id = db.add_image(name, cam)
        id_map[img_id] = db_id
        db.add_keypoints(db_id, keypoints[img_id] + 0.5)
    for (i, j), m in match_indices.items():
        db.add_matches(id_map[i], id_map[j], m)
        db.add_two_view_geometry(id_map[i], id_map[j], m)
    db.close()
