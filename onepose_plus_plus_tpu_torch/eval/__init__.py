"""Evaluation: pose metrics, CAD models, trajectories (the port's copies of
the JAX package's numpy functions, plus the batched device pose errors)."""
from .metrics import (
    query_pose_error,
    add_metric,
    projection_2d_error,
    model_diameter_from_bbox,
    aggregate_metrics,
    batched_pose_errors,
    SYMMETRIC_OBJ_IDS,
)
from .cad import (
    load_ply_vertices,
    sample_points_on_cad,
    model_diameter_from_vertices,
    load_cad_for_eval,
)
from .trajectory import (
    umeyama_alignment,
    absolute_trajectory_error,
    camera_centers_from_poses,
)
