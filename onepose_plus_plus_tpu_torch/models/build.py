"""Model configuration from the reference's YAML keys.

Port of ``onepose_plus_plus_tpu/models/build.py::onepose_config_from_dict``,
whose module loads JAX: the same mapping of ``train.yaml``'s ``model`` block
(reference ``train.yaml:44-127`` key names) onto the shared dataclasses of
``config.py``. A test holds both to equal configs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..config import (
    CoarseMatchingConfig,
    FineConfig,
    KeypointEncodingConfig,
    OnePosePlusConfig,
    ResNetFPNConfig,
    TransformerConfig,
)


def onepose_config_from_dict(d: Optional[Dict[str, Any]] = None) -> OnePosePlusConfig:
    """Build the 2D-3D matcher config from a (partial) YAML dict using the
    reference's key names (loftr_backbone / loftr_coarse / loftr_match_coarse
    / loftr_fine, ``train.yaml:44-127``)."""
    d = d or {}
    bb = d.get("loftr_backbone", {})
    co = d.get("loftr_coarse", {})
    cm = d.get("match_coarse", d.get("loftr_match_coarse", {}))
    fi = d.get("loftr_fine", {})
    kp = d.get("keypoints_encoding", {})
    resolution = tuple(bb.get("resolution", (8, 2)))
    return OnePosePlusConfig(
        compute_dtype=d.get("compute_dtype", "float32"),
        backbone=ResNetFPNConfig(
            initial_dim=bb.get("initial_dim", 128),
            block_dims=tuple(bb.get("block_dims", (128, 196, 256))),
            quant_int8=bb.get("quant_int8", False),
            stem_s2d=bb.get("stem_s2d", True),
        ),
        resolution=resolution,
        pe_temp_bug_fix=co.get("temp_bug_fix", False),
        keypoints_encoding=KeypointEncodingConfig(
            enable=kp.get("enable", True),
            descriptor_dim=kp.get("descriptor_dim", 256),
            layers=tuple(kp.get("keypoints_encoder", (32, 64, 128))),
            norm_method=kp.get("norm_method", "instancenorm"),
        ),
        coarse=TransformerConfig(
            d_model=co.get("d_model", 256),
            nhead=co.get("nhead", 8),
            layer_names=tuple(co.get("layer_names", ("self", "cross"))),
            layer_iter_n=co.get("layer_iter_n", 3),
            attention=co.get("attention", "linear"),
        ),
        coarse_matching=CoarseMatchingConfig(
            thr=cm.get("thr", 0.1),
            border_rm=cm.get("border_rm", 2),
            temperature=cm.get("dsmax_temperature", 0.08),
            max_matches=cm.get("max_matches", 512),
            train_max_matches=cm.get("train_max_matches", 1228),
            train_pad_num_gt_min=cm.get("train_pad_num_gt_min", 200),
        ),
        fine=FineConfig(
            enable=fi.get("enable", True),
            window_size=fi.get("window_size", 5),
            d_model=fi.get("d_model", 128),
            sparse_fpn=fi.get("sparse_fpn", None),
            transformer=TransformerConfig(
                d_model=fi.get("d_model", 128),
                nhead=fi.get("nhead", 8),
                layer_names=tuple(fi.get("layer_names", ("self", "cross"))),
                layer_iter_n=fi.get("layer_iter_n", 1),
                attention=fi.get("attention", "linear"),
            ),
        ),
    )
