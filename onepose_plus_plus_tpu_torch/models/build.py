"""Model construction from the reference's YAML keys, and the SfM surfaces.

Port of ``onepose_plus_plus_tpu/models/build.py``: the mapping of
``train.yaml``'s ``model`` block (reference ``train.yaml:44-127`` key names)
and of the SfM configs' ``model`` block onto the dataclasses of
``config.py`` (tests hold both packages to equal configs), the builders of
the 2D-3D matcher and of LoFTR (both on ``cuda`` unless asked otherwise),
and :func:`make_loftr_fns`, the three batched surfaces the SfM runner and the
detector call. They take host numpy arrays and return CPU tensors, which
``np.asarray`` reads.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import (
    CoarseMatchingConfig,
    FineConfig,
    KeypointEncodingConfig,
    LoFTRConfig,
    OnePosePlusConfig,
    ResNetFPNConfig,
    TransformerConfig,
)
from .loftr import LoFTRMatcher
from .onepose_plus import OnePosePlusModel


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


def loftr_config_from_dict(d: Optional[Dict[str, Any]] = None) -> LoFTRConfig:
    """Image-pair LoFTR config (reference loftr_for_onepose_plus_cfg.py)."""
    d = d or {}
    cm = d.get("match_coarse", {})
    return LoFTRConfig(
        compute_dtype=d.get("compute_dtype", "float32"),
        backbone=ResNetFPNConfig(
            quant_int8=d.get("backbone", {}).get("quant_int8", False),
            stem_s2d=d.get("backbone", {}).get("stem_s2d", True),
        ),
        coarse=TransformerConfig(
            d_model=d.get("d_model", 256),
            nhead=d.get("nhead", 8),
            layer_iter_n=d.get("layer_iter_n", 4),
        ),
        coarse_matching=CoarseMatchingConfig(
            thr=cm.get("thr", 0.2),
            temperature=cm.get("dsmax_temperature", 0.1),
            border_rm=cm.get("border_rm", 2),
            border_two_sided=True,
            max_matches=cm.get("max_matches", 1024),
        ),
        fine_window_size=d.get("fine_window_size", 9),
    )


def build_onepose_model(cfg_dict: Optional[Dict[str, Any]] = None,
                        device: str = "cuda") -> OnePosePlusModel:
    """The 2D-3D matcher in eval mode on ``device`` (weights are torch's
    initialisation: load a checkpoint with ``utils.checkpoint.load_weights``,
    or ``utils.weights.random_state_dict``)."""
    return OnePosePlusModel(onepose_config_from_dict(cfg_dict)).eval().to(device)


def build_loftr_matcher(cfg_dict: Optional[Dict[str, Any]] = None,
                        device: str = "cuda") -> LoFTRMatcher:
    """The LoFTR pair matcher in eval mode on ``device`` (weights are torch's
    initialisation: load a state dict, or ``utils.weights.random_state_dict``)."""
    return LoFTRMatcher(loftr_config_from_dict(cfg_dict)).eval().to(device)


def _to_host(out: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v.cpu() if torch.is_tensor(v) else v for k, v in out.items()}


def make_loftr_fns(model: LoFTRMatcher) -> Tuple[Callable, Callable, Callable]:
    """(coarse_match_fn, refine_fn, extract_fn) for the SfM runner.

    All three take numpy arrays, run on the model's device under
    ``torch.inference_mode`` and return CPU tensors:
      coarse_match_fn(img0, img1) -> match_coarse dict
      refine_fn(img0, img1, mkpts0, mkpts1, mask) -> refine dict (+features)
      extract_fn(img, kpts, mask) -> {"feat_fine", "feat_coarse"} at kpts
    """
    device = next(model.parameters()).device

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    @torch.inference_mode()
    def coarse_match_fn(img0, img1):
        return _to_host(model.match_coarse(dev(img0), dev(img1)))

    @torch.inference_mode()
    def refine_fn(img0, img1, mkpts0, mkpts1, mask):
        return _to_host(model.refine(dev(img0), dev(img1), dev(mkpts0), dev(mkpts1), dev(mask),
                                     extract_features=True))

    @torch.inference_mode()
    def extract_fn(img, kpts, mask):
        # a self-pair refine call reuses the feature-sampling path
        img, kpts = dev(img), dev(kpts)
        out = model.refine(img, img, kpts, kpts, dev(mask), extract_features=True)
        return {"feat_fine": out["feat_fine_0"].cpu(), "feat_coarse": out["feat_coarse_0"].cpu()}

    return coarse_match_fn, refine_fn, extract_fn
