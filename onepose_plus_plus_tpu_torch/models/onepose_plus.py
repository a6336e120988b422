"""OnePose++ 2D-3D matcher forward, inference and training (port of
``onepose_plus_plus_tpu/models/onepose_plus.py:79-286``; reference
``OnePosePlusModel.py:96-201``):

    backbone -> sine PE -> 3D keypoint encoding -> coarse linear-attention
    transformer (K1 at inference) -> dual-softmax mutual-NN matching into K
    slots (K2) [-> GT padding in training] -> fine 5x5 window gather (K3,
    gradient K4) -> fine transformer -> heatmap soft-argmax.

Off-by-default options, as in the JAX model: ``backbone.quant_int8`` (int8
backbone convs at inference), ``keypoints_encoding.norm_method`` and
``fine.sparse_fpn is True`` (inference only: the 1/2-level FPN convs run on
each match's halo patch, gathered by K6, in place of the dense map and K3).

``model.train()`` is the JAX model's ``train=True``: BatchNorm on batch
statistics, the eager coarse transformer, ``train_max_matches`` slots of
which the last ``train_pad_num_gt_min`` are GT-padded, and, on the fused
route, ``coarse_loss_ctx`` for the fused focal loss (K5) in place of a
confidence matrix. The forward records no autograd graph only where its
caller asks (the inference pipeline runs it under ``torch.no_grad``).

Inputs (dict of tensors on one device):
    query_image          [N, H, W, 1] grayscale in [0, 1]
    keypoints3d          [N, L, 3]
    descriptors3d        [N, L, Cf]  fine descriptors
    descriptors3d_coarse [N, L, C]   optional, used for coarse attention
    query_image_scale    [N, 2] optional (h_scale, w_scale)
    query_image_mask     [N, H/8 * W/8] optional padding mask
Training extras: gt_cell [N, L] (GT coarse cell of each point, -1 = none).
Outputs as the JAX model: i_ids, j_ids, mconf, match_mask, mkpts_query_c,
mkpts_3d, mkpts_query_f, expec_f, plus conf_matrix on the dense matching path
(and log_conf_matrix in training) or coarse_loss_ctx on the fused route in
training.

dtype rules as the JAX model: parameters stay float32; ``compute_dtype``
applies to the backbone, the transformer projections and the fine heatmap
soft-argmax (computed in the fine windows' dtype); LayerNorms and the matching
statistics compute in float32; the coarse K1 layers return float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config import OnePosePlusConfig
from ..ops.cuda_matching import fused_select_topk_matches
from ..ops.matching import (
    dual_softmax_confidence,
    dual_softmax_log_confidence,
    pad_matches_with_gt,
    select_topk_matches,
)
from ..ops.soft_argmax import heatmap_std, spatial_expectation_2d
from ..ops.take import take_rows
from ..ops.window_gather import gather_windows_aligned
from ..utils.dtypes import torch_dtype
from .backbone import ResNetFPN_8_2
from .position_encoding import KeypointEncoder, normalize_3d_keypoints, sine_position_encoding
from .transformer import LocalFeatureTransformer


class OnePosePlusModel(nn.Module):
    def __init__(self, cfg: OnePosePlusConfig = OnePosePlusConfig()):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.compute_dtype)
        self.backbone = ResNetFPN_8_2(cfg.backbone, dtype=self.dtype)
        if cfg.keypoints_encoding.enable:
            ke = cfg.keypoints_encoding
            self.kpt_3d_pos_encoding = KeypointEncoder(ke.layers, ke.descriptor_dim, ke.norm_method)
        self.loftr_coarse = LocalFeatureTransformer(
            dataclasses.replace(cfg.coarse, compute_dtype=cfg.compute_dtype)
        )
        if cfg.fine.enable:
            self.loftr_fine = LocalFeatureTransformer(
                dataclasses.replace(cfg.fine.transformer, compute_dtype=cfg.compute_dtype)
            )

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        gt_pad_rows: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """Match a batch. In train mode the GT slots' rows are drawn from
        ``generator`` (a ``torch.Generator`` on the batch's device), or taken
        from ``gt_pad_rows`` [N, train_pad_num_gt_min] when given."""
        cfg = self.cfg
        cm = cfg.coarse_matching
        train = self.training
        img = batch["query_image"]
        n, h_i, w_i, _ = img.shape

        # 1. backbone; the sparse fine FPN (inference only) defers the
        # 1/2-level convs until the matched cells are known
        sparse_fine = cfg.fine.enable and not train and cfg.fine.sparse_fpn is True
        if sparse_fine:
            feat_c_map, fine_ctx = self.backbone.coarse_and_ctx(img)
            h_f, w_f = fine_ctx[0].shape[2:4]
        else:
            feat_c_map, feat_f_map = self.backbone(img)
            h_f, w_f = feat_f_map.shape[1:3]
        h_c, w_c = feat_c_map.shape[1:3]

        # 2. positional encodings
        if cfg.positional_encoding:
            feat_c_map = sine_position_encoding(feat_c_map, cfg.pe_temp_bug_fix)
        feat_query_c = feat_c_map.reshape(n, h_c * w_c, -1)
        kpts3d = batch["keypoints3d"]
        desc3d_coarse = batch.get("descriptors3d_coarse", batch["descriptors3d"])
        if cfg.keypoints_encoding.enable:
            desc3d_coarse = self.kpt_3d_pos_encoding(normalize_3d_keypoints(kpts3d), desc3d_coarse)
        query_mask = batch.get("query_image_mask")

        # 3. coarse transformer + dual-softmax matching
        desc3d_c, feat_query_c = self.loftr_coarse(desc3d_coarse, feat_query_c, mask1=query_mask)
        k_pred = cm.train_max_matches - cm.train_pad_num_gt_min if train else cm.max_matches
        use_fused = cm.use_fused_kernel is None or cm.use_fused_kernel
        if train and query_mask is not None:
            # the fused focal loss has no masked-column variant
            use_fused = False
        conf = log_conf = None
        if use_fused:
            # selection is index-only: it runs on detached features, and in
            # training the loss differentiates through K5 instead
            matches = fused_select_topk_matches(
                desc3d_c.detach(), feat_query_c.detach(), cm.temperature, (h_c, w_c), cm.thr,
                cm.border_rm, k_pred, border_two_sided=cm.border_two_sided,
                feat_norm=cm.feat_norm_method, col_mask=query_mask, dtype=self.dtype,
            )
        else:
            if train:
                conf, log_conf = dual_softmax_log_confidence(
                    desc3d_c, feat_query_c, cm.temperature, mask1=query_mask,
                    feat_norm=cm.feat_norm_method,
                )
            else:
                conf = dual_softmax_confidence(
                    desc3d_c, feat_query_c, cm.temperature, mask1=query_mask,
                    feat_norm=cm.feat_norm_method,
                )
            matches = select_topk_matches(
                conf.detach(), (h_c, w_c), cm.thr, cm.border_rm, k_pred,
                border_two_sided=cm.border_two_sided,
            )
        if train:
            matches = pad_matches_with_gt(matches, batch["gt_cell"], cm.train_pad_num_gt_min,
                                          generator=generator, rows=gt_pad_rows)

        # coarse pixel coordinates (original resolution via query_image_scale)
        j = matches.j_ids.long()
        mkpts_query_c = torch.stack([(j % w_c).float(), (j // w_c).float()], dim=-1) * (h_i / h_c)
        if "query_image_scale" in batch:
            # scale (h, w) -> multiply (x, y) by (w_scale, h_scale)
            mkpts_query_c = mkpts_query_c * batch["query_image_scale"][:, None].flip(-1)
        out: Dict[str, Any] = {
            "i_ids": matches.i_ids,
            "j_ids": matches.j_ids,
            "mconf": matches.mconf,
            "match_mask": matches.mask,
            "mkpts_query_c": mkpts_query_c,
            "mkpts_3d": take_rows(kpts3d, matches.i_ids),
            "hw_c": (h_c, w_c),
            "hw_f": (h_f, w_f),
            "hw_i": (h_i, w_i),
        }
        if conf is not None:
            out["conf_matrix"] = conf
            if log_conf is not None:
                out["log_conf_matrix"] = log_conf
        elif train:
            # the fused focal loss (K5) consumes the coarse features directly
            out["coarse_loss_ctx"] = {
                "feats": (desc3d_c, feat_query_c),
                "temperature": cm.temperature,
                "feat_norm": cm.feat_norm_method,
            }
        if not cfg.fine.enable:
            out["mkpts_query_f"] = mkpts_query_c
            return out

        # 4. fine-level refinement: windows of the dense map (K3), or the sparse
        # FPN's convs on halo patches (K6)
        w_win = cfg.fine.window_size
        if sparse_fine:
            windows = self.backbone.fine_windows(fine_ctx, matches.j_ids, (h_c, w_c), h_f // h_c, w_win)
        else:
            windows = gather_windows_aligned(
                feat_f_map, matches.j_ids, (h_c, w_c), h_f // h_c, w_win
            )  # [N, K, W*W, Cf]
        desc3d_fine = batch["descriptors3d"]
        c_f = windows.shape[-1]
        if desc3d_fine.shape[-1] != c_f:
            raise ValueError(
                f"fine descriptors3d must match fine feature dim ({desc3d_fine.shape[-1]} vs {c_f})"
            )
        k = matches.i_ids.shape[1]
        d0 = take_rows(desc3d_fine, matches.i_ids).to(windows.dtype).reshape(n * k, 1, c_f)
        d1 = windows.reshape(n * k, w_win * w_win, c_f)
        d0, d1 = self.loftr_fine(d0, d1)

        # 5. correlation heatmap soft-argmax, in the windows' (compute) dtype
        sim = torch.einsum("mc,mrc->mr", d0[:, 0, :], d1) / (c_f ** 0.5)
        heat = torch.softmax(sim, dim=-1)
        coords = spatial_expectation_2d(heat, w_win)  # [N*K, 2] in [-1, 1]
        std = heatmap_std(heat, coords, w_win).reshape(n, k)
        coords = coords.reshape(n, k, 2)
        offset = coords * (w_win // 2) * (h_i / h_f)
        if "query_image_scale" in batch:
            offset = offset * batch["query_image_scale"][:, None].flip(-1)
        out["expec_f"] = torch.cat([coords, std[..., None]], dim=-1)
        out["mkpts_query_f"] = mkpts_query_c + offset
        return out
