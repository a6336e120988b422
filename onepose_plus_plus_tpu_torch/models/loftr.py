"""Detector-free image-pair matcher (port of ``onepose_plus_plus_tpu/models/loftr.py``).

The full LoFTR of the keypoint-free SfM (reference
``src/KeypointFreeSfM/loftr_for_sfm/loftr.py:16-167``; d_model 256/128, nhead
8, 4x self/cross coarse layers and one fine pair, linear attention,
dual-softmax T 0.1, thr 0.2, fine window 9) with its three modes:

- ``match``: coarse + fine matching of an image pair (fine windows at
  stride * cell through K3);
- ``match_coarse``: coarse only (the SfM coarse matching pass);
- ``refine``: fine refinement of given coarse matches (the post-optimisation
  pass), fine windows at arbitrary pixels through K6, optionally with the
  coarse transformer's and the fine map's features sampled at the matches
  (descriptor extraction).

The coarse transformer runs its 8 layer applications per stream through K1
(4096 tokens per stream at 512^2), and matching selects with K2 (both borders
removed on both grids, ``border_two_sided`` with ``row_grid_hw``). All outputs
use K static match slots with validity masks. Images are [N, H, W, 1] floats.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn

from ..config import LoFTRConfig
from ..ops.cuda_matching import fused_select_topk_matches
from ..ops.matching import dual_softmax_confidence, select_topk_matches
from ..ops.soft_argmax import heatmap_std, spatial_expectation_2d
from ..ops.window_gather import gather_windows, gather_windows_aligned
from ..utils.dtypes import torch_dtype
from .backbone import ResNetFPN_8_2
from .position_encoding import sine_position_encoding
from .transformer import LocalFeatureTransformer


def bilinear_sample(feat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample [N, H, W, C] maps at [N, K, 2] (x, y) positions (bilinear,
    positions clamped into the map) -> [N, K, C] float32 (the JAX version's
    type promotion of a bf16 map against f32 weights)."""
    n, h, w, c = feat.shape
    x = xy[..., 0].clamp(0.0, w - 1.0)
    y = xy[..., 1].clamp(0.0, h - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    wx = (x - x0).float()[..., None]
    wy = (y - y0).float()[..., None]
    flat = feat.reshape(n, h * w, c)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx)[..., None].expand(-1, -1, c)).float()

    return (at(y0, x0) * (1 - wx) * (1 - wy) + at(y0, x1) * wx * (1 - wy)
            + at(y1, x0) * (1 - wx) * wy + at(y1, x1) * wx * wy)


class LoFTRMatcher(nn.Module):
    def __init__(self, cfg: LoFTRConfig = LoFTRConfig()):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.compute_dtype)
        self.backbone = ResNetFPN_8_2(cfg.backbone, dtype=self.dtype)
        self.loftr_coarse = LocalFeatureTransformer(
            dataclasses.replace(cfg.coarse, compute_dtype=cfg.compute_dtype))
        self.loftr_fine = LocalFeatureTransformer(
            dataclasses.replace(cfg.fine, compute_dtype=cfg.compute_dtype))

    # ------------------------------------------------------------ blocks

    def _coarse_features(self, img0: torch.Tensor, img1: torch.Tensor):
        """Shared backbone over both images, sine PE, coarse transformer."""
        n = img0.shape[0]
        feat_c, feat_f = self.backbone(torch.cat([img0, img1], dim=0))
        c0_map, c1_map = feat_c[:n], feat_c[n:]
        _, h0c, w0c, c = c0_map.shape
        h1c, w1c = c1_map.shape[1:3]
        feat0 = sine_position_encoding(c0_map, self.cfg.pe_temp_bug_fix).reshape(n, h0c * w0c, c)
        feat1 = sine_position_encoding(c1_map, self.cfg.pe_temp_bug_fix).reshape(n, h1c * w1c, c)
        feat0, feat1 = self.loftr_coarse(feat0, feat1)
        return feat0, feat1, (h0c, w0c), (h1c, w1c), feat_f[:n], feat_f[n:]

    def _coarse_match(self, feat0, feat1, hw0_c, hw1_c):
        cm = self.cfg.coarse_matching
        if cm.use_fused_kernel is None or cm.use_fused_kernel:
            return fused_select_topk_matches(
                feat0, feat1, cm.temperature, hw1_c, cm.thr, cm.border_rm, cm.max_matches,
                border_two_sided=cm.border_two_sided, row_grid_hw=hw0_c,
                feat_norm=cm.feat_norm_method, dtype=self.dtype,
            )
        conf = dual_softmax_confidence(feat0, feat1, cm.temperature, feat_norm=cm.feat_norm_method)
        return select_topk_matches(conf, hw1_c, cm.thr, cm.border_rm, cm.max_matches,
                                   border_two_sided=cm.border_two_sided, row_grid_hw=hw0_c)

    def _fine_refine_windows(self, win0: torch.Tensor, win1: torch.Tensor):
        """Fine transformer + correlation soft-argmax over gathered windows ->
        (coords [N, K, 2] in [-1, 1], std [N, K]), in the windows' dtype."""
        w_win = self.cfg.fine_window_size
        n, k, _, c_f = win0.shape
        d0 = win0.reshape(n * k, w_win * w_win, c_f)
        d1 = win1.reshape(n * k, w_win * w_win, c_f)
        d0, d1 = self.loftr_fine(d0, d1)
        center = d0[:, (w_win * w_win) // 2, :]
        sim = torch.einsum("mc,mrc->mr", center, d1) / (c_f ** 0.5)
        heat = torch.softmax(sim, dim=-1)
        coords = spatial_expectation_2d(heat, w_win)
        std = heatmap_std(heat, coords, w_win)
        return coords.reshape(n, k, 2), std.reshape(n, k)

    @staticmethod
    def _cell_xy(ids: torch.Tensor, w_c: int, scale: float) -> torch.Tensor:
        ids = ids.long()
        return torch.stack([ids % w_c, ids // w_c], dim=-1).float() * scale

    # ------------------------------------------------------------- modes

    def match_coarse(self, img0: torch.Tensor, img1: torch.Tensor) -> Dict[str, Any]:
        """Coarse-only matching (the reference's SfM coarse pass, fine off)."""
        feat0, feat1, hw0_c, hw1_c, _, _ = self._coarse_features(img0, img1)
        m = self._coarse_match(feat0, feat1, hw0_c, hw1_c)
        return {
            "mkpts0_c": self._cell_xy(m.i_ids, hw0_c[1], 8.0),
            "mkpts1_c": self._cell_xy(m.j_ids, hw1_c[1], 8.0),
            "mconf": m.mconf,
            "match_mask": m.mask,
            "i_ids": m.i_ids,
            "j_ids": m.j_ids,
            "hw0_c": hw0_c,
            "hw1_c": hw1_c,
        }

    def match(self, img0: torch.Tensor, img1: torch.Tensor) -> Dict[str, Any]:
        """Full coarse + fine matching."""
        feat0, feat1, hw0_c, hw1_c, f0_map, f1_map = self._coarse_features(img0, img1)
        m = self._coarse_match(feat0, feat1, hw0_c, hw1_c)
        h_i, h_f = img0.shape[1], f0_map.shape[1]
        stride = h_f // hw0_c[0]
        scale_c, scale_f = h_i / hw0_c[0], h_i / h_f
        w = self.cfg.fine_window_size
        win0 = gather_windows_aligned(f0_map, m.i_ids, hw0_c, stride, w)
        win1 = gather_windows_aligned(f1_map, m.j_ids, hw1_c, stride, w)
        coords, std = self._fine_refine_windows(win0, win1)
        mkpts0 = self._cell_xy(m.i_ids, hw0_c[1], scale_c)
        mkpts1_c = self._cell_xy(m.j_ids, hw1_c[1], scale_c)
        return {
            "mkpts0_f": mkpts0,
            "mkpts1_f": mkpts1_c + coords.float() * (w // 2) * scale_f,
            "mkpts0_c": mkpts0,
            "mkpts1_c": mkpts1_c,
            "expec_f": torch.cat([coords, std[..., None]], dim=-1),
            "mconf": m.mconf,
            "match_mask": m.mask,
        }

    def refine(
        self,
        img0: torch.Tensor,
        img1: torch.Tensor,
        mkpts0_c: torch.Tensor,
        mkpts1_c: torch.Tensor,
        match_mask: torch.Tensor,
        extract_features: bool = False,
    ) -> Dict[str, Any]:
        """Fine-only refinement of given coarse matches (pixel coords [N, K, 2]).

        The reference's 'coarse matches provided' branch
        (``loftr_for_sfm/loftr.py:80-124``): the coarse transformer still runs
        (feature extraction samples it), then 9 x 9 fine windows centred at the
        rounded matches on the 1/2 maps are refined; mkpts1_f moves, mkpts0
        stays.
        """
        feat0, feat1, hw0_c, hw1_c, f0_map, f1_map = self._coarse_features(img0, img1)
        h_i, h_f = img0.shape[1], f0_map.shape[1]
        scale_f, scale_c = h_i / h_f, h_i / hw0_c[0]

        def centers(mk):  # (row, col) on the fine grid, round half to even
            return torch.stack([torch.round(mk[..., 1] / scale_f),
                                torch.round(mk[..., 0] / scale_f)], dim=-1).to(torch.int32)

        w = self.cfg.fine_window_size
        win0 = gather_windows(f0_map, centers(mkpts0_c), w)
        win1 = gather_windows(f1_map, centers(mkpts1_c), w)
        coords, std = self._fine_refine_windows(win0, win1)
        mkpts1_f = mkpts1_c + coords.float() * (w // 2) * scale_f
        out = {
            "mkpts0_f": mkpts0_c,
            "mkpts1_f": mkpts1_f,
            "expec_f": torch.cat([coords, std[..., None]], dim=-1),
            "match_mask": match_mask,
        }
        if extract_features:
            n, _, c = feat0.shape
            feat0_map = feat0.reshape(n, hw0_c[0], hw0_c[1], c)
            feat1_map = feat1.reshape(n, hw1_c[0], hw1_c[1], c)
            out["feat_coarse_0"] = bilinear_sample(feat0_map, mkpts0_c / scale_c)
            out["feat_coarse_1"] = bilinear_sample(feat1_map, mkpts1_c / scale_c)
            out["feat_fine_0"] = bilinear_sample(f0_map, mkpts0_c / scale_f)
            out["feat_fine_1"] = bilinear_sample(f1_map, mkpts1_f / scale_f)
        return out

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> Dict[str, Any]:
        return self.match(img0, img1)
