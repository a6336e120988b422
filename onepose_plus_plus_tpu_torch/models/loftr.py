"""Detector-free image-pair matcher (port of ``onepose_plus_plus_tpu/models/loftr.py``).

The full LoFTR of the keypoint-free SfM (reference
``src/KeypointFreeSfM/loftr_for_sfm/loftr.py:16-167``; d_model 256/128, nhead
8, 4x self/cross coarse layers and one fine pair, linear attention,
dual-softmax T 0.1, thr 0.2, fine window 9) with its three modes:

- ``match``: coarse + fine matching of an image pair (fine windows at
  stride * cell through K3), with padding masks and, where the matcher is
  built with ``fine_concat_coarse_feat`` (LoFTR's outdoor and indoor models,
  ``FINE_CONCAT_COARSE_FEAT``), the coarse features merged into the fine
  windows (:class:`FinePreprocess`);
- ``match_coarse``: coarse only (the SfM coarse matching pass);
- ``refine``: fine refinement of given coarse matches (the post-optimisation
  pass), fine windows at arbitrary pixels through K6, optionally with the
  coarse transformer's and the fine map's features sampled at the matches
  (descriptor extraction).

The coarse transformer runs its 8 layer applications per stream through K1
(4096 tokens per stream at 512^2), and matching selects with K2 (both borders
removed on both grids, ``border_two_sided`` with ``row_grid_hw``). All outputs
use K static match slots with validity masks. Images are [N, H, W, 1] floats.

Images padded bottom-right to one square (LoFTR's loader; ``sfm.coarse_match
.run_pairs`` pads images of mixed shapes so) come with coarse masks
[N, h_c, w_c], True where a cell holds image: they zero the padded tokens'
queries, keys and values in every coarse layer (K1's masks), take padded rows
and columns out of the dual softmax (K2's ``row_add`` and ``col_add``) and
remove the border from each image's valid extent (LoFTR's
``mask_border_with_padding``). Without masks every mode runs as before.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import LoFTRConfig
from ..ops.cuda_matching import fused_select_topk_matches
from ..ops.matching import dual_softmax_confidence, select_topk_matches
from ..ops.soft_argmax import heatmap_std, spatial_expectation_2d
from ..ops.window_gather import gather_windows, gather_windows_aligned
from ..utils.dtypes import torch_dtype
from ..utils.profiling import annotate
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


class FinePreprocess(nn.Module):
    """LoFTR's fine preprocessing with ``FINE_CONCAT_COARSE_FEAT`` (reference
    ``src/loftr/utils/fine_preprocess.py``): each side's matched coarse feature
    goes through ``down_proj`` (Linear C -> Cf, with bias), is repeated over the
    window's W*W taps after their fine features, and ``merge_feat`` (Linear
    2 Cf -> Cf, with bias) merges the two. Products in the compute dtype."""

    def __init__(self, d_coarse: int, d_fine: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.down_proj = nn.Linear(d_coarse, d_fine, bias=True)
        self.merge_feat = nn.Linear(2 * d_fine, d_fine, bias=True)

    def _linear(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def forward(self, win0: torch.Tensor, win1: torch.Tensor, feat_c0: torch.Tensor, feat_c1: torch.Tensor):
        """Windows [N, K, W*W, Cf] and the matched coarse features [N, K, C] of
        each side -> the merged windows [N, K, W*W, Cf] of each side."""
        ww = win0.shape[2]
        n = win0.shape[0]
        c = self._linear(self.down_proj, torch.cat([feat_c0, feat_c1], 0))  # [2N, K, Cf]
        win = torch.cat([win0, win1], 0).to(self.dtype)
        merged = self._linear(self.merge_feat, torch.cat([win, c[:, :, None].expand(-1, -1, ww, -1)], -1))
        return merged[:n], merged[n:]


class LoFTRMatcher(nn.Module):
    def __init__(self, cfg: LoFTRConfig = LoFTRConfig(), fine_concat_coarse_feat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.compute_dtype)
        self.backbone = ResNetFPN_8_2(cfg.backbone, dtype=self.dtype)
        self.loftr_coarse = LocalFeatureTransformer(
            dataclasses.replace(cfg.coarse, compute_dtype=cfg.compute_dtype))
        self.loftr_fine = LocalFeatureTransformer(
            dataclasses.replace(cfg.fine, compute_dtype=cfg.compute_dtype))
        # not a LoFTRConfig field: the config dataclasses stay field-for-field the JAX package's
        self.fine_preprocess = (FinePreprocess(cfg.coarse.d_model, cfg.fine.d_model, self.dtype)
                                if fine_concat_coarse_feat else None)

    # ------------------------------------------------------------ blocks

    def _coarse_features(self, img0: torch.Tensor, img1: torch.Tensor, mask0=None, mask1=None):
        """Shared backbone over both images, sine PE, coarse transformer
        (padded tokens masked where coarse masks [N, h_c, w_c] are given)."""
        n = img0.shape[0]
        feat_c, feat_f = self.backbone(torch.cat([img0, img1], dim=0))
        c0_map, c1_map = feat_c[:n], feat_c[n:]
        _, h0c, w0c, c = c0_map.shape
        h1c, w1c = c1_map.shape[1:3]
        feat0 = sine_position_encoding(c0_map, self.cfg.pe_temp_bug_fix).reshape(n, h0c * w0c, c)
        feat1 = sine_position_encoding(c1_map, self.cfg.pe_temp_bug_fix).reshape(n, h1c * w1c, c)
        if mask0 is None:
            feat0, feat1 = self.loftr_coarse(feat0, feat1)
        else:
            feat0, feat1 = self.loftr_coarse(feat0, feat1, mask0.reshape(n, -1), mask1.reshape(n, -1))
        return feat0, feat1, (h0c, w0c), (h1c, w1c), feat_f[:n], feat_f[n:]

    def _coarse_match(self, feat0, feat1, hw0_c, hw1_c, mask0=None, mask1=None):
        cm = self.cfg.coarse_matching
        n = feat0.shape[0]
        m0 = None if mask0 is None else mask0.reshape(n, -1)
        m1 = None if mask1 is None else mask1.reshape(n, -1)
        if cm.use_fused_kernel is None or cm.use_fused_kernel:
            return fused_select_topk_matches(
                feat0, feat1, cm.temperature, hw1_c, cm.thr, cm.border_rm, cm.max_matches,
                border_two_sided=cm.border_two_sided, row_grid_hw=hw0_c,
                feat_norm=cm.feat_norm_method, col_mask=m1, dtype=self.dtype, row_mask=m0,
            )
        conf = dual_softmax_confidence(feat0, feat1, cm.temperature, m0, m1, feat_norm=cm.feat_norm_method)
        return select_topk_matches(conf, hw1_c, cm.thr, cm.border_rm, cm.max_matches,
                                   border_two_sided=cm.border_two_sided, row_grid_hw=hw0_c,
                                   row_mask=m0, col_mask=m1)

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

    def match_coarse(self, img0: torch.Tensor, img1: torch.Tensor, mask0=None, mask1=None) -> Dict[str, Any]:
        """Coarse-only matching (the reference's SfM coarse pass, fine off)."""
        feat0, feat1, hw0_c, hw1_c, _, _ = self._coarse_features(img0, img1, mask0, mask1)
        m = self._coarse_match(feat0, feat1, hw0_c, hw1_c, mask0, mask1)
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

    def match(self, img0: torch.Tensor, img1: torch.Tensor, mask0=None, mask1=None) -> Dict[str, Any]:
        """Full coarse + fine matching (LoFTR's forward): coarse masks
        [N, h_c, w_c] where the images are padded (module docstring)."""
        with annotate("loftr.coarse"):
            feat0, feat1, hw0_c, hw1_c, f0_map, f1_map = self._coarse_features(img0, img1, mask0, mask1)
        with annotate("loftr.match_coarse"):
            m = self._coarse_match(feat0, feat1, hw0_c, hw1_c, mask0, mask1)
        with annotate("loftr.fine"):
            h_i, h_f = img0.shape[1], f0_map.shape[1]
            stride = h_f // hw0_c[0]
            scale_c, scale_f = h_i / hw0_c[0], h_i / h_f
            w = self.cfg.fine_window_size
            win0 = gather_windows_aligned(f0_map, m.i_ids, hw0_c, stride, w)
            win1 = gather_windows_aligned(f1_map, m.j_ids, hw1_c, stride, w)
            if self.fine_preprocess is not None:
                win0, win1 = self.fine_preprocess(win0, win1, _take_rows(feat0, m.i_ids),
                                                  _take_rows(feat1, m.j_ids))
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
            out["feat_coarse_0"], out["feat_fine_0"] = self._sample_features(
                feat0, hw0_c, f0_map, mkpts0_c, scale_c, scale_f)
            out["feat_coarse_1"], out["feat_fine_1"] = self._sample_features(
                feat1, hw1_c, f1_map, mkpts1_f, scale_c, scale_f, mkpts1_c)
        return out

    @staticmethod
    def _sample_features(feat, hw_c, f_map, kpts_f, scale_c, scale_f, kpts_c=None):
        """(coarse, fine) features at keypoints: the coarse transformer's output
        at ``kpts_c`` (default ``kpts_f``), the backbone's fine map at ``kpts_f``."""
        n, _, c = feat.shape
        feat_map = feat.reshape(n, hw_c[0], hw_c[1], c)
        kpts_c = kpts_f if kpts_c is None else kpts_c
        return bilinear_sample(feat_map, kpts_c / scale_c), bilinear_sample(f_map, kpts_f / scale_f)

    def extract(self, img: torch.Tensor, kpts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(feat_fine, feat_coarse) at keypoints [N, K, 2]: what ``refine(img,
        img, kpts, kpts, mask, extract_features=True)`` returns as
        ``feat_fine_0`` / ``feat_coarse_0``, computed the same way (the
        self-pair coarse transformer included), without the fine windows, the
        fine transformer and the soft-argmax that those two never read."""
        feat0, _, hw0_c, _, f0_map, _ = self._coarse_features(img, img)
        h_i, h_f = img.shape[1], f0_map.shape[1]
        coarse, fine = self._sample_features(feat0, hw0_c, f0_map, kpts, h_i / hw0_c[0], h_i / h_f)
        return fine, coarse

    def forward(self, img0: torch.Tensor, img1: torch.Tensor, mask0=None, mask1=None) -> Dict[str, Any]:
        return self.match(img0, img1, mask0, mask1)


def _take_rows(feat: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` [N, K] of ``feat`` [N, L, C] -> [N, K, C]."""
    return torch.gather(feat, 1, ids.long()[..., None].expand(-1, -1, feat.shape[-1]))
