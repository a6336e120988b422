"""Plain PyTorch reference of LoFTR's published outdoor dual-softmax model, in
float32, with padding masks.

Written out for the benchmark from LoFTR (Sun et al., CVPR 2021;
https://github.com/zju3dv/LoFTR, ``configs/loftr/outdoor/loftr_ds.py`` over
``src/config/default.py``): ResNet-FPN 8/2 at 128 / (128, 196, 256), the
sine position encoding with ``TEMP_BUG_FIX``, 4 x (self, cross) linear
attention at d 256 and 8 heads with LoFTR's masks (queries, keys and values
of padded tokens zeroed), the dual softmax at temperature 0.1 with
``sim.masked_fill_(~(mask0[..., None] * mask1[:, None]), -1e9)``, threshold
0.2, ``mask_border_with_padding`` at ``border_rm`` 2, mutual nearest
neighbours with no cap on the count (``src/loftr/utils/coarse_matching.py``),
the fine preprocessing with ``FINE_CONCAT_COARSE_FEAT`` (5 x 5 windows by
``F.unfold`` at stride 4 and padding 2, ``down_proj`` and ``merge_feat``;
``src/loftr/utils/fine_preprocess.py``), the fine transformer (d 128, 8 heads,
one self and one cross layer) and the fine matching's expectation
(``src/loftr/utils/fine_matching.py``). Module names follow LoFTR's state
dict, so one state dict loads into this model and into the program.

Departures, none of which changes a number: images are [N, H, W, 1] (the
benchmark's layout; LoFTR's are [N, 1, H, W]); matches come back per pair of
the batch as index tensors rather than as flat ``b_ids``; the training-time
parts (ground-truth padding of the matches, the losses) are left out; every
product is float32 with TF32 off (:func:`benchmark.reference.exact_fp32`)
where LoFTR may run in mixed precision. It imports nothing of the program
and no kernel. The backbone, the position encoding and the encoder layer's
weights are those of :mod:`benchmark.reference.model`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .model import EncoderLayer, ResNetFPN82, sine_pe

INF = 1e9


class MaskedEncoderLayer(EncoderLayer):
    """LoFTR's ``LoFTREncoderLayer`` with ``LinearAttention`` and its masks."""

    def forward(self, x, source, x_mask=None, source_mask=None):
        n, l, d = x.shape
        s, h = source.shape[1], self.nhead
        q = F.elu(self.q_proj(x)).add(1.0).view(n, l, h, d // h)
        k = F.elu(self.k_proj(source)).add(1.0).view(n, s, h, d // h)
        v = self.v_proj(source).view(n, s, h, d // h)
        if x_mask is not None:
            q = q * x_mask[:, :, None, None]
        if source_mask is not None:
            k = k * source_mask[:, :, None, None]
            v = v * source_mask[:, :, None, None]
        values = v / s  # LoFTR's guard against fp16 overflow, undone below
        kv = torch.einsum("nshd,nshv->nhdv", k, values)
        z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, k.sum(1)) + 1e-6)
        msg = (torch.einsum("nlhd,nhdv,nlh->nlhv", q, kv, z) * s).reshape(n, l, d)
        msg = self.norm1(self.merge(msg))
        msg = self.norm2(self.mlp(torch.cat([x, msg], -1)))
        return x + msg


class MaskedTransformer(nn.Module):
    def __init__(self, d: int, nhead: int, iters: int):
        super().__init__()
        self.names = ("self", "cross") * iters
        self.layers = nn.ModuleList(MaskedEncoderLayer(d, nhead) for _ in self.names)

    def forward(self, f0, f1, m0=None, m1=None):
        for layer, name in zip(self.layers, self.names):
            if name == "self":
                f0, f1 = layer(f0, f0, m0, m0), layer(f1, f1, m1, m1)
            else:
                f0, f1 = layer(f0, f1, m0, m1), layer(f1, f0, m1, m0)
        return f0, f1


class FinePreprocess(nn.Module):
    """``FinePreprocess`` with ``cat_c_feat``: windows cut by ``F.unfold``,
    the matched coarse features through ``down_proj``, repeated over the
    window, concatenated after the fine features and merged."""

    def __init__(self, d_coarse: int, d_fine: int, window: int):
        super().__init__()
        self.window = window
        self.down_proj = nn.Linear(d_coarse, d_fine, bias=True)
        self.merge_feat = nn.Linear(2 * d_fine, d_fine, bias=True)

    def forward(self, feat_f0, feat_f1, feat_c0, feat_c1, b_ids, i_ids, j_ids, stride: int):
        """feat_f [N, Hf, Wf, Cf] (NHWC), feat_c [N, L, C] -> windows [M, W*W, Cf] of each side."""
        w = self.window

        def unfold(f):  # [N, Hf, Wf, Cf] -> [N, L, W*W, Cf]
            u = F.unfold(f.permute(0, 3, 1, 2), kernel_size=(w, w), stride=stride, padding=w // 2)
            return u.reshape(f.shape[0], f.shape[-1], w * w, -1).permute(0, 3, 2, 1)

        w0, w1 = unfold(feat_f0)[b_ids, i_ids], unfold(feat_f1)[b_ids, j_ids]
        c = self.down_proj(torch.cat([feat_c0[b_ids, i_ids], feat_c1[b_ids, j_ids]], 0))
        merged = self.merge_feat(torch.cat([torch.cat([w0, w1], 0), c[:, None].expand(-1, w * w, -1)], -1))
        return merged[:len(b_ids)], merged[len(b_ids):]


def border_keep(hw: Tuple[int, int], border: int, mask: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    """[N, h*w]: cells off the removed border. Without a mask, LoFTR's
    ``mask_border`` (``border`` cells on each side of the grid); with one
    [N, h, w], ``mask_border_with_padding`` (top and left as before, bottom
    and right from each image's valid extent: the longest valid column and
    row)."""
    h, w = hw
    r = torch.arange(h, device=device)[:, None].expand(h, w).reshape(-1)
    c = torch.arange(w, device=device)[None, :].expand(h, w).reshape(-1)
    keep = ((r >= border) & (c >= border))[None].expand(n, -1)
    if border <= 0:
        return torch.ones((n, h * w), dtype=torch.bool, device=device)
    if mask is None:
        return keep & ((r < h - border) & (c < w - border))[None]
    hs = mask.sum(1).max(-1)[0].int()
    ws = mask.sum(-1).max(-1)[0].int()
    return keep & (r[None] < (hs - border)[:, None]) & (c[None] < (ws - border)[:, None])


class LoFTROutdoor(nn.Module):
    """LoFTR outdoor-DS. ``cfg`` is the configuration file's ``model`` block."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cm, self.window = cfg["match_coarse"], cfg["fine_window_size"]
        self.temp_bug_fix = cfg.get("temp_bug_fix", False)
        self.backbone = ResNetFPN82()
        self.loftr_coarse = MaskedTransformer(cfg["d_model"], cfg["nhead"], cfg["layer_iter_n"])
        self.fine_preprocess = FinePreprocess(cfg["d_model"], 128, self.window)
        self.loftr_fine = MaskedTransformer(128, 8, 1)

    def coarse(self, img0, img1, mask0=None, mask1=None):
        """(feat_c0, feat_c1 [N, L, C] after the coarse transformer, the 1/2
        maps [N, Hf, Wf, Cf] of each side, (h, w) of the coarse grid)."""
        n = img0.shape[0]
        feat_c, feat_f = self.backbone(torch.cat([img0, img1]))
        _, h, w, c = feat_c.shape
        feat_c = (feat_c + sine_pe(c, h, w, self.temp_bug_fix).to(feat_c.device)[None]).reshape(2 * n, h * w, c)
        m0 = None if mask0 is None else mask0.reshape(n, -1).float()
        m1 = None if mask1 is None else mask1.reshape(n, -1).float()
        f0, f1 = self.loftr_coarse(feat_c[:n], feat_c[n:], m0, m1)
        return f0, f1, feat_f[:n], feat_f[n:], (h, w)

    def confidence(self, f0, f1, mask0=None, mask1=None):
        """The dual-softmax confidence [N, L, S] (LoFTR's ``conf_matrix``)."""
        c = f0.shape[-1]
        sim = torch.einsum("nlc,nsc->nls", f0 / c ** 0.5, f1 / c ** 0.5) / self.cm["dsmax_temperature"]
        if mask0 is not None:
            n = f0.shape[0]
            valid = mask0.reshape(n, -1)[..., None] & mask1.reshape(n, -1)[:, None]
            sim = sim.masked_fill(~valid, -INF)
        return F.softmax(sim, 1) * F.softmax(sim, 2)

    def select(self, conf, hw, mask0=None, mask1=None):
        """LoFTR's ``get_coarse_match`` at inference: threshold, border (with
        padding where masks are given), mutual nearest neighbours, every match
        kept. -> (b_ids, i_ids, j_ids, mconf)."""
        n = conf.shape[0]
        bd = self.cm["border_rm"]
        keep0 = border_keep(hw, bd, mask0, n, conf.device)
        keep1 = border_keep(hw, bd, mask1, n, conf.device)
        mask = (conf > self.cm["thr"]) & keep0[:, :, None] & keep1[:, None, :]
        mask &= (conf == conf.max(dim=2, keepdim=True)[0]) & (conf == conf.max(dim=1, keepdim=True)[0])
        mask_v, all_j = mask.max(dim=2)
        b_ids, i_ids = torch.where(mask_v)
        j_ids = all_j[b_ids, i_ids]
        return b_ids, i_ids, j_ids, conf[b_ids, i_ids, j_ids]

    def fine(self, w0, w1):
        """The fine transformer over merged windows [M, W*W, Cf] and the
        expectation of window 0's centre correlated with window 1 -> (coords
        [M, 2] in [-1, 1], std [M])."""
        w = self.window
        d0, d1 = self.loftr_fine(w0, w1)
        cf = d0.shape[-1]
        heat = torch.softmax(torch.einsum("mc,mrc->mr", d0[:, (w * w) // 2], d1) / cf ** 0.5, -1)
        lin = torch.linspace(-1.0, 1.0, w, device=heat.device)
        ys, xs = torch.meshgrid(lin, lin, indexing="ij")
        grid = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
        coords = heat @ grid
        std = torch.sqrt((heat @ (grid * grid) - coords ** 2).clamp_min(1e-10)).sum(-1)
        return coords, std

    def forward(self, img0, img1, mask0=None, mask1=None) -> List[Dict[str, torch.Tensor]]:
        """Every pair's matches: ``i_ids``, ``j_ids``, ``mconf``, ``mkpts0_c``,
        ``mkpts1_c``, ``mkpts1_f`` (pixels of the padded image) and the merged
        fine windows ``win0``, ``win1`` [M, W*W, Cf]."""
        f0, f1, ff0, ff1, hw = self.coarse(img0, img1, mask0, mask1)
        out = []
        for b in range(img0.shape[0]):
            m0 = None if mask0 is None else mask0[b:b + 1]
            m1 = None if mask1 is None else mask1[b:b + 1]
            conf = self.confidence(f0[b:b + 1], f1[b:b + 1], m0, m1)
            b_ids, i_ids, j_ids, mconf = self.select(conf, hw, m0, m1)
            del conf
            out.append(self.refine(f0[b:b + 1], f1[b:b + 1], ff0[b:b + 1], ff1[b:b + 1], hw, img0.shape[1],
                                   b_ids, i_ids, j_ids, mconf))
        return out

    def refine(self, f0, f1, ff0, ff1, hw, h_i: int, b_ids, i_ids, j_ids, mconf) -> Dict[str, torch.Tensor]:
        """The fine stage at given coarse matches of a batch's coarse features
        and 1/2 maps."""
        h, w = hw
        stride = ff0.shape[1] // h
        w0, w1 = self.fine_preprocess(ff0, ff1, f0, f1, b_ids, i_ids, j_ids, stride)
        coords, std = self.fine(w0, w1)
        scale_c, scale_f = h_i / h, h_i / ff0.shape[1]
        xy = lambda ids: torch.stack([ids % w, ids // w], -1).float() * scale_c  # noqa: E731
        mk1 = xy(j_ids)
        return {"i_ids": i_ids, "j_ids": j_ids, "mconf": mconf, "mkpts0_c": xy(i_ids), "mkpts1_c": mk1,
                "mkpts1_f": mk1 + coords * (self.window // 2) * scale_f, "std": std, "win0": w0, "win1": w1}
