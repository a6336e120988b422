"""Plain PyTorch reference of the two matchers the benchmark runs, in float32.

Written out for the benchmark from the published OnePose++ model
(``src/models/OnePosePlus/OnePosePlusModel.py``, the LoFTR of
``src/KeypointFreeSfM/loftr_for_sfm``): ResNet-FPN 8/2, the 2D sine position
encoding with the released weights' "temp bug", the 3D keypoint encoder,
linear-attention LoFTR layers, dual-softmax mutual-nearest-neighbour matching
into fixed slots, fine windows, the fine transformer and the heatmap
soft-argmax. Module names follow the reference checkpoint's state dict, so
one state dict loads into this model and into the program under test.

It imports nothing of the program and no kernel: every operation is a plain
``torch`` call, every product in float32 (run it under
:func:`benchmark.reference.exact_fp32`, which turns TF32 off).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ------------------------------------------------------------------ backbone

class _Block(nn.Module):
    """ResNet BasicBlock: conv3x3 (stride) - BN - ReLU - conv3x3 - BN, plus the
    1x1 downsample where strided."""

    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, planes, 1, stride, bias=False), nn.BatchNorm2d(planes))
                           if stride != 1 else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


def _outconv2(cin: int, mid: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, mid, 3, 1, 1, bias=False), nn.BatchNorm2d(mid),
                         nn.LeakyReLU(0.01), nn.Conv2d(mid, cout, 3, 1, 1, bias=False))


def _up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=True)


class ResNetFPN82(nn.Module):
    """[N, H, W, 1] in [0, 1] -> (coarse [N, H/8, W/8, d2], fine [N, H/2, W/2, d0]), NHWC."""

    def __init__(self, initial_dim: int = 128, block_dims: Sequence[int] = (128, 196, 256)):
        super().__init__()
        d0, d1, d2 = block_dims
        self.conv1 = nn.Conv2d(1, initial_dim, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(initial_dim)
        self.layer1 = nn.Sequential(_Block(initial_dim, d0, 1), _Block(d0, d0, 1))
        self.layer2 = nn.Sequential(_Block(d0, d1, 2), _Block(d1, d1, 1))
        self.layer3 = nn.Sequential(_Block(d1, d2, 2), _Block(d2, d2, 1))
        self.layer3_outconv = nn.Conv2d(d2, d2, 1, bias=False)
        self.layer2_outconv = nn.Conv2d(d1, d2, 1, bias=False)
        self.layer2_outconv2 = _outconv2(d2, d2, d1)
        self.layer1_outconv = nn.Conv2d(d0, d1, 1, bias=False)
        self.layer1_outconv2 = _outconv2(d1, d1, d0)

    def forward(self, img):
        x0 = F.relu(self.bn1(self.conv1(img.permute(0, 3, 1, 2).float())))
        x1 = self.layer1(x0)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x3_out = self.layer3_outconv(x3)
        x2_out = self.layer2_outconv2(self.layer2_outconv(x2) + _up2(x3_out))
        x1_out = self.layer1_outconv2(self.layer1_outconv(x1) + _up2(x2_out))
        return x3_out.permute(0, 2, 3, 1), x1_out.permute(0, 2, 3, 1)


# ------------------------------------------------------- position encodings

def sine_pe(c: int, h: int, w: int, temp_bug_fix: bool = False) -> torch.Tensor:
    """[h, w, c] 2D sine table, positions from 1; without the fix the exponent
    is the released weights' ``(-log(1e4) / c) // 2``."""
    pe = np.zeros((c, h, w), np.float32)
    y = np.arange(1, h + 1, dtype=np.float32)[None, :, None] * np.ones((1, 1, w), np.float32)
    x = np.arange(1, w + 1, dtype=np.float32)[None, None, :] * np.ones((1, h, 1), np.float32)
    exponent = -math.log(10000.0) / (c // 2) if temp_bug_fix else (-math.log(10000.0) / c) // 2
    div = np.exp(np.arange(0, c // 2, 2, dtype=np.float32) * exponent)[:, None, None]
    pe[0::4], pe[1::4] = np.sin(x * div), np.cos(x * div)
    pe[2::4], pe[3::4] = np.sin(y * div), np.cos(y * div)
    return torch.from_numpy(pe.transpose(1, 2, 0).copy())


def normalize_keypoints(kpts: torch.Tensor) -> torch.Tensor:
    """[N, L, 3] -> centred per sample, divided by 0.6 x the largest extent of sample 0."""
    extent = (kpts[0].amax(0) - kpts[0].amin(0)).max()
    return (kpts - kpts.mean(dim=-2, keepdim=True)) / (extent * 0.6)


class _PointNorm(nn.Module):
    """InstanceNorm1d applied to [N, L, C]: each point normalised over its channels."""

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(((x - mean) ** 2).mean(-1, keepdim=True) + 1e-5)


class KeypointEncoder(nn.Module):
    def __init__(self, layers: Sequence[int] = (32, 64, 128), dim: int = 256):
        super().__init__()
        widths = [3, *layers, dim]
        mods = []
        for i in range(len(widths) - 1):
            mods.append(nn.Linear(widths[i], widths[i + 1]))
            if i < len(widths) - 2:
                mods += [_PointNorm(), nn.ReLU()]
        self.encoder = nn.Sequential(*mods)

    def forward(self, kpts, desc):
        return desc + self.encoder(kpts)


# -------------------------------------------------------------- transformer

class EncoderLayer(nn.Module):
    """LoFTR encoder layer with elu + 1 linear attention."""

    def __init__(self, d: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.merge = nn.Linear(d, d, bias=False)
        self.mlp = nn.Sequential(nn.Linear(2 * d, 2 * d, bias=False), nn.ReLU(), nn.Linear(2 * d, d, bias=False))
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, x, source, rnd=None):
        """``rnd``, where given, rounds every operand of every product (the
        lower-precision control); norms, softmax and sums stay float32."""
        r = rnd or (lambda a: a)
        lin = lambda m, a: F.linear(r(a), r(m.weight))  # noqa: E731
        n, l, d = x.shape
        s, h = source.shape[1], self.nhead
        q = F.elu(lin(self.q_proj, x)).add(1.0).view(n, l, h, d // h)
        k = F.elu(lin(self.k_proj, source)).add(1.0).view(n, s, h, d // h)
        v = lin(self.v_proj, source).view(n, s, h, d // h)
        kv = torch.einsum("nshd,nshv->nhdv", r(k), r(v))
        z = 1.0 / (torch.einsum("nlhd,nhd->nlh", r(q), r(k.sum(1))) + 1e-6)
        msg = torch.einsum("nlhd,nhdv,nlh->nlhv", r(q), r(kv), z).reshape(n, l, d)
        msg = self.norm1(lin(self.merge, msg))
        msg = self.norm2(lin(self.mlp[2], F.relu(lin(self.mlp[0], torch.cat([x, msg], -1)))))
        return x + msg


class FeatureTransformer(nn.Module):
    def __init__(self, d: int, nhead: int, layer_names: Sequence[str], iters: int):
        super().__init__()
        self.names = tuple(layer_names) * iters
        self.layers = nn.ModuleList(EncoderLayer(d, nhead) for _ in self.names)

    def forward(self, f0, f1, rnd=None):
        for layer, name in zip(self.layers, self.names):
            if name == "self":
                f0, f1 = layer(f0, f0, rnd), layer(f1, f1, rnd)
            else:
                f0, f1 = layer(f0, f1, rnd), layer(f1, f0, rnd)
        return f0, f1


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 (e4m3) under one scale for the tensor, as an fp8
    product's operand is: the rounding of the control for a bf16 stage."""
    s = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


# ------------------------------------------------------------------ matching

def dual_softmax(f0, f1, temperature: float):
    """[N, L, C], [N, S, C] -> (confidence, log-confidence) [N, L, S]; features
    scaled by 1/sqrt(C), similarity over (temperature + 1e-4)."""
    c = f0.shape[-1]
    sim = torch.einsum("nlc,nsc->nls", f0 / c ** 0.5, f1 / c ** 0.5) / (temperature + 1e-4)
    log_conf = torch.log_softmax(sim, 1) + torch.log_softmax(sim, 2)
    return torch.exp(log_conf), log_conf


def border_keep(h: int, w: int, border: int, two_sided: bool, device) -> torch.Tensor:
    idx = torch.arange(h * w, device=device)
    r, c = idx // w, idx % w
    keep = (r >= border) & (c >= border)
    if two_sided:
        keep &= (r < h - border) & (c < w - border)
    return keep


def select_matches(conf, grid_hw, thr: float, border: int, k: int, two_sided: bool,
                   row_grid_hw: Optional[Tuple[int, int]] = None):
    """Mutual nearest neighbours above ``thr`` off the border, the ``k`` most
    confident rows first (lower row first among equals). Returns i_ids, j_ids,
    mconf, mask, each [N, k]; empty slots have mask False and mconf 0."""
    n, l, s = conf.shape
    valid = (conf == conf.amax(2, keepdim=True)) & (conf == conf.amax(1, keepdim=True)) & (conf > thr)
    valid &= border_keep(*grid_hw, border, two_sided, conf.device)[None, None, :]
    if row_grid_hw is not None:
        valid &= border_keep(*row_grid_hw, border, two_sided, conf.device)[None, :, None]
    j_of_row = torch.argmax(torch.where(valid, conf, torch.full_like(conf, -1.0)), dim=2)
    score = torch.where(valid.any(2), torch.gather(conf, 2, j_of_row[..., None])[..., 0],
                        torch.full((n, l), -1.0, device=conf.device))
    top, order = torch.sort(score, dim=1, descending=True, stable=True)
    if l < k:
        top = torch.cat([top, top.new_full((n, k - l), -1.0)], 1)
        order = torch.cat([order, order.new_zeros((n, k - l))], 1)
    top, i_ids = top[:, :k], order[:, :k]
    mask = top > 0
    return i_ids, torch.gather(j_of_row, 1, i_ids), torch.where(mask, top, torch.zeros_like(top)), mask


def windows_at(feat, rows, cols, window: int):
    """W x W windows of feat [N, H, W, C] whose top-left taps are (rows, cols)
    [N, K]; taps off the map are zero. -> [N, K, W*W, C]."""
    n, h, w, c = feat.shape
    offs = torch.arange(window, device=feat.device)
    r = rows.long()[..., None] + offs
    q = cols.long()[..., None] + offs
    valid = ((r >= 0) & (r < h))[..., :, None] & ((q >= 0) & (q < w))[..., None, :]
    flat = (r.clamp(0, h - 1)[..., :, None] * w + q.clamp(0, w - 1)[..., None, :]).reshape(n, -1)
    out = torch.gather(feat.reshape(n, h * w, c), 1, flat[..., None].expand(-1, -1, c))
    out = out.reshape(n, rows.shape[1], window * window, c)
    return out * valid.reshape(n, rows.shape[1], window * window, 1).to(out.dtype)


def cell_windows(feat, cell_ids, w_c: int, n_cells: int, stride: int, window: int):
    """Windows centred at ``stride * cell``; an id off the grid gives a zero window."""
    ids = cell_ids.long()
    off = torch.where((ids >= 0) & (ids < n_cells), 0, -10 * window - 10 ** 6)
    half = window // 2
    return windows_at(feat, stride * (ids // w_c) - half + off, stride * (ids % w_c) - half + off, window)


def soft_argmax(heat, window: int):
    """(expected (x, y) in [-1, 1], summed standard deviation) of heatmaps [M, W*W]."""
    lin = torch.linspace(-1.0, 1.0, window, device=heat.device, dtype=heat.dtype)
    ys, xs = torch.meshgrid(lin, lin, indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    coords = heat @ grid
    std = torch.sqrt((heat @ (grid * grid) - coords * coords).clamp_min(1e-10)).sum(-1)
    return coords, std


# ------------------------------------------------------------------ matchers

class OnePosePlus(nn.Module):
    """The 2D-3D matcher. ``cfg`` is the configuration file's ``model`` block
    (the reference YAML's key names)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        bb, kp = cfg["loftr_backbone"], cfg["keypoints_encoding"]
        co, cm, fi = cfg["loftr_coarse"], cfg["match_coarse"], cfg["loftr_fine"]
        self.cm, self.window, self.temp_bug_fix = cm, fi["window_size"], co.get("temp_bug_fix", False)
        self.backbone = ResNetFPN82(bb["initial_dim"], bb["block_dims"])
        self.kpt_3d_pos_encoding = KeypointEncoder(kp["keypoints_encoder"], kp["descriptor_dim"])
        self.loftr_coarse = FeatureTransformer(co["d_model"], co["nhead"], co["layer_names"], co["layer_iter_n"])
        self.loftr_fine = FeatureTransformer(fi["d_model"], fi["nhead"], fi["layer_names"], fi["layer_iter_n"])

    def coarse_map(self, img):
        """(coarse map with the sine PE [N, h, w, C], fine map [N, H/2, W/2, Cf])."""
        feat_c, feat_f = self.backbone(img)
        _, h, w, c = feat_c.shape
        return feat_c + sine_pe(c, h, w, self.temp_bug_fix).to(feat_c.device)[None], feat_f

    def forward(self, img, kpts3d, desc3d, desc3d_coarse, train: bool = False, gt_slots=None):
        """img [N, H, W, 1] in [0, 1]; the cloud [N, L, ...]. In training,
        ``gt_slots`` (i_ids, j_ids, mask) are appended to the predicted slots and
        the log-confidence is returned for the loss."""
        cm = self.cm
        n, h_i = img.shape[0], img.shape[1]
        feat_c, feat_f = self.coarse_map(img)
        _, h_c, w_c, c = feat_c.shape
        desc_c = self.kpt_3d_pos_encoding(normalize_keypoints(kpts3d), desc3d_coarse)
        f0, f1 = self.loftr_coarse(desc_c, feat_c.reshape(n, h_c * w_c, c))
        conf, log_conf = dual_softmax(f0, f1, cm["dsmax_temperature"])
        k = cm["train_max_matches"] - cm["train_pad_num_gt_min"] if train else cm["max_matches"]
        i_ids, j_ids, mconf, mask = select_matches(conf.detach(), (h_c, w_c), cm["thr"], cm["border_rm"], k, False)
        if gt_slots is not None:
            i_ids = torch.cat([i_ids, gt_slots[0]], 1)
            j_ids = torch.cat([j_ids, gt_slots[1]], 1)
            mconf = torch.cat([mconf, mconf.new_zeros(gt_slots[0].shape)], 1)
            mask = torch.cat([mask, gt_slots[2]], 1)
        cf = feat_f.shape[-1]
        d0 = torch.gather(desc3d, 1, i_ids.long()[..., None].expand(-1, -1, cf))
        mk_f, expec_f = self.fine_stage(feat_f, d0, j_ids, (h_c, w_c), h_i)
        out = {"i_ids": i_ids, "j_ids": j_ids, "mconf": mconf, "mask": mask, "mkpts_query_f": mk_f,
               "expec_f": expec_f, "hw_c": (h_c, w_c)}
        if train:
            out["log_conf"] = log_conf
            out["conf"] = conf
        return out

    def fine_stage(self, feat_f, desc_fine, j_ids, hw_c, h_i: int, rnd=None):
        """(mkpts_query_f [N, K, 2], expec_f [N, K, 3]) of the slots whose 3D
        points' fine descriptors are ``desc_fine`` [N, K, Cf] and whose cells are
        ``j_ids`` [N, K], on the fine map ``feat_f`` [N, H/2, W/2, Cf]: windows at
        stride x cell, the fine transformer, the heatmap's soft-argmax. ``rnd``
        rounds the operands of its products (the control)."""
        (h_c, w_c), (n, kk, cf) = hw_c, desc_fine.shape
        h_f = feat_f.shape[1]
        stride, w = h_f // h_c, self.window
        win = cell_windows(feat_f, j_ids, w_c, h_c * w_c, stride, w)  # [N, K, W*W, Cf]
        d0, d1 = self.loftr_fine(desc_fine.reshape(n * kk, 1, cf), win.reshape(n * kk, w * w, cf), rnd)
        r = rnd or (lambda a: a)
        heat = torch.softmax(torch.einsum("mc,mrc->mr", r(d0[:, 0]), r(d1)) / cf ** 0.5, -1)
        coords, std = soft_argmax(heat, w)
        jl = j_ids.long()
        mk_c = torch.stack([jl % w_c, jl // w_c], -1).float() * (h_i / h_c)
        return (mk_c + coords.reshape(n, kk, 2) * (w // 2) * (h_i / h_f),
                torch.cat([coords, std[:, None]], -1).reshape(n, kk, 3))


class LoFTR(nn.Module):
    """The image-pair matcher of the keypoint-free SfM: ``match_coarse``, and
    ``refine``'s fine stage on given fine maps (``refine_stage``)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cm = cfg["match_coarse"]
        self.backbone = ResNetFPN82()
        self.loftr_coarse = FeatureTransformer(cfg["d_model"], cfg["nhead"], ("self", "cross"), cfg["layer_iter_n"])
        self.loftr_fine = FeatureTransformer(128, 8, ("self", "cross"), 1)
        self.window = cfg["fine_window_size"]

    def match_coarse(self, img0, img1):
        """[N, H, W, 1] pairs -> (mkpts0_c, mkpts1_c [N, K, 2] cell corners in
        pixels, mconf, mask), both borders removed on both grids."""
        cm, n = self.cm, img0.shape[0]
        feat_c, _ = self.backbone(torch.cat([img0, img1]))
        _, h, w, c = feat_c.shape
        feat_c = (feat_c + sine_pe(c, h, w).to(feat_c.device)[None]).reshape(2 * n, h * w, c)
        f0, f1 = self.loftr_coarse(feat_c[:n], feat_c[n:])
        conf, _ = dual_softmax(f0, f1, cm["dsmax_temperature"])
        i_ids, j_ids, mconf, mask = select_matches(conf, (h, w), cm["thr"], cm["border_rm"], cm["max_matches"],
                                                   True, row_grid_hw=(h, w))
        xy = lambda ids: torch.stack([ids % w, ids // w], -1).float() * (img0.shape[1] / h)  # noqa: E731
        return xy(i_ids), xy(j_ids), mconf, mask

    def fine_map(self, img):
        """The backbone's 1/2 map [N, H/2, W/2, 128] of images [N, H, W, 1] in [0, 1]."""
        return self.backbone(img)[1]

    def refine_stage(self, f0, f1, mk0, mk1, h_i: int, rnd=None):
        """mkpts1_f [N, K, 2] of coarse matches ``mk0``, ``mk1`` [N, K, 2] (pixels
        of an image of side ``h_i``) on the fine maps ``f0``, ``f1`` [N, h, w, C]:
        W x W windows centred at the rounded matches (half to even), the fine
        transformer over both, the correlation of window 0's centre with window 1
        and its soft-argmax; mkpts1 moves, mkpts0 stays. ``rnd`` as in
        ``OnePosePlus.fine_stage``."""
        (n, k, _), w, cf = mk0.shape, self.window, f0.shape[-1]
        scale, half = h_i / f0.shape[1], self.window // 2

        def win(f, mk):
            c = torch.round(mk / scale).long()
            return windows_at(f, c[..., 1] - half, c[..., 0] - half, w).reshape(n * k, w * w, cf)

        d0, d1 = self.loftr_fine(win(f0, mk0), win(f1, mk1), rnd)
        r = rnd or (lambda a: a)
        heat = torch.softmax(torch.einsum("mc,mrc->mr", r(d0[:, (w * w) // 2]), r(d1)) / cf ** 0.5, -1)
        coords, _ = soft_argmax(heat, w)
        return mk1 + coords.reshape(n, k, 2) * half * scale

