"""ResNet-FPN backbones (port of ``onepose_plus_plus_tpu/models/backbone.py``;
reference ``backbone/resnet.py:20-164``): ``ResNetFPN_8_2`` (the matchers'),
``ResNetFPN_16_4``, ``ResNet18_C`` (stages C2 and C3) and ``build_backbone``,
with BasicBlock or Bottleneck trunks.

Public layout is NHWC as in the JAX package; inside, the convolutions run in
``channels_last`` memory so that the NHWC view of each output is free. The
stem is the direct 7x7/2 conv (the JAX package's space-to-depth stem is equal
in output and exists only for the TPU), and the FPN upsample is
``F.interpolate(bilinear, align_corners=True)``. Parameters stay float32; the
compute dtype applies to the convolutions, and BatchNorm computes in float32
and returns the compute dtype (as flax's BatchNorm does). In train mode
(``module.train()``) BatchNorm follows flax's rules, not torch's: batch
statistics with the biased variance ``E[x^2] - E[x]^2``, and running
statistics updated with momentum 0.9 from that same biased variance
(``F.batch_norm`` would update with the unbiased one). Train mode sums each
sample's statistics first and adds the samples in a fixed pairwise order,
forward and backward (``_BatchNormTrain``). In data-parallel training
(``parallel.comm.global_batch``) the statistics are the global batch's, as
under the JAX package's sharded step: the sums, and in the backward the sums
of the gradient terms, are all-reduced over the ranks (SyncBatchNorm's rule
with flax's variance), and ranks with equal power-of-two shards compute what
one process computes on the whole batch, to the bit.

``ResNetFPN_8_2`` with ``quant_int8`` runs the JAX package's int8 convs in
eval mode (``ops/quant.py``): the stem, every BasicBlock conv (downsample
included), ``layer2_outconv``, ``layer1_outconv`` and each ``_OutConv2``'s
first conv; ``layer3_outconv`` and each ``_OutConv2``'s second conv, which
write descriptors, stay in the compute dtype. ``ResNetFPN_16_4`` and
``ResNet18_C`` never quantize, as in the JAX package. ``coarse_and_ctx`` and
``fine_windows`` are the sparse fine FPN (``fine.sparse_fpn``): the 1/2-level
3x3 pair runs only on halo patches of the matched cells, gathered by K6.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ResNetFPNConfig
from ..ops.cuda_patch_gather import patch_gather
from ..ops.quant import quant_conv
from ..parallel import comm


class _Conv(nn.Conv2d):
    """Bias-free conv whose weight is cast to the input's dtype at call time;
    with ``quant``, the int8 conv of ``ops/quant.py`` in eval mode. ``padding``
    at call time overrides the built one (the sparse path's valid convs)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding=None,
                 quant: bool = False):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=kernel // 2 if padding is None else padding, bias=False)
        self.quant = quant

    def forward(self, x: torch.Tensor, padding: Optional[int] = None) -> torch.Tensor:
        pad = self.padding[0] if padding is None else padding
        if self.quant and not self.training:
            return quant_conv(x, self.weight, self.stride[0], pad)
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, pad)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm of an f32 [N, C, H, W] map over the global batch:
    per-sample sums added by ``comm.batch_sum_samples`` in the forward (the
    statistics) and in the backward (the terms of dx). Returns (y, mean, var)."""

    @staticmethod
    def forward(ctx, xf, weight, bias, eps):
        n, c, h, w = xf.shape
        per_sample = torch.cat([xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3)),
                                xf.new_full((n, 1), float(h * w))], dim=1)
        sums = comm.batch_sum_samples(per_sample)
        count = sums[2 * c]
        mean = sums[:c] / count
        var = (sums[c:2 * c] / count - mean * mean).clamp_min(0.0)  # biased
        inv = torch.rsqrt(var + eps)
        xhat = (xf - mean[:, None, None]) * inv[:, None, None]
        ctx.save_for_backward(xhat, inv * weight)
        ctx.count = count
        ctx.mark_non_differentiable(mean, var)
        return xhat * weight[:, None, None] + bias[:, None, None], mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        xhat, mul = ctx.saved_tensors
        c = xhat.shape[1]
        local = comm._pairwise_sum(torch.cat([gy.sum(dim=(2, 3)), (gy * xhat).sum(dim=(2, 3))], dim=1))
        total = comm.batch_sum(local) / ctx.count
        gx = mul[:, None, None] * (gy - total[:c, None, None] - xhat * total[c:, None, None])
        # parameter gradients are this rank's share: DDP averages them
        return gx, local[c:], local[:c], None


class _BN(nn.BatchNorm2d):
    """BatchNorm (eps 1e-5) computed in f32, output in the input dtype; train
    mode as flax's ``BatchNorm(momentum=0.9)`` (JAX backbone.py:228-240)."""

    MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            # the f32 copy of x dies inside the call: no extra activation at peak
            y = F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                             self.bias, False, 0.0, self.eps)
            return y.to(x.dtype)
        y, mean, var = _BatchNormTrain.apply(x.float(), self.weight, self.bias, self.eps)
        with torch.no_grad():
            self.running_mean.mul_(self.MOMENTUM).add_(mean, alpha=1.0 - self.MOMENTUM)
            self.running_var.mul_(self.MOMENTUM).add_(var, alpha=1.0 - self.MOMENTUM)
        return y.to(x.dtype)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, quant: bool = False):
        super().__init__()
        self.conv1 = _Conv(cin, planes, 3, stride, quant=quant)
        self.bn1 = _BN(planes)
        self.conv2 = _Conv(planes, planes, 3, quant=quant)
        self.bn2 = _BN(planes)
        self.downsample = (
            nn.Sequential(_Conv(cin, planes, 1, stride, quant=quant), _BN(planes)) if stride != 1 else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 (planes / 4) -> 3x3 (stride) -> 1x1 (planes), each with BatchNorm
    (JAX backbone.py:269-286); never quantized, as in the JAX package."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        mid = planes // 4
        self.conv1 = _Conv(cin, mid, 1)
        self.bn1 = _BN(mid)
        self.conv2 = _Conv(mid, mid, 3, stride)
        self.bn2 = _BN(mid)
        self.conv3 = _Conv(mid, planes, 1)
        self.bn3 = _BN(planes)
        self.downsample = (
            nn.Sequential(_Conv(cin, planes, 1, stride), _BN(planes)) if stride != 1 else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


def _layer(block_type: str, cin: int, planes: int, stride: int, **kw) -> nn.Sequential:
    """Two blocks, the first with the stride (reference ``_make_layer``)."""
    block = {"basic": BasicBlock, "bottleneck": BottleneckBlock}[block_type]
    return nn.Sequential(block(cin, planes, stride, **kw), block(planes, planes, 1, **kw))


class _OutConv2(nn.Sequential):
    """FPN refinement conv3x3 -> BN -> LeakyReLU(0.01) -> conv3x3 (reference
    ``layerN_outconv2`` indices 0, 1, 3; ``quant`` applies to the first conv).
    ``pad=False`` runs both convs valid over gathered halo patches (the sparse
    fine path); ``mid_mask`` then re-imposes the dense path's map-border zeros
    between them (JAX backbone.py:289-328)."""

    def __init__(self, cin: int, mid: int, cout: int, quant: bool = False):
        super().__init__(_Conv(cin, mid, 3, quant=quant), _BN(mid), nn.LeakyReLU(negative_slope=0.01),
                         _Conv(mid, cout, 3))

    def forward(self, x: torch.Tensor, pad: bool = True,
                mid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        padding = 1 if pad else 0
        x = self[2](self[1](self[0](x, padding)))
        if mid_mask is not None:
            x = x * mid_mask.to(x.dtype)
        return self[3](x, padding)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=True)


def _nchw(img: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return img.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _stem(c0: int, quant: bool = False):
    return _Conv(1, c0, 7, 2, padding=3, quant=quant), _BN(c0)


class ResNetFPN_8_2(nn.Module):
    """ResNet + FPN: input [N, H, W, 1] -> (coarse [N, H/8, W/8, d2],
    fine [N, H/2, W/2, d0]), both NHWC in the compute dtype."""

    def __init__(self, cfg: ResNetFPNConfig = ResNetFPNConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.block_type == "bottleneck":
            # JAX backbone.py:361-366 passes quant= to every block, and
            # BottleneckBlock (:269) has no such field: flax raises TypeError
            raise ValueError("ResNetFPN_8_2 takes BasicBlocks only: the JAX package's ResNetFPN_8_2 "
                             "cannot build Bottleneck blocks (it passes quant= to BottleneckBlock, "
                             "which has no such field)")
        if cfg.block_type != "basic":
            raise ValueError(f"unknown block_type {cfg.block_type!r}")
        self.dtype = dtype
        d0, d1, d2 = cfg.block_dims
        c0 = cfg.initial_dim
        q = cfg.quant_int8
        self.conv1, self.bn1 = _stem(c0, q)
        self.layer1 = _layer("basic", c0, d0, 1, quant=q)
        self.layer2 = _layer("basic", d0, d1, 2, quant=q)
        self.layer3 = _layer("basic", d1, d2, 2, quant=q)
        # the convs that write descriptors (layer3_outconv, each _OutConv2's
        # second) stay in the compute dtype
        self.layer3_outconv = _Conv(d2, d2, 1)
        self.layer2_outconv = _Conv(d1, d2, 1, quant=q)
        self.layer2_outconv2 = _OutConv2(d2, d2, d1, quant=q)
        self.layer1_outconv = _Conv(d0, d1, 1, quant=q)
        self.layer1_outconv2 = _OutConv2(d1, d1, d0, quant=q)

    def _trunk_and_mid(self, img: torch.Tensor):
        """Stem, residual trunk and the FPN down to the 1/4 level (NCHW)."""
        x0 = torch.relu(self.bn1(self.conv1(_nchw(img, self.dtype))))  # 1/2
        x1 = self.layer1(x0)  # 1/2
        x2 = self.layer2(x1)  # 1/4
        x3 = self.layer3(x2)  # 1/8
        x3_out = self.layer3_outconv(x3)
        x2_out = self.layer2_outconv2(self.layer2_outconv(x2) + _upsample2x(x3_out))
        return x1, x2_out, x3_out

    def forward(self, img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x1, x2_out, x3_out = self._trunk_and_mid(img)
        x1_out = self.layer1_outconv2(self.layer1_outconv(x1) + _upsample2x(x2_out))
        return _nhwc(x3_out), _nhwc(x1_out)

    def coarse_and_ctx(self, img: torch.Tensor):
        """(coarse [N, H/8, W/8, d2] NHWC, ctx): ctx holds the 1/2 trunk map and
        the 1/4 FPN output that :meth:`fine_windows` takes once the matched
        cells are known."""
        x1, x2_out, x3_out = self._trunk_and_mid(img)
        return _nhwc(x3_out), (x1, x2_out)

    def fine_windows(self, ctx, cell_ids: torch.Tensor, grid_hw: Tuple[int, int], stride: int,
                     window: int) -> torch.Tensor:
        """The sparse fine stage (JAX backbone.py:417-489): the 1/2-level 3x3
        pair only on each match's halo patch. Equal, up to the convolutions'
        summation order, to ``gather_windows_aligned(self(img)[1], cell_ids,
        grid_hw, stride, window)``: [N, K] flat cell ids (out of range: a zero
        window) -> [N, K, window^2, d0]. The 1x1 lateral conv and the upsample
        add stay dense, so one K6 launch gathers the exact input of the pair;
        the two border masks re-impose the dense path's zero padding."""
        x1, x2_out = ctx
        n, _, h_f, w_f = x1.shape
        h_c, w_c = grid_hw
        k = cell_ids.shape[1]
        halo = 2  # two valid 3x3 convs
        w_in = window + 2 * halo
        half = window // 2
        ids = cell_ids.long()
        in_range = (ids >= 0) & (ids < h_c * w_c)
        far = torch.full_like(ids, -10 * w_in)  # a corner off the map: a zero patch
        r0 = torch.where(in_range, (ids // w_c) * stride - half - halo, far)
        c0 = torch.where(in_range, (ids % w_c) * stride - half - halo, far)
        pin_map = _nhwc(self.layer1_outconv(x1) + _upsample2x(x2_out)).contiguous()
        pin = patch_gather(pin_map, r0, c0, w_in)  # [N, K, w_in^2, C]
        pin = pin.reshape(n * k, w_in, w_in, -1).permute(0, 3, 1, 2)

        def border_mask(off: int, size: int) -> torch.Tensor:
            # patch position i maps to map row r0 + off + i; the dense path has
            # zeros (the convs' padding) outside the map
            i = torch.arange(size, device=ids.device)
            rows = r0.reshape(n * k, 1) + off + i
            cols = c0.reshape(n * k, 1) + off + i
            ok_r = (rows >= 0) & (rows < h_f)
            ok_c = (cols >= 0) & (cols < w_f)
            return (ok_r[:, :, None] & ok_c[:, None, :])[:, None]  # [N*K, 1, size, size]

        out = self.layer1_outconv2(pin, pad=False, mid_mask=border_mask(halo - 1, w_in - 2))
        out = out * border_mask(halo, window).to(out.dtype)
        return _nhwc(out).reshape(n, k, window * window, -1)


class ResNetFPN_16_4(nn.Module):
    """ResNet + FPN, coarse 1/16 and fine 1/4 (JAX backbone.py:492-540;
    reference ``ResNetFPN_16_4``): input [N, H, W, 1] -> (coarse [N, H/16,
    W/16, d3], fine [N, H/4, W/4, d1]), NHWC float32. Needs four block dims."""

    def __init__(self, cfg: ResNetFPNConfig = ResNetFPNConfig(block_dims=(128, 196, 256, 512)),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(cfg.block_dims) != 4:
            raise ValueError(f"ResNetFPN_16_4 needs 4 block dims, got {cfg.block_dims}")
        self.dtype = dtype
        d0, d1, d2, d3 = cfg.block_dims
        bt = cfg.block_type
        self.conv1, self.bn1 = _stem(cfg.initial_dim)
        self.layer1 = _layer(bt, cfg.initial_dim, d0, 1)
        self.layer2 = _layer(bt, d0, d1, 2)
        self.layer3 = _layer(bt, d1, d2, 2)
        self.layer4 = _layer(bt, d2, d3, 2)
        self.layer4_outconv = _Conv(d3, d3, 1)
        self.layer3_outconv = _Conv(d2, d3, 1)
        self.layer3_outconv2 = _OutConv2(d3, d3, d2)
        self.layer2_outconv = _Conv(d1, d2, 1)
        self.layer2_outconv2 = _OutConv2(d2, d2, d1)

    def forward(self, img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x0 = torch.relu(self.bn1(self.conv1(_nchw(img, self.dtype))))  # 1/2
        x1 = self.layer1(x0)  # 1/2
        x2 = self.layer2(x1)  # 1/4
        x3 = self.layer3(x2)  # 1/8
        x4 = self.layer4(x3)  # 1/16
        x4_out = self.layer4_outconv(x4)
        x3_out = self.layer3_outconv2(self.layer3_outconv(x3) + _upsample2x(x4_out))
        x2_out = self.layer2_outconv2(self.layer2_outconv(x2) + _upsample2x(x3_out))
        return _nhwc(x4_out).float(), _nhwc(x2_out).float()


class ResNet18_C(nn.Module):
    """Plain ResNet-18 trunk to stage C2 (1/2 map, block_dims[0]) or C3 (1/4
    map, block_dims[1]), no FPN (JAX backbone.py:543-572): [N, H, W, 1] ->
    NHWC float32."""

    def __init__(self, cfg: ResNetFPNConfig = ResNetFPNConfig(), stage: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        dims = cfg.block_dims
        self.conv1, self.bn1 = _stem(cfg.initial_dim)
        self.layer1 = _layer(cfg.block_type, cfg.initial_dim, dims[0], 1)
        self.layer2 = _layer(cfg.block_type, dims[0], dims[1], 2) if stage >= 3 else None

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        h = self.layer1(torch.relu(self.bn1(self.conv1(_nchw(img, self.dtype)))))  # C2
        if self.layer2 is not None:
            h = self.layer2(h)  # C3
        return _nhwc(h).float()


def build_backbone(name: str, cfg: ResNetFPNConfig, dtype: torch.dtype = torch.float32) -> nn.Module:
    """Backbone registry (JAX backbone.py:575-585; reference ``backbone/__init__.py:6-14``)."""
    if name in ("ResNetFPN_8_2", "resnetfpn_8_2"):
        return ResNetFPN_8_2(cfg, dtype=dtype)
    if name in ("ResNetFPN_16_4", "resnetfpn_16_4"):
        return ResNetFPN_16_4(cfg, dtype=dtype)
    if name in ("ResNet18C2", "resnet18c2"):
        return ResNet18_C(cfg, stage=2, dtype=dtype)
    if name in ("ResNet18C3", "resnet18c3"):
        return ResNet18_C(cfg, stage=3, dtype=dtype)
    raise ValueError(f"unknown backbone {name}")
