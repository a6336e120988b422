"""ResNet-FPN 8/2 backbone (port of ``onepose_plus_plus_tpu/models/backbone.py::
ResNetFPN_8_2``, dense path; reference ``backbone/resnet.py:20-164``).

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
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ResNetFPNConfig
from ..parallel import comm


class _Conv(nn.Conv2d):
    """Bias-free conv whose weight is cast to the input's dtype at call time."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding=None):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=kernel // 2 if padding is None else padding, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)


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
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _Conv(cin, planes, 3, stride)
        self.bn1 = _BN(planes)
        self.conv2 = _Conv(planes, planes, 3)
        self.bn2 = _BN(planes)
        self.downsample = (
            nn.Sequential(_Conv(cin, planes, 1, stride), _BN(planes)) if stride != 1 else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


def _out_conv2(cin: int, mid: int, cout: int) -> nn.Sequential:
    """FPN refinement conv3x3 -> BN -> LeakyReLU(0.01) -> conv3x3 (reference
    ``layerN_outconv2`` indices 0, 1, 3)."""
    return nn.Sequential(
        _Conv(cin, mid, 3), _BN(mid), nn.LeakyReLU(negative_slope=0.01), _Conv(mid, cout, 3)
    )


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=True)


class ResNetFPN_8_2(nn.Module):
    """ResNet + FPN: input [N, H, W, 1] -> (coarse [N, H/8, W/8, d2],
    fine [N, H/2, W/2, d0]), both NHWC in the compute dtype."""

    def __init__(self, cfg: ResNetFPNConfig = ResNetFPNConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.block_type != "basic":
            raise NotImplementedError("the port has the BasicBlock trunk only")
        self.dtype = dtype
        d0, d1, d2 = cfg.block_dims
        c0 = cfg.initial_dim
        self.conv1 = _Conv(1, c0, 7, 2, padding=3)
        self.bn1 = _BN(c0)
        self.layer1 = nn.Sequential(BasicBlock(c0, d0, 1), BasicBlock(d0, d0, 1))
        self.layer2 = nn.Sequential(BasicBlock(d0, d1, 2), BasicBlock(d1, d1, 1))
        self.layer3 = nn.Sequential(BasicBlock(d1, d2, 2), BasicBlock(d2, d2, 1))
        self.layer3_outconv = _Conv(d2, d2, 1)
        self.layer2_outconv = _Conv(d1, d2, 1)
        self.layer2_outconv2 = _out_conv2(d2, d2, d1)
        self.layer1_outconv = _Conv(d0, d1, 1)
        self.layer1_outconv2 = _out_conv2(d1, d1, d0)

    def forward(self, img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = img.permute(0, 3, 1, 2).to(self.dtype).contiguous(memory_format=torch.channels_last)
        x0 = torch.relu(self.bn1(self.conv1(x)))  # 1/2
        x1 = self.layer1(x0)  # 1/2
        x2 = self.layer2(x1)  # 1/4
        x3 = self.layer3(x2)  # 1/8
        x3_out = self.layer3_outconv(x3)
        x2_out = self.layer2_outconv2(self.layer2_outconv(x2) + _upsample2x(x3_out))
        x1_out = self.layer1_outconv2(self.layer1_outconv(x1) + _upsample2x(x2_out))
        nhwc = lambda t: t.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        return nhwc(x3_out), nhwc(x1_out)
