"""Seeded random weights, drawn on the device in two calls.

Names and shapes come from the benchmark's reference model, which carries
the reference checkpoint's state-dict names, so the same dict loads into the
program under test (its normal ``load_state_dict``) and into the reference.
Convolutions are He-normal over their fan-out, linear layers LeCun-normal,
norm scales near 1, biases and BatchNorm means near 0 and BatchNorm
variances in [0.5, 1.5]: a matcher whose activations keep their scale
through the layers, as trained weights do.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def draw_state_dict(template: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """A float32 state dict with ``template``'s names and shapes, on ``device``,
    from ``seed``: one normal draw for every tensor and one uniform draw for
    the BatchNorm variances."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    names = [k for k in template if not k.endswith("num_batches_tracked")]
    var = [k for k in names if k.endswith("running_var")]
    normal = [k for k in names if not k.endswith("running_var")]
    sizes = [template[k].numel() for k in normal]
    z = torch.randn(sum(sizes), generator=gen, device=device).split(sizes)
    u = torch.rand(sum(template[k].numel() for k in var), generator=gen, device=device).split(
        [template[k].numel() for k in var])
    out = {}
    for k, a in zip(normal, z):
        shape = template[k].shape
        if len(shape) == 4:
            a = a * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        elif len(shape) == 2:
            a = a / math.sqrt(shape[1])
        elif k.endswith("weight"):
            a = 1.0 + 0.1 * a
        else:
            a = 0.1 * a
        out[k] = a.view(shape)
    for k, a in zip(var, u):
        out[k] = (0.5 + a).view(template[k].shape)
    for k in template:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=device)
    return {k: out[k] for k in template}


@torch.no_grad()
def centre_coarse_descriptors(weights: Dict[str, torch.Tensor], backbone, views: torch.Tensor,
                              gain: float) -> Dict[str, torch.Tensor]:
    """``weights`` with the coarse descriptor projection (``layer3_outconv``,
    a 1x1 convolution of the trunk's non-negative 1/8 map) made orthogonal to
    the trunk map's mean over ``views`` [n, H, W] and scaled by ``gain``.

    With random weights the coarse descriptors share one mean vector about
    five times the length of what tells two cells apart, so every row of the
    dual softmax favours the same cells and hardly any match passes the
    published threshold; a trained matcher's descriptors are centred and
    discriminative. ``backbone`` is the reference's, loaded with ``weights``,
    whose trunk gives the mean (float32)."""
    x = views[..., None].permute(0, 3, 1, 2).float()
    x = F.relu(backbone.bn1(backbone.conv1(x)))
    mu = backbone.layer3(backbone.layer2(backbone.layer1(x))).mean((0, 2, 3)).double()
    u = mu / mu.norm()
    key = [k for k in weights if k.endswith("layer3_outconv.weight")][0]
    w = weights[key][:, :, 0, 0].double()
    w = (w - (w @ u)[:, None] * u[None]) * gain
    return {**weights, key: w.float()[:, :, None, None].contiguous()}
