"""LoFTR-style local feature transformer (port of
``onepose_plus_plus_tpu/models/transformer.py``; reference
``loftr_module/transformer.py``).

Module and parameter names follow the reference state dict
(``layers.N.{q_proj,k_proj,v_proj,merge,mlp.0,mlp.2,norm1,norm2}``).

Two execution paths over the same parameters, chosen by the rule of the JAX
package (transformer.py:168-181): out of training, long sequences with linear
attention (the coarse stage, min(L, S) >= 256) run each layer as kernel K1
(``ops/cuda_encoder.py``, :func:`routes_to_k1`); everything else, such as the fine stage's 25-token
windows and every layer in train mode, runs the eager layer, which autograd
differentiates (K1 has no backward).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import TransformerConfig
from ..ops.attention import full_attention, linear_attention
from ..ops.cuda_encoder import (
    PackedEncoderWeights,
    fused_encoder_layer_packed,
    pack_encoder_weights,
)
from ..utils.dtypes import torch_dtype


class LoFTREncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, attention: str = "linear",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.nhead, self.attention, self.dtype = d_model, nhead, attention, dtype
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(
            nn.Linear(2 * d_model, 2 * d_model, bias=False),
            nn.ReLU(inplace=True),
            nn.Linear(2 * d_model, d_model, bias=False),
        )
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self._packed: Optional[Tuple[tuple, PackedEncoderWeights]] = None  # (key, weights) of K1

    def _linear(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), layer.weight.to(self.dtype))

    def kernel_weights(self) -> Tuple[torch.Tensor, ...]:
        """The layer's weights as the encoder kernels (K1, K7) take them: wq,
        wk, wv, wmerge, ln1 scale and bias, wmlp0, wmlp1, ln2 scale and bias,
        linear weights in the [in, out] layout."""
        return (self.q_proj.weight.t(), self.k_proj.weight.t(), self.v_proj.weight.t(),
                self.merge.weight.t(), self.norm1.weight, self.norm1.bias,
                self.mlp[0].weight.t(), self.mlp[2].weight.t(),
                self.norm2.weight, self.norm2.bias)

    def packed_weights(self) -> PackedEncoderWeights:
        """The layer's weights packed for K1 (``ops/cuda_encoder.py``) in the
        layer's operand dtype, on the weights' device. Packed once and kept
        until a weight changes: the key holds every parameter's version
        counter (in-place updates: an optimizer step, ``load_state_dict``),
        storage address, dtype and device (``.to()``). In train mode nothing
        is kept: the weights change at every step."""
        weights = self.kernel_weights()
        if self.training:
            return pack_encoder_weights(*weights, nhead=self.nhead, dtype=self.dtype)
        key = (self.dtype,) + tuple((w._version, w.data_ptr(), w.dtype, w.device) for w in weights)
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                packed = pack_encoder_weights(*weights, nhead=self.nhead, dtype=self.dtype)
            self._packed = (key, packed)
        return self._packed[1]

    def forward(
        self,
        x: torch.Tensor,
        source: torch.Tensor,
        x_mask: Optional[torch.Tensor] = None,
        source_mask: Optional[torch.Tensor] = None,
        fused: bool = False,
    ) -> torch.Tensor:
        """x [N, L, C] attends to source [N, S, C].

        ``fused`` runs kernel K1 (float32 out); the eager path returns x's dtype
        (LayerNorms in f32, projections in the compute dtype).
        """
        if fused and self.attention == "linear":
            return fused_encoder_layer_packed(x, source, self.packed_weights(), x_mask, source_mask)
        n, l, d = x.shape
        s = source.shape[1]
        if (self.attention == "linear" and s == 1
                and x_mask is None and source_mask is None):
            # exact shortcut for a length-1 source: linear attention returns
            # V for every query (up to the 1e-6 normaliser eps); the fine
            # stage's selected 3D descriptor is such a stream
            message = self._linear(self.v_proj, source).expand(n, l, d)
        else:
            hd = d // self.nhead
            q = self._linear(self.q_proj, x).view(n, l, self.nhead, hd)
            k = self._linear(self.k_proj, source).view(n, s, self.nhead, hd)
            v = self._linear(self.v_proj, source).view(n, s, self.nhead, hd)
            attn = linear_attention if self.attention == "linear" else full_attention
            message = attn(q, k, v, q_mask=x_mask, kv_mask=source_mask).reshape(n, l, d)
        message = self._linear(self.merge, message)
        message = F.layer_norm(message.float(), (d,), self.norm1.weight, self.norm1.bias, 1e-5)
        message = self._linear(self.mlp[0], torch.cat([x.to(self.dtype), message.to(self.dtype)], -1))
        message = self._linear(self.mlp[2], torch.relu(message))
        message = F.layer_norm(message.float(), (d,), self.norm2.weight, self.norm2.bias, 1e-5)
        return x + message.to(x.dtype)


def routes_to_k1(cfg: TransformerConfig, training: bool, len0: int, len1: int) -> bool:
    """Whether a layer stack runs each layer as kernel K1: ``cfg.fused_encoder``
    where set, else the JAX package's rule (linear attention out of training,
    both streams of at least 256 tokens), at any width. On the card a width
    that no K1 instance takes (``ops/cuda_encoder.py::k1_instance``) raises in
    the wrapper rather than running the eager layer."""
    if cfg.fused_encoder is not None:
        return cfg.fused_encoder
    return not training and cfg.attention == "linear" and min(len0, len1) >= 256


class LocalFeatureTransformer(nn.Module):
    """Alternating self/cross attention over two feature streams."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.compute_dtype)
        self.layers = nn.ModuleList(
            LoFTREncoderLayer(cfg.d_model, cfg.nhead, cfg.attention, dtype=dt)
            for _ in cfg.layer_sequence
        )

    def forward(
        self,
        feat0: torch.Tensor,
        feat1: torch.Tensor,
        mask0: Optional[torch.Tensor] = None,
        mask1: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feat0 [N, L, C] (3D descriptors), feat1 [N, S, C] (query grid)."""
        fused = routes_to_k1(self.cfg, self.training, feat0.shape[1], feat1.shape[1])
        for layer, name in zip(self.layers, self.cfg.layer_sequence):
            if name == "self":
                feat0, feat1 = (
                    layer(feat0, feat0, mask0, mask0, fused=fused),
                    layer(feat1, feat1, mask1, mask1, fused=fused),
                )
            elif name == "cross":
                feat0, feat1 = (
                    layer(feat0, feat1, mask0, mask1, fused=fused),
                    layer(feat1, feat0, mask1, mask0, fused=fused),
                )
            else:
                raise ValueError(name)
        return feat0, feat1
