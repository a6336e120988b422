"""Attention for the LoFTR-style transformers (port of
``onepose_plus_plus_tpu/ops/attention.py``; reference
``loftr_module/linear_attention.py:21-95``). Shapes are [N, seq, heads, dim].

Linear attention uses the per-head contractions of the reference; the JAX
package's full-width head-block-masked form exists for the TPU's matrix unit.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def linear_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """elu+1 linear attention ("Transformers are RNNs"); returns f32 [N, L, H, D].

    Keeps the reference's 1/S value pre-scaling and trailing *S.
    """
    q, k, v = q.float(), k.float(), v.float()
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].float()
    if kv_mask is not None:
        K = K * kv_mask[:, :, None, None].float()
        v = v * kv_mask[:, :, None, None].float()
    v_length = v.shape[1]
    values = v / v_length
    KV = torch.einsum("nshd,nshv->nhdv", K, values)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * v_length


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax attention ([N, L, H, D] x [N, S, H, D]); reference ``FullAttention``."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("nlhd,nshd->nlsh", q, k)
    if kv_mask is not None:
        mask = q_mask[:, :, None, None].bool() & kv_mask[:, None, :, None].bool()
        logits = logits.masked_fill(~mask, float("-inf"))
    attn = torch.softmax(scale * logits, dim=2)
    return torch.einsum("nlsh,nshd->nlhd", attn, v)
