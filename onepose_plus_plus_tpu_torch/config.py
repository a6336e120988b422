"""Typed, hashable model/matcher configurations.

Mirrors the behavioral surface of the reference Hydra config schema
(``configs/experiment/train.yaml:44-127`` for the 2D-3D matcher and
``src/KeypointFreeSfM/loftr_for_sfm/utils/loftr_for_onepose_plus_cfg.py`` for
the image-pair LoFTR) as frozen dataclasses.

The port's own copy of ``onepose_plus_plus_tpu/config.py``: the same classes,
fields and defaults (``tests/test_torch_host_copies.py`` holds the two
equal). The comments on TPU options describe the JAX package; the port reads
every field: ``compute_dtype``, the widths and block type, the matching
settings, ``fused_encoder`` / ``use_fused_kernel`` (``None``: kernels on), and
the options that are off by default, ``quant_int8`` (int8 backbone convs at
inference), ``fine.sparse_fpn`` (on only when ``True``; the halo patches go
through K6) and ``keypoints_encoding.norm_method``. ``stem_s2d`` changes
nothing in the port: its stem is the direct conv, equal in output.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ResNetFPNConfig:
    initial_dim: int = 128
    block_dims: Tuple[int, ...] = (128, 196, 256)
    block_type: str = "basic"  # 'basic' | 'bottleneck'
    # opt-in int8 inference path: dynamic per-tensor activation scales +
    # per-output-channel weight scales, s8 x s8 -> s32 convs. Inference-only —
    # the train path ignores it. Measured neutral on v5e at 48x512^2 (82.3 ms
    # vs 83.6 ms bf16: XLA does not hit the 2x int8 MXU path for these convs),
    # so it stays off by default; useful on backends with real s8 conv support.
    quant_int8: bool = False
    # space-to-depth stem: compute the 7x7/2 single-channel stem conv as an
    # exactly-equivalent 4x4/1 conv over the 2x2-space-to-depth input
    # ([H,W,1] -> [H/2,W/2,4]). The direct form gives the MXU a contraction
    # depth of 49x1 over a 1-channel image (worst-case utilization); the s2d
    # form has 4 input channels and a 4x4 window. Same `conv1/kernel` param
    # (7,7,1,C) — the scatter to (4,4,4,C) happens at call time — so
    # checkpoints are unaffected. Falls back to the direct conv on odd sizes.
    stem_s2d: bool = True


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    d_model: int = 256
    nhead: int = 8
    compute_dtype: str = "float32"
    layer_names: Tuple[str, ...] = ("self", "cross")
    layer_iter_n: int = 3
    attention: str = "linear"  # 'linear' | 'full'
    norm_method: str = "layernorm"
    # None = auto: fused Pallas encoder layers at inference on TPU for
    # long sequences (see models/transformer.py); True/False forces
    fused_encoder: Optional[bool] = None

    @property
    def layer_sequence(self) -> Tuple[str, ...]:
        return tuple(self.layer_names) * self.layer_iter_n


@dataclasses.dataclass(frozen=True)
class CoarseMatchingConfig:
    thr: float = 0.1
    border_rm: int = 2
    temperature: float = 0.08
    feat_norm_method: str = "sqrt_feat_dim"
    max_matches: int = 512  # K static match slots at inference
    # training-time capacities (reference train_coarse_percent / pad_num_gt_min)
    train_max_matches: int = 1228  # int(min(L, S) * train_coarse_percent)
    train_pad_num_gt_min: int = 200
    # reference quirk: the 2D-3D matcher only removes top/left borders
    border_two_sided: bool = False
    # None = auto: fused Pallas dual-softmax matching at inference on TPU
    use_fused_kernel: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class FineConfig:
    enable: bool = True
    window_size: int = 5
    d_model: int = 128
    transformer: TransformerConfig = TransformerConfig(
        d_model=128, nhead=8, layer_iter_n=1
    )
    # sparse fine FPN: run the 1/2-level FPN convs only on per-match halo
    # patches (backbone.fine_windows) instead of the whole map + window
    # gather. Exact same outputs; inference-only (training always uses the
    # dense differentiable path). None = auto (off pending v5e measurement).
    sparse_fpn: "bool | None" = None


@dataclasses.dataclass(frozen=True)
class KeypointEncodingConfig:
    enable: bool = True
    descriptor_dim: int = 256
    layers: Tuple[int, ...] = (32, 64, 128)
    norm_method: str = "instancenorm"


@dataclasses.dataclass(frozen=True)
class OnePosePlusConfig:
    """The 2D-3D 'GATs-LoFTR' matcher (reference OnePosePlusModel.py:25-201)."""

    # 'bfloat16' runs backbone + transformers on the MXU at half traffic
    # (params stay f32; matching/softmax numerics stay f32)
    compute_dtype: str = "float32"
    backbone: ResNetFPNConfig = ResNetFPNConfig()
    # coarse/fine feature resolutions (1/8, 1/2 of input)
    resolution: Tuple[int, int] = (8, 2)
    positional_encoding: bool = True
    pos_emb_shape: Tuple[int, int] = (256, 256)
    pe_temp_bug_fix: bool = False  # released weights use the pre-fix PE
    keypoints_encoding: KeypointEncodingConfig = KeypointEncodingConfig()
    coarse: TransformerConfig = TransformerConfig(d_model=256, nhead=8, layer_iter_n=3)
    coarse_matching: CoarseMatchingConfig = CoarseMatchingConfig()
    fine: FineConfig = FineConfig()


@dataclasses.dataclass(frozen=True)
class LoFTRConfig:
    """The image-pair detector-free matcher (LoFTR submodule replacement)."""

    compute_dtype: str = "float32"
    backbone: ResNetFPNConfig = ResNetFPNConfig()
    resolution: Tuple[int, int] = (8, 2)
    pe_temp_bug_fix: bool = False
    coarse: TransformerConfig = TransformerConfig(d_model=256, nhead=8, layer_iter_n=4)
    coarse_matching: CoarseMatchingConfig = CoarseMatchingConfig(
        thr=0.2, temperature=0.1, border_rm=2, border_two_sided=True, max_matches=1024
    )
    fine_window_size: int = 9
    fine: TransformerConfig = TransformerConfig(d_model=128, nhead=8, layer_iter_n=1)
