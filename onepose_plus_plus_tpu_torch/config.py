"""Model configurations, shared with the JAX package.

The frozen dataclasses of ``onepose_plus_plus_tpu.config`` (a module that
loads no JAX) describe both packages' models; the port imports them from
here rather than keeping a copy.
"""
from onepose_plus_plus_tpu.config import (  # noqa: F401  (re-exported)
    CoarseMatchingConfig,
    FineConfig,
    KeypointEncodingConfig,
    OnePosePlusConfig,
    ResNetFPNConfig,
    TransformerConfig,
)
