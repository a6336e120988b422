"""Port parity: the sparse fine FPN (``fine.sparse_fpn``) and K6's vector widths.

``ResNetFPN_8_2.fine_windows`` runs the 1/2-level 3x3 pair only on each
match's halo patch (gathered by K6, whose plain version runs here) and must
give what the JAX package's ``fine_windows`` gives (its K6 in Pallas
interpret mode on the CPU, as ``tests/test_sparse_fine_fpn.py`` runs it) and
what the port's own dense windows give: windows 5 and 7, cells at every
corner, invalid slots, f32 within 2e-5 (the JAX test's tolerance); bf16
within two bf16 steps of the dense path and JAX's 5 % bound of JAX's. The sparse model forward keeps the
dense forward's match slots (``i_ids`` equal) and its fine outputs within
1e-3, on the port's side and against JAX's sparse forward; it makes one K6
call and no K3 call. The option reaches the model through the evaluation
CLI's and the bench's ordinary ``model.*`` overrides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.config import (
    CoarseMatchingConfig,
    FineConfig,
    KeypointEncodingConfig,
    OnePosePlusConfig,
    ResNetFPNConfig,
    TransformerConfig,
)
from onepose_plus_plus_tpu.models.backbone import ResNetFPN_8_2 as JaxBackbone
from onepose_plus_plus_tpu.models.onepose_plus import OnePosePlusModel as JaxModel
from onepose_plus_plus_tpu_torch import bench
from onepose_plus_plus_tpu_torch.inference.cli import CONFIGS_DIR
from onepose_plus_plus_tpu_torch.models import backbone as port_backbone, onepose_plus as port_model
from onepose_plus_plus_tpu_torch.models.backbone import ResNetFPN_8_2
from onepose_plus_plus_tpu_torch.models.build import build_onepose_model
from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel
from onepose_plus_plus_tpu_torch.kernels import vector_bytes
from onepose_plus_plus_tpu_torch.ops.window_gather import gather_windows_aligned
from onepose_plus_plus_tpu_torch.utils.config_loader import load_config
from onepose_plus_plus_tpu_torch.utils.weights import load_jax_variables
from port_helpers import perturbed, textured, to_port_config

torch.set_num_threads(2)

SMALL_BACKBONE = ResNetFPNConfig(initial_dim=16, block_dims=(16, 24, 32))  # the JAX test's widths


@pytest.fixture(scope="module")
def backbones():
    """The JAX test's set-up (``tests/test_sparse_fine_fpn.py:17-24``): its
    widths, JAX's init (f32 and bf16 modules share it), two uniform 64^2
    frames; and the port's backbones on the same weights. (The model-level
    tests below perturb BatchNorm; with perturbed statistics the windows reach
    ~14 and the f32 sums differ by up to 1.6e-6 of that.)"""
    img = np.random.default_rng(0).random((2, 64, 64, 1)).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(JaxBackbone(SMALL_BACKBONE).init)(jax.random.PRNGKey(0), img))
    out = {"img": img, "variables": variables}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32), ("bf16", jnp.bfloat16, torch.bfloat16)):
        port = ResNetFPN_8_2(to_port_config(SMALL_BACKBONE), dtype=tdt).eval()
        load_jax_variables(port, variables)
        out[name] = (JaxBackbone(SMALL_BACKBONE, dtype=jdt), port)
    return out


def _cell_ids(rng, h_c, w_c, k=12):
    ids = rng.integers(0, h_c * w_c, (2, k)).astype(np.int32)
    ids[0, :4] = [0, w_c - 1, (h_c - 1) * w_c, h_c * w_c - 1]  # every corner
    ids[1, -2:] = [-1, h_c * w_c + 3]  # invalid slots
    return ids


def _windows(backbones, name, window, seed):
    """(port sparse, port dense, JAX sparse) windows as float32 numpy."""
    jm, port = backbones[name]
    img, variables = backbones["img"], backbones["variables"]
    ids = _cell_ids(np.random.default_rng(seed), 8, 8)
    _, ctx = jm.apply(variables, img, method="coarse_and_ctx")
    want = jm.apply(variables, ctx, jnp.asarray(ids), (8, 8), 4, window, method="fine_windows")
    with torch.no_grad():
        coarse, pctx = port.coarse_and_ctx(torch.from_numpy(img))
        sparse = port.fine_windows(pctx, torch.from_numpy(ids), (8, 8), 4, window)
        dense_c, dense_f = port(torch.from_numpy(img))
        dense = gather_windows_aligned(dense_f, torch.from_numpy(ids), (8, 8), 4, window)
    assert torch.equal(coarse, dense_c)  # the coarse map is the dense path's own
    assert sparse.dtype == port.dtype and sparse.shape == (2, 12, window * window, 16)
    assert bool((sparse[1, -2:] == 0).all())
    return sparse.float().numpy(), dense.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("window", [5, 7])
def test_fine_windows_match_jax_and_the_dense_path(backbones, window):
    sparse, dense, want = _windows(backbones, "f32", window, seed=window)
    np.testing.assert_allclose(sparse, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(sparse, dense, rtol=0, atol=2e-5)


def test_fine_windows_bf16_match_jax_and_the_dense_path(backbones):
    """bf16: against the port's dense windows, the same convs on patches and on
    the map, within two bf16 steps (2^-7) of the windows' largest value (equal
    here); against JAX's bf16 sparse windows, which round the backbone in
    another framework (~1e-2 of the scale here), within the JAX package's own
    bf16 bound of 5 % of the scale (``tests/test_sparse_fine_fpn.py:113``)."""
    sparse, dense, want = _windows(backbones, "bf16", 5, seed=3)
    scale = np.abs(want).max()
    assert np.abs(sparse - dense).max() <= 2 ** -7 * scale
    assert np.abs(sparse - want).max() < 0.05 * scale


NARROW = OnePosePlusConfig(
    backbone=ResNetFPNConfig(initial_dim=32, block_dims=(32, 48, 64)),
    keypoints_encoding=KeypointEncodingConfig(descriptor_dim=64),
    coarse=TransformerConfig(d_model=64, nhead=8, layer_iter_n=3),
    coarse_matching=CoarseMatchingConfig(thr=0.0, max_matches=48),
    fine=FineConfig(d_model=32, transformer=TransformerConfig(d_model=32, nhead=8, layer_iter_n=1)),
)


def _with_sparse(cfg, sparse):
    return dataclasses.replace(cfg, fine=dataclasses.replace(cfg.fine, sparse_fpn=sparse))


@pytest.fixture(scope="module")
def model_outputs():
    """JAX's sparse forward and the port's dense and sparse forwards on the same
    weights: one textured 96^2 frame, 128 points, 48 slots."""
    rng = np.random.default_rng(7)
    batch = {
        "query_image": textured(rng, 1, 96),
        "keypoints3d": (rng.standard_normal((1, 128, 3)) * 0.1).astype(np.float32),
        "descriptors3d": rng.standard_normal((1, 128, 32)).astype(np.float32),
        "descriptors3d_coarse": rng.standard_normal((1, 128, 64)).astype(np.float32),
    }
    cfg = dataclasses.replace(
        NARROW, coarse_matching=dataclasses.replace(NARROW.coarse_matching, use_fused_kernel=False))
    jsparse = JaxModel(_with_sparse(cfg, True))
    variables = perturbed(jax.jit(lambda k, b: jsparse.init(k, b, train=False))(jax.random.PRNGKey(0), batch))
    ref = jax.jit(lambda v, b: jsparse.apply(v, b, train=False))(variables, batch)
    outs = {"jax_sparse": {k: np.asarray(v) for k, v in ref.items() if not isinstance(v, tuple)}}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for name, sparse in (("dense", None), ("sparse", True)):
        port = OnePosePlusModel(to_port_config(_with_sparse(cfg, sparse))).eval()
        load_jax_variables(port, variables)
        with torch.no_grad():
            outs[name] = {k: v.numpy() for k, v in port(tb).items() if torch.is_tensor(v)}
    return outs


@pytest.mark.parametrize("against", ["dense", "jax_sparse"])
def test_sparse_model_forward_matches(model_outputs, against):
    got, want = model_outputs["sparse"], model_outputs[against]
    assert want["match_mask"].sum() > 0
    np.testing.assert_array_equal(got["i_ids"], want["i_ids"])
    np.testing.assert_array_equal(got["j_ids"], want["j_ids"])
    np.testing.assert_allclose(got["mkpts_query_f"], want["mkpts_query_f"], atol=1e-3)
    np.testing.assert_allclose(got["expec_f"], want["expec_f"], atol=1e-3)


def test_sparse_route_makes_one_patch_gather_and_no_window_gather(monkeypatch):
    """The sparse route calls K6's wrapper once a forward and K3's never; the
    dense route the other way round. Off in training (``None`` means off)."""
    calls = {"K6": 0, "K3": 0}

    def counted(fn, key):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(port_backbone, "patch_gather", counted(port_backbone.patch_gather, "K6"))
    monkeypatch.setattr(port_model, "gather_windows_aligned", counted(port_model.gather_windows_aligned, "K3"))
    rng = np.random.default_rng(1)
    batch = {
        "query_image": torch.from_numpy(textured(rng, 2, 64)),
        "keypoints3d": torch.from_numpy(rng.uniform(-0.3, 0.3, (2, 64, 3)).astype(np.float32)),
        "descriptors3d": torch.from_numpy(rng.standard_normal((2, 64, 32)).astype(np.float32)),
        "descriptors3d_coarse": torch.from_numpy(rng.standard_normal((2, 64, 64)).astype(np.float32)),
        "gt_cell": torch.from_numpy(rng.integers(0, 64, (2, 64))),
    }
    cfg = dataclasses.replace(_with_sparse(to_port_config(NARROW), True),
                              coarse_matching=to_port_config(dataclasses.replace(
                                  NARROW.coarse_matching, train_max_matches=32, train_pad_num_gt_min=8)))
    model = OnePosePlusModel(cfg).eval()
    with torch.no_grad():
        model(batch)
    assert calls == {"K6": 1, "K3": 0}
    model.train()
    gen = torch.Generator().manual_seed(0)
    model(batch, generator=gen)
    assert calls == {"K6": 1, "K3": 1}
    model = OnePosePlusModel(_with_sparse(to_port_config(NARROW), None)).eval()
    with torch.no_grad():
        model(batch)
    assert calls == {"K6": 1, "K3": 2}


@pytest.mark.parametrize("row_bytes,pointers,want", [
    (512, (0, 4096), 16),  # bf16 C = 256 / f32 C = 128: 16-byte vectors
    (392, (0, 256), 8),  # bf16 C = 196 (the sparse FPN's pin map)
    (260, (0, 256), 4),  # bf16 C = 130
    (12, (0, 256), 4),  # f32 C = 3
    (512, (8, 256), 8),  # a map that starts 8 bytes past an alignment
    (512, (2, 256), 2),  # ... or 2 bytes: the 2-byte instance
    (394, (0, 256), 2),  # bf16 C = 197: an odd number of bf16 values, 2-byte vectors
])
def test_k6_vector_width(row_bytes, pointers, want):
    """The vector K3 and K4 pick at the pixels that took K6's vector instances
    before K6 became a span copy (16-byte chunks at any pixel)."""
    assert vector_bytes(row_bytes, *pointers) == want


def test_options_reach_the_model_through_the_cli_overrides(monkeypatch):
    """The evaluation CLI builds its model from the ``model`` block of its
    config (``inference/cli.py``), and the bench takes the same overrides: no
    new flag is needed for any option."""
    argv = ["+experiment=inference_onepose.yaml", "model.loftr_fine.sparse_fpn=true",
            "model.loftr_backbone.quant_int8=true", "model.keypoints_encoding.norm_method=layernorm"]
    model = build_onepose_model(dict(load_config(str(CONFIGS_DIR), argv)["model"]), device="cpu")
    assert model.cfg.fine.sparse_fpn is True and model.cfg.backbone.quant_int8
    assert model.backbone.conv1.quant and isinstance(model.kpt_3d_pos_encoding.encoder[1], torch.nn.LayerNorm)
    built = []
    monkeypatch.setattr(bench, "OnePosePlusModel", lambda cfg: built.append(cfg) or OnePosePlusModel(cfg))
    record = bench.main(batch=2, img=64, n_points=300, steps=1, device="cpu",
                        model_cfg=load_config(str(CONFIGS_DIR), ["model.loftr_fine.sparse_fpn=true"])["model"])
    assert built[0].fine.sparse_fpn is True and built[0].compute_dtype == "bfloat16"
    assert record["value"] > 0
