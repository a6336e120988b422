"""Port parity: the backbone variants (``ResNetFPN_16_4``, ``ResNet18_C`` at
stages 2 and 3, Bottleneck blocks, ``build_backbone``) against the JAX
package on the same weights.

Weights are the JAX modules' init with BatchNorm statistics and scales
perturbed from a numpy seed (``port_helpers.perturbed``), carried by
``utils.weights.state_dict_from_jax``. Eval mode within 1e-4 (the stems
differ in form: space-to-depth in JAX, the direct conv in the port); one
train-mode forward compares outputs and the updated BatchNorm buffers.
"""
import jax
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.config import ResNetFPNConfig as JaxBackboneConfig
from onepose_plus_plus_tpu.models.backbone import (
    ResNet18_C as JaxResNet18C,
    ResNetFPN_8_2 as JaxFPN82,
    ResNetFPN_16_4 as JaxFPN164,
    build_backbone as jax_build_backbone,
)
from onepose_plus_plus_tpu.utils.checkpoint import convert_torch_state_dict
from onepose_plus_plus_tpu_torch.config import ResNetFPNConfig
from onepose_plus_plus_tpu_torch.models.backbone import (
    ResNet18_C,
    ResNetFPN_8_2,
    ResNetFPN_16_4,
    build_backbone,
)
from onepose_plus_plus_tpu_torch.utils.weights import load_jax_variables, random_state_dict, state_dict_from_jax
from port_helpers import perturbed, textured, to_port_config

torch.set_num_threads(2)

FPN164 = dict(initial_dim=32, block_dims=(32, 48, 64, 96))
TRUNK = dict(initial_dim=32, block_dims=(32, 48, 64))
# (name, JAX module factory, port module factory, JAX config kwargs)
CASES = {
    "fpn16_4-basic": (lambda c: JaxFPN164(c), lambda c: ResNetFPN_16_4(c), dict(FPN164)),
    "fpn16_4-bottleneck": (lambda c: JaxFPN164(c), lambda c: ResNetFPN_16_4(c),
                           dict(FPN164, block_type="bottleneck")),
    # the JAX class ignores quant_int8 (it never passes quant to a conv): so does the port's
    "fpn16_4-quant_int8": (lambda c: JaxFPN164(c), lambda c: ResNetFPN_16_4(c), dict(FPN164, quant_int8=True)),
    "c2-basic": (lambda c: JaxResNet18C(c, stage=2), lambda c: ResNet18_C(c, stage=2), dict(TRUNK)),
    "c2-bottleneck": (lambda c: JaxResNet18C(c, stage=2), lambda c: ResNet18_C(c, stage=2),
                      dict(TRUNK, block_type="bottleneck")),
    "c3-basic": (lambda c: JaxResNet18C(c, stage=3), lambda c: ResNet18_C(c, stage=3), dict(TRUNK)),
    "c3-bottleneck": (lambda c: JaxResNet18C(c, stage=3), lambda c: ResNet18_C(c, stage=3),
                      dict(TRUNK, block_type="bottleneck")),
}


def _img(n=2, size=64, seed=0):
    return textured(np.random.default_rng(seed), n, size)


def _pair(case):
    """(JAX module, its perturbed variables, port module with those weights)."""
    make_jax, make_port, kw = CASES[case]
    jcfg = JaxBackboneConfig(**kw)
    jm = make_jax(jcfg)
    variables = perturbed(jax.jit(lambda k, x: jm.init(k, x, train=False))(jax.random.PRNGKey(1), _img()))
    port = make_port(to_port_config(jcfg))
    load_jax_variables(port, variables)
    return jm, variables, port


def _outputs(out):
    return [np.asarray(o, np.float32) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("case", list(CASES))
def test_variant_eval_matches_jax(case):
    jm, variables, port = _pair(case)
    img = _img()
    want = _outputs(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, img))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(img))
    got = [t.numpy() for t in (got if isinstance(got, tuple) else (got,))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-4)


@pytest.mark.parametrize("case", ["fpn16_4-bottleneck", "c3-basic"])
def test_variant_train_forward_and_batchnorm_buffers_match_jax(case):
    """One train-mode forward: batch statistics in the outputs, and the running
    statistics flax's BatchNorm (momentum 0.9, biased variance) writes back.
    Batch statistics over as few as 32 values a channel (the 1/16 level of two
    64^2 frames) turn f32 summation-order differences into up to 3.5e-4 of
    outputs near 9 (relative norm 4.5e-5): held to 1e-4 of the largest value
    and 1e-4 in norm; buffers to 1e-4 of each tensor's largest entry."""
    jm, variables, port = _pair(case)
    img = _img(seed=3)
    out, updates = jm.apply(variables, img, train=True, mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(img))
    got = [t.numpy() for t in (got if isinstance(got, tuple) else (got,))]
    for g, w in zip(got, _outputs(out)):
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)
    want_buffers = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(np.asarray, updates["batch_stats"])})
    state = port.state_dict()
    assert want_buffers and all(k.endswith(("running_mean", "running_var")) for k in want_buffers)
    for name, want in want_buffers.items():
        np.testing.assert_allclose(state[name].numpy(), want.numpy(), atol=1e-4 * want.abs().max().item(),
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_variant_weight_trees_carry_both_ways(case):
    """Every JAX leaf lands on a port tensor of its shape and every port tensor
    has a JAX leaf (flax keeps no ``num_batches_tracked``); the JAX package's
    converter maps the port's state dict back onto the tree, strictly and
    exactly. ``random_state_dict`` fills the same tree."""
    _, variables, port = _pair(case)
    from_jax = state_dict_from_jax(variables)
    state = port.state_dict()
    assert set(from_jax) == {k for k in state if not k.endswith("num_batches_tracked")}
    for name, t in from_jax.items():
        assert tuple(t.shape) == tuple(state[name].shape), name
    back, report = convert_torch_state_dict(state, variables, strict=True)
    assert report["skipped"] == [] and report["missing"] == []
    flat = dict(jax.tree_util.tree_leaves_with_path({k: back[k] for k in variables}))
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        np.testing.assert_array_equal(np.asarray(flat[path]), leaf)
    assert port.load_state_dict(random_state_dict(port, seed=5), strict=True)


def test_build_backbone_registry_matches_jax():
    cfg = ResNetFPNConfig(**TRUNK)
    jcfg = JaxBackboneConfig(**TRUNK)
    for name, cls in (("ResNetFPN_8_2", ResNetFPN_8_2), ("resnetfpn_8_2", ResNetFPN_8_2),
                      ("ResNet18C2", ResNet18_C), ("resnet18c2", ResNet18_C),
                      ("ResNet18C3", ResNet18_C), ("resnet18c3", ResNet18_C)):
        port = build_backbone(name, cfg)
        assert type(port) is cls
        assert type(jax_build_backbone(name, jcfg)).__name__ == type(port).__name__
    for name in ("ResNetFPN_16_4", "resnetfpn_16_4"):
        assert type(build_backbone(name, ResNetFPNConfig(**FPN164))) is ResNetFPN_16_4
    assert build_backbone("ResNet18C2", cfg).layer2 is None
    assert build_backbone("ResNet18C3", cfg).layer2 is not None
    with pytest.raises(ValueError):
        build_backbone("ResNet50", cfg)
    with pytest.raises(ValueError):
        jax_build_backbone("ResNet50", jcfg)
    with pytest.raises(ValueError, match="4 block dims"):
        ResNetFPN_16_4(cfg)


def test_fpn8_2_bottleneck_raises_the_jax_fault():
    """The JAX package's ResNetFPN_8_2 passes ``quant=`` to every block and
    BottleneckBlock has no such field, so flax raises TypeError; the port
    raises a ValueError that says so instead of adding the feature."""
    jm = JaxFPN82(JaxBackboneConfig(**TRUNK, block_type="bottleneck"))
    with pytest.raises(TypeError, match="quant"):
        jm.init(jax.random.PRNGKey(0), _img(n=1, size=32))
    with pytest.raises(ValueError, match="Bottleneck"):
        ResNetFPN_8_2(ResNetFPNConfig(**TRUNK, block_type="bottleneck"))
