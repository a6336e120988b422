"""Port parity of the optimizer: AdamW, the MultiStep schedule over optimizer
updates and gradient accumulation against optax as the JAX package builds
them (``train/train_step.py::make_optimizer``), and a JAX ``TrainState``
carried into the port with non-zero Adam moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from onepose_plus_plus_tpu.models.backbone import ResNetFPN_8_2 as JaxBackbone
from onepose_plus_plus_tpu.train.train_step import (
    TrainConfig as JaxTrainConfig,
    TrainState as JaxTrainState,
    make_lr_schedule as jax_lr_schedule,
    make_optimizer as jax_make_optimizer,
)
from onepose_plus_plus_tpu_torch.models.backbone import ResNetFPN_8_2
from onepose_plus_plus_tpu_torch.train.train_step import TrainConfig, accumulate_and_step, make_optimizer
from onepose_plus_plus_tpu_torch.utils.weights import load_jax_train_state, state_dict_from_jax
from test_torch_model import NARROW_BACKBONE, _perturbed

torch.set_num_threads(2)


@jax.jit
def _apply(state, grads):
    return state.apply_gradients(grads, state.batch_stats)


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(arrays["a"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(arrays["b"].copy()))


@pytest.mark.parametrize("warmup,clip", [(0, None), (3, 0.5)])
def test_optimizer_matches_optax(warmup, clip):
    """The same numpy gradients through optax (adamw + MultiSteps + the
    piecewise schedule, as the JAX package builds it) and through the port's
    AdamW + schedule + accumulation: parameters equal to 2e-6 across
    accumulation boundaries and both LR milestones (torch applies the decay
    and the Adam step in two roundings, optax in one: about an ulp of |p| ~ 1,
    1.2e-7, per update, over seven updates)."""
    rng = np.random.default_rng(6)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    kw = dict(grad_accum=2, milestones=(1, 2), warmup_steps=warmup, grad_clip=clip)
    lr, spe = 0.05, 2
    jcfg = JaxTrainConfig(**kw)
    tx = jax_make_optimizer(jcfg, jax_lr_schedule(jcfg, lr, spe))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    module = _Params(params)
    opt, sched = make_optimizer(module, TrainConfig(**kw), lr, spe)
    moved = []
    for step in range(14):  # 7 updates: crosses updates 2 and 4 (the milestones)
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        moved.append(accumulate_and_step(opt, [torch.from_numpy(g["a"]), torch.from_numpy(g["b"])], sched))
        np.testing.assert_allclose(module.a.detach().numpy(), np.asarray(jp["a"]), atol=2e-6)
        np.testing.assert_allclose(module.b.detach().numpy(), np.asarray(jp["b"]), atol=2e-6)
    assert moved == [False, True] * 7
    assert sched.last_epoch == 7
    assert opt.param_groups[0]["lr"] == pytest.approx(jax_lr_schedule(jcfg, lr, spe)(7))


def _jax_backbone_state(steps):
    """A JAX TrainState of the narrow backbone after ``steps`` micro-batches of
    numpy gradients (grad_accum 2), numpy leaves."""
    rng = np.random.default_rng(7)
    img = rng.random((2, 32, 32, 1)).astype(np.float32)
    jb = JaxBackbone(NARROW_BACKBONE)
    variables = _perturbed(jb.init(jax.random.PRNGKey(0), img))
    cfg = JaxTrainConfig(grad_accum=2, milestones=(1,))
    tx = jax_make_optimizer(cfg, jax_lr_schedule(cfg, 0.01, 1))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=variables["batch_stats"],
                           opt_state=tx.init(params), tx=tx)
    grads = [jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32), variables["params"])
             for _ in range(steps + 4)]
    for g in grads[:steps]:
        state = _apply(state, g)
    return jax.tree_util.tree_map(np.asarray, state), grads[steps:], cfg


def test_load_jax_train_state_continues_like_jax():
    """Start both packages from the same non-zero Adam moments and update count
    (past an LR milestone), apply the same gradients, and hold the parameters
    equal to 2e-6 (as above)."""
    state, more, cfg = _jax_backbone_state(4)
    assert np.abs(np.asarray(jax.tree_util.tree_leaves(state.opt_state.inner_opt_state[0].mu)[0])).max() > 0
    port = ResNetFPN_8_2(NARROW_BACKBONE)
    opt, sched = make_optimizer(port, TrainConfig(grad_accum=2, milestones=(1,)), 0.01, 1)
    assert load_jax_train_state(port, opt, sched, state) == 4
    assert opt.param_groups[0]["lr"] == pytest.approx(0.005)  # update 2 is past milestone 1
    names = [n for n, _ in port.named_parameters()]
    jstate = state
    for g in more:
        jstate = _apply(jstate, g)
        sd = state_dict_from_jax({"params": g})
        accumulate_and_step(opt, [sd[n] for n in names], sched)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jstate.params)})
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=2e-6, err_msg=n)


def test_load_jax_train_state_refuses_mid_accumulation():
    state, _, _ = _jax_backbone_state(3)
    port = ResNetFPN_8_2(NARROW_BACKBONE)
    opt, sched = make_optimizer(port, TrainConfig(grad_accum=2), 0.01, 1)
    with pytest.raises(ValueError, match="mid-accumulation"):
        load_jax_train_state(port, opt, sched, state)
