"""Batched least-squares solvers (port of
``onepose_plus_plus_tpu/geometry/levenberg_marquardt.py``): the SfM depth
refinement's ``lm_solve_scalar`` and ``first_order_solve``, and the
D-parameter ``lm_solve`` of the extrinsics refinement (``bundle_adjust.py``).

The reference refines one scalar depth per track with poses fixed (DeepLM,
``optimize_procedure=["depth"]``), so the problem splits into thousands of
independent one-parameter least squares, solved here all at once.
``residual_fn(x [B], *args) -> [B, R]`` is batched over problems; each
problem's residuals depend on its own x only, so the derivative dr/dx of
every problem comes in one pass: from the residual's closed form where it
carries one (``residual_fn.with_derivative(x, *args) -> (r, dr/dx)``, as
``residuals.depth_residual_track`` does), else from one forward-mode product
with a tangent of ones (``torch.func.jvp``), where the JAX package vmaps
``jax.jacfwd``. (The first ``jvp`` of a process pays a set-up of seconds.)

``lm_solve`` solves B problems of D parameters the same way, with Jacobians
[B, R, D] from the residual's closed form where it carries one, else D
forward-mode products (one a parameter, tangents e_d for every problem).
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

_EPS = 1e-12


def _residual_and_jacobian(residual_fn: Callable, x: torch.Tensor, args: Sequence):
    """(r [B, R], dr/dx [B, R]) in one pass: closed form, else forward mode."""
    closed_form = getattr(residual_fn, "with_derivative", None)
    if closed_form is not None:
        return closed_form(x, *args)
    return torch.func.jvp(lambda d: residual_fn(d, *args), (x,), (torch.ones_like(x),))


def _cost(residual_fn: Callable, x: torch.Tensor, args: Sequence) -> torch.Tensor:
    r = residual_fn(x, *args)
    return 0.5 * (r * r).sum(dim=-1)


def lm_solve_scalar(
    residual_fn: Callable,
    x0: torch.Tensor,
    args: Sequence = (),
    max_iters: int = 20,
    lam0: float = 1e-3,
    rel_tol: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched scalar Levenberg-Marquardt: x0 [B] -> (x [B], cost [B]).

    Every problem runs the same fixed number of iterations (no host sync);
    delta = -J.r / (J.J (1 + lam)), accepted where it lowers the cost (lam
    x0.33) and rejected elsewhere (lam x3, clipped to [1e-10, 1e10]); a problem
    freezes once an accepted step changes its cost by less than ``rel_tol``.
    """
    x = x0
    cost = _cost(residual_fn, x, args)
    lam = torch.full_like(x0, lam0)
    done = torch.zeros_like(x0, dtype=torch.bool)
    for _ in range(max_iters):
        r, J = _residual_and_jacobian(residual_fn, x, args)
        jtj = (J * J).sum(dim=-1)
        g = (J * r).sum(dim=-1)
        x_new = x - g / (jtj * (1.0 + lam) + _EPS)
        new_cost = _cost(residual_fn, x_new, args)
        improved = (new_cost < cost) & ~done
        x = torch.where(improved, x_new, x)
        rel = (cost - new_cost).abs() / (cost + _EPS)
        cost = torch.where(improved, new_cost, cost)
        lam = torch.where(improved, lam * 0.33, lam * 3.0).clamp(1e-10, 1e10)
        done = done | (improved & (rel < rel_tol))
    return x, cost


def _residual_and_jacobian_nd(residual_fn: Callable, x: torch.Tensor, args: Sequence):
    """(r [B, R], J [B, R, D]): closed form, else one forward-mode pass a parameter."""
    closed_form = getattr(residual_fn, "with_derivative", None)
    if closed_form is not None:
        return closed_form(x, *args)
    cols = []
    for d in range(x.shape[1]):
        tangent = torch.zeros_like(x)
        tangent[:, d] = 1.0
        r, col = torch.func.jvp(lambda v: residual_fn(v, *args), (x,), (tangent,))
        cols.append(col)
    return r, torch.stack(cols, dim=-1)


def lm_solve(
    residual_fn: Callable,
    x0: torch.Tensor,
    args: Sequence = (),
    max_iters: int = 20,
    lam0: float = 1e-3,
    rel_tol: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Levenberg-Marquardt: x0 [B, D], residual_fn(x [B, D], *args) ->
    [B, R] -> (x [B, D], cost [B]).

    The JAX solver's step per problem: A = JtJ + lam diag(max(diag JtJ,
    1e-12)) + 1e-12 I, delta = -A^-1 Jt r (one batched solve), accepted where
    it lowers the cost (lam x0.33), else lam x3, clipped to [1e-10, 1e10]. JAX
    stops a problem's while loop once an accepted step changes its cost by
    less than ``rel_tol``; here every problem runs ``max_iters`` iterations
    and a finished one stays frozen, which gives the same result.
    """
    b, d = x0.shape
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    x = x0
    cost = _cost(residual_fn, x, args)
    lam = torch.full((b,), lam0, dtype=x0.dtype, device=x0.device)
    done = torch.zeros(b, dtype=torch.bool, device=x0.device)
    for _ in range(max_iters):
        r, J = _residual_and_jacobian_nd(residual_fn, x, args)
        jtj = J.transpose(-1, -2) @ J
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        damp = torch.diag_embed(jtj.diagonal(dim1=-2, dim2=-1).clamp_min(_EPS))
        A = jtj + lam[:, None, None] * damp + 1e-12 * eye
        # solve_ex: a singular system gives non-finite steps (rejected below), no host sync
        delta = -torch.linalg.solve_ex(A, g)[0]
        x_new = x + delta
        new_cost = _cost(residual_fn, x_new, args)
        improved = (new_cost < cost) & ~done
        rel = (cost - new_cost).abs() / (cost + _EPS)
        x = torch.where(improved[:, None], x_new, x)
        cost = torch.where(improved, new_cost, cost)
        lam = torch.where(improved, lam * 0.33, lam * 3.0).clamp(1e-10, 1e10)
        done = done | (improved & (rel < rel_tol))
    return x, cost


def first_order_solve(
    residual_fn: Callable,
    x0: torch.Tensor,
    args: Sequence = (),
    lr: float = 3e-2,
    max_iters: int = 1000,
    early_stop_rel: float = 1e-4,
    early_stop_after_frac: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adam on the summed 0.5 ||r||^2 (reference ``FirstOrderSolve``,
    ``first_order_solver.py:6-172``): lr 3e-2, at most 1000 steps, a global
    stop once the summed loss changes by less than 0.01 % after 20 % of the
    budget. Adam is optax's: b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, bias correction 1 - b^t with t counted from 1. Returns (x [B],
    cost [B]).
    """
    b1, b2, eps = 0.9, 0.999, 1e-8
    min_iter = int(max_iters * early_stop_after_frac)
    x = x0
    mu, nu = torch.zeros_like(x0), torch.zeros_like(x0)
    prev_total = _cost(residual_fn, x, args).sum()
    for it in range(max_iters):
        r, J = _residual_and_jacobian(residual_fn, x, args)
        g = (J * r).sum(dim=-1)  # d/dx of the summed 0.5 ||r||^2
        mu = b1 * mu + (1.0 - b1) * g
        nu = b2 * nu + (1.0 - b2) * g * g
        t = it + 1
        mu_hat = mu / (1.0 - b1 ** t)
        nu_hat = nu / (1.0 - b2 ** t)
        x_new = x - lr * mu_hat / (torch.sqrt(nu_hat) + eps)
        new_total = _cost(residual_fn, x_new, args).sum()
        rel = (prev_total - new_total).abs() / (prev_total + _EPS)
        x, prev_total = x_new, new_total
        # all problems stop together, and x never moves again: end the loop
        if it >= min_iter and bool(rel < early_stop_rel):
            break
    return x, _cost(residual_fn, x, args)
