"""Batched RANSAC Perspective-n-Point with Gauss-Newton refinement (port of
``onepose_plus_plus_tpu/geometry/pnp.py``; reference native backends
pycolmap / ``cv2.solvePnPRansac``, ``src/utils/metric_utils.py:121-204``).

Every function takes leading batch dimensions written out ([B, H, ...] for
frames and hypotheses) in place of the JAX package's ``vmap``. Hypotheses per
sample: a 6-point DLT, two planar homography decompositions and the four
Grunert P3P solutions of the sample's first three points; all are ranked on a
random subset of valid correspondences (prescore), the best ``rescore_top``
are rescored on every point, and the winner is refined by Gauss-Newton on its
inliers. Sampling draws Gumbel keys from an explicit ``torch.Generator``;
``ransac_pnp_from_samples`` takes the sample indices from outside.

Port, not workaround: the smallest eigenvector is inverse iteration on a
batched ``torch.linalg.cholesky_ex`` factor (the JAX package unrolls a scalar
Cholesky for the TPU), and the Gauss-Newton Jacobian is written in closed
form (the JAX package differentiates the residual with ``jacfwd``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.matching import topk_stable
from .rotations import angle_axis_to_matrix, skew

_EPS = 1e-9


class PnPResult(NamedTuple):
    R: torch.Tensor  # [..., 3, 3] world->cam rotation
    t: torch.Tensor  # [..., 3]
    inliers: torch.Tensor  # [..., N] bool
    num_inliers: torch.Tensor  # [...] int32
    ok: torch.Tensor  # [...] bool


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((a * a).sum(dim=-1))


def _unit(a: torch.Tensor) -> torch.Tensor:
    return a / (_norm(a) + _EPS)[..., None]


def _det3(M: torch.Tensor) -> torch.Tensor:
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse via the adjugate (determinant floored at 1e-9)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() < _EPS, torch.full_like(det, _EPS), det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _orthogonalize(M: torch.Tensor) -> torch.Tensor:
    """Project onto SO(3) by Newton polar iteration X <- (X + X^-T) / 2."""
    det = _det3(M)
    sign = torch.sign(torch.where(det == 0, torch.ones_like(det), det))
    X = M * sign[..., None, None]
    norm = torch.sqrt((X * X).sum(dim=(-2, -1), keepdim=True) / 3.0)
    X = X / (norm + _EPS)
    for _ in range(4):
        X = 0.5 * (X + _inv3(X).transpose(-1, -2))
    return X


def _smallest_eigvec(AtA: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Smallest eigenvector of symmetric PSD [..., D, D] by shifted inverse
    iteration from the all-ones direction."""
    d = AtA.shape[-1]
    trace = AtA.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    shift = 1e-6 * (trace / d) + 1e-12
    eye = torch.eye(d, dtype=AtA.dtype, device=AtA.device)
    L, _ = torch.linalg.cholesky_ex(AtA + shift[..., None, None] * eye)
    v = torch.full(AtA.shape[:-1], 1.0 / d ** 0.5, dtype=AtA.dtype, device=AtA.device)
    for _ in range(iters):
        v = torch.cholesky_solve(v[..., None], L)[..., 0]
        v = v / (_norm(v) + _EPS)[..., None]
    return v


def _fit_pose_dlt(pts3d: torch.Tensor, pts2dn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R|t] by DLT from [..., S, 3] points and [..., S, 2] normalised coords."""
    X = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], dim=-1)  # [..., S, 4]
    zeros = torch.zeros_like(X)
    u, v = pts2dn[..., 0:1], pts2dn[..., 1:2]
    A = torch.cat(
        [torch.cat([X, zeros, -u * X], dim=-1), torch.cat([zeros, X, -v * X], dim=-1)], dim=-2
    )  # [..., 2S, 12]
    p = _smallest_eigvec(A.transpose(-1, -2) @ A).reshape(*A.shape[:-2], 3, 4)
    scale = (_det3(p[..., :3]).abs() + _EPS) ** (1.0 / 3.0)
    p = p / (scale + _EPS)[..., None, None]
    depth = (pts3d * p[..., 2:3, :3]).sum(dim=-1) + p[..., 2, 3:4]  # [..., S]
    sign = torch.where(torch.sign(depth).sum(dim=-1) >= 0, 1.0, -1.0).to(p.dtype)
    p = p * sign[..., None, None]
    return _orthogonalize(p[..., :3]), p[..., 3]


def _fit_pose_planar(pts3d: torch.Tensor, pts2dn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two [R|t] candidates for a (near-)coplanar sample: plane->image
    homography by DLT in an orthonormal plane frame, decomposed with both
    signs. Returns R [..., 2, 3, 3], t [..., 2, 3]."""
    c = pts3d.mean(dim=-2)
    M = pts3d - c[..., None, :]
    nrm = _unit(_smallest_eigvec(M.transpose(-1, -2) @ M))
    e1 = torch.nn.functional.one_hot(nrm.abs().argmin(dim=-1), 3).to(pts3d.dtype)
    e1 = _unit(e1 - _dot(e1, nrm)[..., None] * nrm)
    e2 = torch.linalg.cross(nrm, e1)
    p = torch.stack([(M * e1[..., None, :]).sum(-1), (M * e2[..., None, :]).sum(-1)], dim=-1)
    scale = torch.sqrt((p * p).sum(dim=-1).mean(dim=-1) + _EPS)
    p = p / scale[..., None, None]
    P1 = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)  # [..., S, 3]
    zeros3 = torch.zeros_like(P1)
    u, v = pts2dn[..., 0:1], pts2dn[..., 1:2]
    A = torch.cat(
        [torch.cat([P1, zeros3, -u * P1], dim=-1), torch.cat([zeros3, P1, -v * P1], dim=-1)],
        dim=-2,
    )
    H = _smallest_eigvec(A.transpose(-1, -2) @ A).reshape(*A.shape[:-2], 3, 3)
    H = torch.cat([H[..., :2] / scale[..., None, None], H[..., 2:]], dim=-1)
    h1, h2, h3 = H[..., 0], H[..., 1], H[..., 2]
    lam = 2.0 / (_norm(h1) + _norm(h2) + _EPS)
    a1, a2, a3 = lam[..., None] * h1, lam[..., None] * h2, lam[..., None] * h3
    B = torch.stack([e1, e2, nrm], dim=-1)  # world-plane basis (columns)

    def decomp(s1, s2, s3):
        r1 = _unit(s1)
        r2 = _unit(s2 - _dot(r1, s2)[..., None] * r1)
        Q = torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=-1)
        R = Q @ B.transpose(-1, -2)
        return R, s3 - (R @ c[..., None])[..., 0]

    Rp, tp = decomp(a1, a2, a3)
    Rm, tm = decomp(-a1, -a2, -a3)
    return torch.stack([Rp, Rm], dim=-3), torch.stack([tp, tm], dim=-2)


def _solve_quartic(c: torch.Tensor) -> torch.Tensor:
    """The four complex roots of c[...,0] x^4 + ... + c[...,4] (Ferrari, closed
    form, two Newton polish steps). Returns [..., 4]."""
    ctype = torch.complex64 if c.dtype == torch.float32 else torch.complex128
    c = c.to(ctype)

    def floor_abs(z, lo):
        return torch.where(z.abs() < lo, torch.full_like(z, lo), z)

    lead = floor_abs(c[..., 0], _EPS)
    a, b, cc, d = (c[..., i] / lead for i in range(1, 5))
    p = b - 3 * a * a / 8
    q = cc - a * b / 2 + a * a * a / 8
    r = d - a * cc / 4 + a * a * b / 16 - 3 * a ** 4 / 256
    # resolvent cubic 8 m^3 + 8 p m^2 + (2 p^2 - 8 r) m - q^2, Cardano
    A2, A1, A0 = (8 * p) / 8, (2 * p * p - 8 * r) / 8, (-q * q) / 8
    P = A1 - A2 * A2 / 3
    Q = 2 * A2 ** 3 / 27 - A2 * A1 / 3 + A0
    disc = torch.sqrt(Q * Q / 4 + P ** 3 / 27)
    u1 = torch.exp(torch.log(floor_abs(-Q / 2 + disc, 1e-30)) / 3)
    w = torch.tensor(-0.5 + 0.8660254037844386j, dtype=ctype, device=c.device)
    us = floor_abs(torch.stack([u1, u1 * w, u1 * w * w], dim=-1), 1e-30)
    ms = us - P[..., None] / (3 * us) - A2[..., None] / 3
    m = torch.gather(ms, -1, ms.abs().argmax(dim=-1, keepdim=True))[..., 0]
    s = floor_abs(torch.sqrt(2 * m), _EPS)
    t0 = p / 2 + m
    d1 = torch.sqrt(s * s / 4 - (t0 - q / (2 * s)))
    d2 = torch.sqrt(s * s / 4 - (t0 + q / (2 * s)))
    roots = torch.stack([-s / 2 + d1, -s / 2 - d1, s / 2 + d2, s / 2 - d2], dim=-1) - a[..., None] / 4
    a, b, cc, d = (t[..., None] for t in (a, b, cc, d))
    for _ in range(2):
        f = (((roots + a) * roots + b) * roots + cc) * roots + d
        df = floor_abs(((4 * roots + 3 * a) * roots + 2 * b) * roots + cc, _EPS)
        roots = roots - f / df
    return roots


def _pmul(x, y):
    """Product of polynomials given as lists of ascending coefficients."""
    out = [0.0] * (len(x) + len(y) - 1)
    for i in range(len(x)):
        for j in range(len(y)):
            out[i + j] = out[i + j] + x[i] * y[j]
    return out


def _triad(pts: torch.Tensor) -> torch.Tensor:
    """Orthonormal frame (columns) spanned by the 3 points [..., 3, 3]."""
    e1 = _unit(pts[..., 1, :] - pts[..., 0, :])
    d2 = pts[..., 2, :] - pts[..., 0, :]
    e2 = _unit(d2 - _dot(e1, d2)[..., None] * e1)
    return torch.stack([e1, e2, torch.linalg.cross(e1, e2)], dim=-1)


def _align_three(src: torch.Tensor, dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rigid R, t with R @ src + t == dst for congruent 3-point sets."""
    R = _triad(dst) @ _triad(src).transpose(-1, -2)
    t = dst.mean(dim=-2) - (R @ src.mean(dim=-2)[..., None])[..., 0]
    return R, t


def _fit_pose_p3p(pts3d: torch.Tensor, pts2dn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grunert's P3P on [..., 3, 3] points / [..., 3, 2] coords: R [..., 4, 3, 3],
    t [..., 4, 3]; non-physical roots give NaN poses."""
    f = torch.cat([pts2dn, torch.ones_like(pts2dn[..., :1])], dim=-1)
    f = f / _norm(f)[..., None]  # unit bearings
    P1, P2, P3 = pts3d[..., 0, :], pts3d[..., 1, :], pts3d[..., 2, :]
    a2 = ((P2 - P3) ** 2).sum(-1)
    b2 = ((P1 - P3) ** 2).sum(-1).clamp_min(_EPS)
    c2 = ((P1 - P2) ** 2).sum(-1)
    cos_al = _dot(f[..., 1, :], f[..., 2, :])
    cos_be = _dot(f[..., 0, :], f[..., 2, :])
    cos_ga = _dot(f[..., 0, :], f[..., 1, :])
    A, B = a2 / b2, c2 / b2
    N = [A - B + 1, -2 * (A - B) * cos_be, A - B - 1]
    D = [2 * cos_ga, -2 * cos_al]
    Q = [1 - B, 2 * B * cos_be, -B]
    coeffs = [x + y for x, y in zip(_pmul(Q, _pmul(D, D)), _pmul(N, N))]
    nd = _pmul(N, D)
    coeffs = [coeffs[i] + (-2 * cos_ga * nd[i] if i < 4 else 0.0) for i in range(5)]
    roots = _solve_quartic(torch.stack(coeffs[::-1], dim=-1))  # [..., 4]

    vr = roots.real
    ok = (roots.imag.abs() < 1e-4 * (1 + vr.abs())) & (vr > _EPS)
    nan = torch.full_like(vr, float("nan"))
    vr = torch.where(ok, vr, nan)
    ex = lambda t: t[..., None]  # noqa: E731  broadcast a per-sample scalar over roots
    Dv = ex(D[1]) * vr + ex(D[0])
    Dv = torch.where(Dv.abs() < _EPS, nan, Dv)
    ur = ((ex(N[2]) * vr + ex(N[1])) * vr + ex(N[0])) / Dv
    cal, cbe, cga, A_, B_ = map(ex, (cos_al, cos_be, cos_ga, A, B))
    for _ in range(2):
        g1 = ur * ur + vr * vr - 2 * ur * vr * cal - A_ * (1 + vr * vr - 2 * vr * cbe)
        g2 = 1 + ur * ur - 2 * ur * cga - B_ * (1 + vr * vr - 2 * vr * cbe)
        j11 = 2 * ur - 2 * vr * cal
        j12 = 2 * vr - 2 * ur * cal - A_ * (2 * vr - 2 * cbe)
        j21 = 2 * ur - 2 * cga
        j22 = -B_ * (2 * vr - 2 * cbe)
        det = j11 * j22 - j12 * j21
        det = torch.where(det.abs() < _EPS, nan, det)
        ur, vr = ur - (g1 * j22 - g2 * j12) / det, vr - (g2 * j11 - g1 * j21) / det
    s1 = torch.sqrt(ex(b2) / (1 + vr * vr - 2 * vr * cbe).clamp_min(_EPS))
    s1 = torch.where(ur > _EPS, s1, nan)
    cam = torch.stack([s1, ur * s1, vr * s1], dim=-1)[..., None] * f[..., None, :, :]
    return _align_three(pts3d[..., None, :, :].expand_as(cam), cam)


def _reproj_errors(R, t, pts3d, pts2dn) -> torch.Tensor:
    """Squared reprojection error in normalised coords [..., N]; inf behind the camera."""
    pc = pts3d @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2:3]
    uv = pc[..., :2] / torch.where(z.abs() < _EPS, torch.full_like(z, _EPS), z)
    err = ((uv - pts2dn) ** 2).sum(dim=-1)
    return torch.where(pc[..., 2] > _EPS, err, torch.full_like(err, float("inf")))


def _residual(R, t, pts3d, pts2dn, weights):
    pc = pts3d @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2:3]
    zg = torch.where(z.abs() < _EPS, torch.full_like(z, _EPS), z)
    return (pc[..., :2] / zg - pts2dn) * weights[..., None], pc, zg, z.abs() >= _EPS


def _gauss_newton_refine(R0, t0, pts3d, pts2dn, weights, iters: int = 10):
    """Fixed-iteration Gauss-Newton on se(3) (left angle-axis increment) of the
    weighted normalised reprojection error; a step is kept only if it lowers
    the cost. R0 [..., 3, 3], t0 [..., 3], pts [..., N, *], weights [..., N]."""
    R, t = R0, t0
    eye6 = torch.eye(6, dtype=R0.dtype, device=R0.device)
    for _ in range(iters):
        r, pc, zg, active = _residual(R, t, pts3d, pts2dn, weights)
        x, y, z = pc[..., 0:1], pc[..., 1:2], zg
        zero = torch.zeros_like(x)
        inv_z = 1.0 / z
        dz = active.to(z.dtype)
        duv_dpc = torch.stack(
            [torch.cat([inv_z, zero, -x * inv_z * inv_z * dz], -1),
             torch.cat([zero, inv_z, -y * inv_z * inv_z * dz], -1)],
            dim=-2,
        )  # [..., N, 2, 3]
        # d(exp([aa]x) R X + t)/d aa at aa = 0 is -[R X]x; d/dt is I
        neg_rot = -skew(pc - t[..., None, :])
        dpc = torch.cat([neg_rot, torch.eye(3, dtype=R.dtype, device=R.device).expand_as(neg_rot)], -1)
        J = (duv_dpc @ dpc) * weights[..., None, None]  # [..., N, 2, 6]
        J = J.reshape(*J.shape[:-3], -1, 6)
        rf = r.reshape(*r.shape[:-2], -1)
        JtJ = J.transpose(-1, -2) @ J + 1e-6 * eye6
        g = (J.transpose(-1, -2) @ rf[..., None])[..., 0]
        delta = -torch.linalg.solve(JtJ, g)
        new_R = angle_axis_to_matrix(delta[..., :3]) @ R
        new_t = t + delta[..., 3:]
        new_r = _residual(new_R, new_t, pts3d, pts2dn, weights)[0]
        improved = (new_r ** 2).sum(dim=(-2, -1)) <= (r ** 2).sum(dim=(-2, -1))
        R = torch.where(improved[..., None, None], new_R, R)
        t = torch.where(improved[..., None], new_t, t)
    return R, t


def _gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, D], idx [B, ...] -> [B, ..., D]."""
    b, d = x.shape[0], x.shape[-1]
    flat = idx.reshape(b, -1)
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, d))
    return out.reshape(*idx.shape, d)


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_hypotheses(
    valid: torch.Tensor,
    generator: torch.Generator,
    num_hypotheses: int = 512,
    sample_size: int = 6,
    prescore_subset: int = 128,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Gumbel top-k sampling over the valid slots of each frame.

    Returns sample indices [B, H, S] (distinct valid slots per hypothesis,
    drawn as S rounds of masked argmax) and the prescore subset [B, n_sub]
    (None when ``prescore_subset`` is 0 or not below N).
    """
    b, n = valid.shape
    scores = torch.where(valid[:, None, :], _gumbel((b, num_hypotheses, n), generator, valid.device),
                         torch.full((), float("-inf"), device=valid.device))
    idxs = []
    for _ in range(sample_size):
        i = scores.argmax(dim=-1)  # [B, H]
        idxs.append(i)
        scores = scores.scatter(-1, i[..., None], float("-inf"))
    sub_idx = None
    if prescore_subset and prescore_subset < n:
        gs = torch.where(valid, _gumbel((b, n), generator, valid.device),
                         torch.full((), float("-inf"), device=valid.device))
        sub_idx = topk_stable(gs, prescore_subset)[1]
    return torch.stack(idxs, dim=-1), sub_idx


def ransac_pnp_from_samples(
    pts3d: torch.Tensor,
    pts2d: torch.Tensor,
    K: torch.Tensor,
    valid: torch.Tensor,
    sample_idx: torch.Tensor,
    sub_idx: Optional[torch.Tensor],
    reproj_threshold_px: float = 3.3,
    refine_iters: int = 10,
    planar_hypotheses: bool = True,
    p3p_hypotheses: bool = True,
    p3p_samples: int = 128,
    min_inliers: int = 4,
    rescore_top: int = 64,
) -> PnPResult:
    """RANSAC PnP over frames with the samples given: pts3d [B, N, 3],
    pts2d [B, N, 2] pixels, K [B, 3, 3], valid [B, N], sample_idx [B, H, S],
    sub_idx [B, n_sub] or None (score every hypothesis on every point)."""
    b, n = valid.shape
    h = sample_idx.shape[1]
    fx, fy, cx, cy = K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]
    pts2dn = torch.stack(
        [(pts2d[..., 0] - cx[:, None]) / fx[:, None], (pts2d[..., 1] - cy[:, None]) / fy[:, None]],
        dim=-1,
    )
    thr2 = (reproj_threshold_px / (0.5 * (fx + fy))) ** 2  # [B]

    samp3d = _gather_points(pts3d, sample_idx)  # [B, H, S, 3]
    samp2dn = _gather_points(pts2dn, sample_idx)
    Rh, th = _fit_pose_dlt(samp3d, samp2dn)  # [B, H, 3, 3], [B, H, 3]
    Rs, ts = [Rh], [th]
    if planar_hypotheses:
        Rpl, tpl = _fit_pose_planar(samp3d, samp2dn)  # [B, H, 2, ...]
        Rs.append(Rpl.reshape(b, 2 * h, 3, 3))
        ts.append(tpl.reshape(b, 2 * h, 3))
    if p3p_hypotheses:
        h3 = min(p3p_samples, h) if p3p_samples else h
        Rp3, tp3 = _fit_pose_p3p(samp3d[:, :h3, :3], samp2dn[:, :h3, :3])  # [B, h3, 4, ...]
        Rs.append(Rp3.reshape(b, 4 * h3, 3, 3))
        ts.append(tp3.reshape(b, 4 * h3, 3))
    Rh, th = torch.cat(Rs, dim=1), torch.cat(ts, dim=1)
    finite = torch.isfinite(Rh).all(dim=-1).all(dim=-1) & torch.isfinite(th).all(dim=-1)

    if sub_idx is not None:
        # stage 1: rank every candidate on the random valid subset
        sub_valid = torch.gather(valid, 1, sub_idx)
        errs_sub = _reproj_errors(Rh, th, _gather_points(pts3d, sub_idx)[:, None],
                                  _gather_points(pts2dn, sub_idx)[:, None])
        cnt_sub = ((errs_sub <= thr2[:, None, None]) & sub_valid[:, None, :]).sum(dim=-1)
        cnt_sub = torch.where(finite, cnt_sub, torch.full_like(cnt_sub, -1))
        top_idx = topk_stable(cnt_sub, min(rescore_top, Rh.shape[1]))[1]
        Rh = torch.gather(Rh, 1, top_idx[..., None, None].expand(-1, -1, 3, 3))
        th = torch.gather(th, 1, top_idx[..., None].expand(-1, -1, 3))
        finite = torch.gather(finite, 1, top_idx)

    # stage 2: exact scoring of the surviving candidates
    errs = _reproj_errors(Rh, th, pts3d[:, None], pts2dn[:, None])  # [B, H', N]
    inl = (errs <= thr2[:, None, None]) & valid[:, None, :]
    counts = torch.where(finite, inl.sum(dim=-1), torch.full_like(inl[..., 0], -1, dtype=torch.long))
    best = counts.argmax(dim=-1)
    rows = torch.arange(b, device=best.device)
    R_ref, t_ref = _gauss_newton_refine(
        Rh[rows, best], th[rows, best], pts3d, pts2dn, inl[rows, best].to(pts3d.dtype),
        iters=refine_iters,
    )
    inl_ref = (_reproj_errors(R_ref, t_ref, pts3d, pts2dn) <= thr2[:, None]) & valid
    num = inl_ref.sum(dim=-1).to(torch.int32)
    ok = ((num >= min_inliers) & torch.isfinite(R_ref).all(dim=-1).all(dim=-1)
          & torch.isfinite(t_ref).all(dim=-1))
    eye = torch.eye(3, dtype=pts3d.dtype, device=pts3d.device).expand_as(R_ref)
    R_out = torch.where(ok[:, None, None], R_ref, eye)
    t_out = torch.where(ok[:, None], t_ref, torch.zeros_like(t_ref))
    return PnPResult(R=R_out, t=t_out, inliers=inl_ref, num_inliers=num, ok=ok)


def ransac_pnp(
    pts3d: torch.Tensor,
    pts2d: torch.Tensor,
    K: torch.Tensor,
    valid: torch.Tensor,
    generator: torch.Generator,
    reproj_threshold_px: float = 3.3,
    num_hypotheses: int = 512,
    sample_size: int = 6,
    refine_iters: int = 10,
    planar_hypotheses: bool = True,
    p3p_hypotheses: bool = True,
    p3p_samples: int = 128,
    min_inliers: int = 4,
    prescore_subset: int = 128,
    rescore_top: int = 64,
) -> PnPResult:
    """Batched RANSAC PnP: pts3d [B, N, 3], pts2d [B, N, 2] pixels, K [B, 3, 3],
    valid [B, N]; ``generator`` lives on the tensors' device. Same options and
    semantics as the JAX ``ransac_pnp`` (pixel-space threshold with the mean
    focal, best hypothesis by inlier count, Gauss-Newton refinement, at least
    ``min_inliers`` inliers for ``ok``)."""
    sample_idx, sub_idx = sample_hypotheses(
        valid, generator, num_hypotheses, sample_size, prescore_subset
    )
    return ransac_pnp_from_samples(
        pts3d, pts2d, K, valid, sample_idx, sub_idx,
        reproj_threshold_px=reproj_threshold_px, refine_iters=refine_iters,
        planar_hypotheses=planar_hypotheses, p3p_hypotheses=p3p_hypotheses,
        p3p_samples=p3p_samples, min_inliers=min_inliers, rescore_top=rescore_top,
    )
