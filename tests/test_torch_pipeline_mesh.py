"""Query inference over a data-parallel mesh (``run_inference(mesh=)``) on the
CPU: two spawned gloo ranks against one process, and against the JAX
package's ``run_inference`` on a two-device mesh.

The JAX package runs one program over the frame batch sharded on its mesh, so
a frame's result does not depend on the number of devices. In the port each
rank runs its rows of every padded batch (all of it where the world does not
divide ``frame_batch``), draws the RANSAC samples of the whole batch and keeps
its rows, and gathers every rank's rows once; every rank returns the whole
result.

- RANSAC samples: a frame's samples at world 2 are bitwise those of one
  process, over two draws of the same generator.
- The mock matcher (``torch_mock_matcher.TorchMockMatcher``, drawing the
  correspondences of the whole batch as the JAX mock traced on a mesh does):
  poses, inliers, ok, match counts and pose errors equal on every frame and
  on every rank, with a frame count that is not a multiple of
  ``frame_batch``, with ``frame_batch % world != 0`` (every rank runs the
  whole batch), without GT and without frames.
- A narrow real model (64^2 frames of a textured plane, weights carried from
  the JAX package by ``utils/weights.py``, an annotation of the model's own
  features): match and inlier counts equal per frame, poses within 1e-4
  (measured on the CPU: bitwise equal; a rank's smaller batch may block a
  convolution otherwise, hence no bitwise claim).
- Against the JAX package's mesh run on the same frames: poses within 0.5 deg
  / 1 cm of each other and pose errors within 0.5, the bounds of
  ``test_torch_pipeline.py`` (RANSAC draws come from ``jax.random`` there).

The ranks are spawned processes with a deadline of their own; this module
imports nothing of JAX at its top, so that they do not load it.
"""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from onepose_plus_plus_tpu_torch.geometry.pnp import sample_hypotheses
from onepose_plus_plus_tpu_torch.inference.pipeline import run_inference
from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel
from onepose_plus_plus_tpu_torch.parallel import mesh
from synthetic_scenes import make_scene
from torch_mock_matcher import TorchMockMatcher

WORLD, DEADLINE_S = 2, 180
# name: (frames, frame_batch, with GT)
MOCK_CASES = {"ragged": (6, 4, True), "replicated": (5, 3, True), "no_gt": (3, 2, False), "empty": (0, 4, True)}
MOCK_KW = dict(shape3d=512, reproj_threshold_px=3.0)
REAL_FRAMES, REAL_BATCH, REAL_IMG, REAL_POINTS = 4, 4, 64, 256
SAMPLE_ROWS, SAMPLE_SLOTS = 4, 64
FIELDS = ("poses", "num_inliers", "ok", "num_matches", "R_errs", "t_errs", "metrics")


def mock_case(name):
    """Frames, annotation and the mock's GT poses: frame f is seen at pose
    f % frame_batch, the pose the mock projects batch row f % frame_batch with."""
    n_frames, frame_batch, with_gt = MOCK_CASES[name]
    rng = np.random.default_rng(3)
    K, pts, Ts = make_scene(rng, n_views=frame_batch, n_pts=400)
    anno = {"keypoints3d": pts.astype(np.float32),
            "descriptors3d": rng.standard_normal((400, 8)).astype(np.float32)}
    frames = [{"image": np.zeros((64, 64), np.float32), "K": K.astype(np.float32),
               **({"pose_gt": Ts[f % frame_batch].astype(np.float32)} if with_gt else {})}
              for f in range(n_frames)]
    return frames, anno, [Ts[i] for i in range(frame_batch)], frame_batch


def _run_mock(name, m):
    frames, anno, gts, frame_batch = mock_case(name)
    return run_inference(TorchMockMatcher(gts, frame_batch=frame_batch), frames, anno, frame_batch=frame_batch,
                         mesh=m, device=torch.device("cpu"), **MOCK_KW)


def _run_real(out_dir, m):
    saved = torch.load(os.path.join(out_dir, "real.pt"), weights_only=False)
    model = OnePosePlusModel(saved["cfg"]).eval()
    model.load_state_dict(saved["state"])
    return run_inference(model, saved["frames"], saved["anno"], shape3d=REAL_POINTS, frame_batch=REAL_BATCH, mesh=m)


def _samples(m):
    """Two draws of one generator at [SAMPLE_ROWS, SAMPLE_SLOTS]: this
    process's rows of each (all rows in one process)."""
    valid = torch.from_numpy(np.random.default_rng(5).random((SAMPLE_ROWS, SAMPLE_SLOTS)) < 0.6)
    b = SAMPLE_ROWS // (m.world if m else 1)
    first = m.rank * b if m else 0
    gen = torch.Generator().manual_seed(7)
    return [sample_hypotheses(valid[first:first + b], gen, num_hypotheses=32, prescore_subset=16,
                              rows=(first, SAMPLE_ROWS)) for _ in range(2)]


def _fields(res):
    return {k: getattr(res, k) for k in FIELDS}


def _all_runs(out_dir, m):
    return {"samples": _samples(m), "real": _fields(_run_real(out_dir, m)),
            **{name: _fields(_run_mock(name, m)) for name in MOCK_CASES}}


def _rank(rank, init_method, out_dir):
    torch.set_num_threads(1)
    m = mesh.make_mesh("cpu", rank, WORLD, init_method)
    try:
        runs = _all_runs(out_dir, m)
        runs["group_kept"] = dist.is_initialized()  # the caller's group outlives run_inference
        torch.save(runs, os.path.join(out_dir, f"rank_{rank}.pt"))
    finally:
        mesh.release_mesh()


def _plane_views(angles_deg, img=REAL_IMG, seed=0):
    """A textured plane (z = 0, 1.2 m wide) filling [img, img] uint8 frames,
    seen from 1 m by a camera orbiting it, each view rendered through its
    plane-induced homography; returns the frames, K and world->camera poses."""
    import cv2

    rng = np.random.default_rng(seed)
    f = 500.0 * img / 512
    K = np.array([[f, 0, img / 2], [0, f, img / 2], [0, 0, 1.0]])
    tex = (np.kron(rng.random((12, 12)), np.ones((16, 16))) * 255).astype(np.uint8)
    S = np.array([[192 / 1.2, 0, 96], [0, 192 / 1.2, 96], [0, 0, 1.0]])  # plane metres -> texture pixels
    frames, poses = [], []
    for deg in angles_deg:
        a = np.deg2rad(deg)
        z = -np.array([np.sin(a), 0.0, -np.cos(a)])
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        T = np.eye(4)
        T[:3, :3] = np.stack([x, np.cross(z, x), z])
        T[:3, 3] = T[:3, :3] @ z
        H = K @ np.stack([T[:3, 0], T[:3, 1], T[:3, 3]], axis=1) @ np.linalg.inv(S)
        frames.append(cv2.warpPerspective(tex, H, (img, img)))
        poses.append(T)
    return np.stack(frames), K.astype(np.float32), np.stack(poses).astype(np.float32)


def _save_real_case(out_dir):
    """The narrow matcher's weights, drawn by the JAX package and carried
    into the port's state dict, and a plane scene whose annotation holds the
    model's own features at the points' projections in a reference view (so
    that random weights give real matches and poses), for every process."""
    import jax
    from port_helpers import to_port_config
    from test_torch_model import NARROW, _perturbed

    from onepose_plus_plus_tpu.models.onepose_plus import OnePosePlusModel as JaxModel
    from onepose_plus_plus_tpu_torch.models.onepose_plus import normalize_3d_keypoints
    from onepose_plus_plus_tpu_torch.models.position_encoding import sine_position_encoding
    from onepose_plus_plus_tpu_torch.utils.weights import state_dict_from_jax

    imgs, K, Ts = _plane_views([2.0 * i for i in range(REAL_FRAMES + 1)])
    jmodel = JaxModel(NARROW)
    init = {"query_image": imgs[:2, ..., None].astype(np.float32) / 255.0,
            "keypoints3d": np.zeros((2, REAL_POINTS, 3), np.float32),
            "descriptors3d": np.zeros((2, REAL_POINTS, 32), np.float32),
            "descriptors3d_coarse": np.zeros((2, REAL_POINTS, 64), np.float32)}
    variables = _perturbed(jax.jit(lambda k, b: jmodel.init(k, b, train=False))(jax.random.PRNGKey(0), init))
    cfg, state = to_port_config(NARROW), state_dict_from_jax(variables)
    model = OnePosePlusModel(cfg).eval()
    model.load_state_dict(state)
    pts = np.c_[np.random.default_rng(1).uniform(-0.45, 0.45, (REAL_POINTS, 2)), np.zeros(REAL_POINTS)]
    pc = pts @ Ts[0][:3, :3].T + Ts[0][:3, 3]
    uv = pc[:, :2] / pc[:, 2:3] @ K[:2, :2].T + K[:2, 2]
    with torch.no_grad():  # reference view 0: the backbone's 1/8 (with the sine PE) and 1/2 maps
        fc, ff = model.backbone(torch.from_numpy(imgs[:1, ..., None].astype(np.float32) / 255.0))
        fc = sine_position_encoding(fc, cfg.pe_temp_bug_fix)

        def at(fmap, stride):
            x, y = torch.from_numpy(np.clip(uv // stride, 0, REAL_IMG // stride - 1).astype(np.int64).T)
            return fmap[0, y, x].float()

        kp = torch.from_numpy(pts.astype(np.float32))
        coarse = at(fc, 8) - model.kpt_3d_pos_encoding.encoder(normalize_3d_keypoints(kp[None]))[0]
    anno = {"keypoints3d": kp.numpy(), "descriptors3d": at(ff, 2).numpy(), "descriptors3d_coarse": coarse.numpy()}
    frames = [{"image": imgs[f], "K": K, "pose_gt": Ts[f]} for f in range(1, REAL_FRAMES + 1)]
    torch.save({"cfg": cfg, "state": state, "frames": frames, "anno": anno}, os.path.join(out_dir, "real.pt"))


def _spawn(fn, out_dir):
    init = f"tcp://localhost:{mesh.free_port()}"
    ctx = torch.multiprocessing.start_processes(fn, args=(init, str(out_dir)), nprocs=WORLD, join=False,
                                                start_method="spawn")
    deadline = time.time() + DEADLINE_S
    while not ctx.join(timeout=max(1.0, deadline - time.time())):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish in {DEADLINE_S} s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ranks")
    _save_real_case(out)
    _spawn(_rank, out)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank
    try:
        one = _all_runs(out, None)
    finally:
        torch.set_num_threads(threads)
    return {"one": one, **{r: torch.load(out / f"rank_{r}.pt", weights_only=False) for r in range(WORLD)}}


def _assert_same(got, ref, poses_atol=0.0):
    for k in FIELDS:
        if ref[k] is None or k == "metrics":
            assert got[k] == ref[k], k
        elif k == "poses":
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=poses_atol)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            assert got[k].dtype == ref[k].dtype, k


def test_ransac_samples_do_not_depend_on_the_world(runs):
    one = runs["one"]["samples"]
    b = SAMPLE_ROWS // WORLD
    for r in range(WORLD):
        for (idx, sub), (idx1, sub1) in zip(runs[r]["samples"], one):
            assert torch.equal(idx, idx1[r * b:(r + 1) * b])
            assert torch.equal(sub, sub1[r * b:(r + 1) * b])
    # the two draws differ: the generator moved on by the whole batch's draw on every rank
    assert not torch.equal(one[0][0], one[1][0])


@pytest.mark.parametrize("case", list(MOCK_CASES))
def test_mock_matcher_two_ranks_equal_one_process(runs, case):
    n_frames, _, with_gt = MOCK_CASES[case]
    one = runs["one"][case]
    for r in range(WORLD):
        _assert_same(runs[r][case], one)
    assert one["poses"].shape == (n_frames, 4, 4) and one["num_matches"].shape == (n_frames,)
    if not with_gt:
        assert all(runs[r][case]["R_errs"] is None and runs[r][case]["metrics"] is None for r in range(WORLD))
    elif n_frames:  # mock matches are near-perfect
        assert one["ok"].all() and one["metrics"]["5cm@5degree"] == 1.0
        assert (one["num_matches"] == 128).all()


def test_real_model_two_ranks_match_one_process(runs):
    one = runs["one"]["real"]
    assert one["poses"].shape == (REAL_FRAMES, 4, 4)
    # the own-feature annotation gives real poses: 27-30 matches, 19-20 inliers a frame (on the CPU)
    assert one["ok"].all() and (one["num_inliers"] >= 10).all()
    for r in range(WORLD):
        _assert_same(runs[r]["real"], one, poses_atol=1e-4)


def test_process_group_stays_with_the_caller(runs):
    assert all(runs[r]["group_kept"] for r in range(WORLD))


def test_two_ranks_agree_with_the_jax_mesh_run(runs):
    import jax
    from test_inference import MockMatcherModel
    from test_torch_pipeline import _rot_err_deg

    from onepose_plus_plus_tpu.inference.pipeline import run_inference as jax_run_inference
    from onepose_plus_plus_tpu.parallel.mesh import make_mesh as jax_make_mesh

    frames, anno, gts, frame_batch = mock_case("ragged")
    ref = jax_run_inference(MockMatcherModel(gts), {}, frames, anno, frame_batch=frame_batch,
                            mesh=jax_make_mesh(jax.devices()[:WORLD]), **MOCK_KW)
    assert ref.ok.all()
    for r in range(WORLD):
        got = runs[r]["ragged"]
        assert got["poses"].shape == ref.poses.shape
        assert (_rot_err_deg(got["poses"][:, :3, :3], ref.poses[:, :3, :3]) < 0.5).all()
        assert (np.linalg.norm(got["poses"][:, :3, 3] - ref.poses[:, :3, 3], axis=-1) * 100 < 1.0).all()
        np.testing.assert_allclose(got["R_errs"], ref.R_errs, atol=0.5)
        np.testing.assert_array_equal(got["num_matches"], np.asarray(ref.num_matches))
