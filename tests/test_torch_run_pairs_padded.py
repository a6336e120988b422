"""``sfm.coarse_match.run_pairs`` on images of mixed shapes: each padded
bottom-right to one square with coarse masks (LoFTR's MegaDepth loader), the
masks passed to the match function, its fine positions read where it returns
them, and the ``matches`` and ``slots_full`` counts on the ``sfm.count``
span. Images of one shape take the path they always took."""
import numpy as np
import torch

from onepose_plus_plus_tpu_torch.models.build import loftr_config_from_dict, make_loftr_fns
from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher
from onepose_plus_plus_tpu_torch.sfm.coarse_match import pad_batch, run_pairs
from onepose_plus_plus_tpu_torch.utils import profiling
from onepose_plus_plus_tpu_torch.utils.weights import random_state_dict

torch.set_num_threads(2)

K = 6  # slots of the fake match function


def _fake_match_fn(calls, full_pairs=()):
    """A match function that records its arguments and matches slot k of row
    b at cell (k, b) of both images, every slot valid in ``full_pairs`` and
    the first three elsewhere; fine positions a quarter pixel on."""
    def fn(*args):
        calls.append(args)
        b = args[0].shape[0]
        k = np.arange(K, dtype=np.float32)
        mk = np.stack([np.broadcast_to(8.0 * k, (b, K)), np.broadcast_to(8.0 * np.arange(b)[:, None], (b, K))], -1)
        mask = np.zeros((b, K), bool)
        mask[:, :3] = True
        mask[list(full_pairs)] = True
        out = {"mkpts0_c": torch.from_numpy(mk.copy()), "mkpts1_c": torch.from_numpy(mk.copy()),
               "mconf": torch.from_numpy(np.full((b, K), 0.5, np.float32)), "match_mask": torch.from_numpy(mask)}
        if len(args) == 4:
            out["mkpts0_f"], out["mkpts1_f"] = out["mkpts0_c"], out["mkpts1_c"] + 0.25
        return out
    return fn


def _mixed_images():
    rng = np.random.default_rng(0)
    return {0: rng.random((24, 40), np.float32), 1: rng.random((40, 24), np.float32),
            2: rng.random((36, 36), np.float32)}


def test_pad_batch_pads_bottom_right_with_coarse_masks():
    ims = [np.ones((20, 40), np.float32), np.full((40, 17), 2.0, np.float32)]
    img, mask = pad_batch(ims, 40, 8)
    assert img.shape == (2, 40, 40, 1) and mask.shape == (2, 5, 5)
    assert (img[0, :20, :, 0] == 1).all() and (img[0, 20:] == 0).all()
    assert (img[1, :, :17, 0] == 2).all() and (img[1, :, 17:] == 0).all()
    assert mask[0, :3].all() and not mask[0, 3:].any()  # 20 rows: cells 0-2 hold pixels
    assert mask[1, :, :3].all() and not mask[1, :, 3:].any()  # 17 columns: cells 0-2 (16 is cell 2)


def test_mixed_shapes_are_padded_masked_and_read_at_fine_positions():
    images = _mixed_images()
    calls = []
    scales = {0: np.array([2.0, 2.0]), 1: np.ones(2), 2: np.array([0.5, 1.0])}
    raw = run_pairs(_fake_match_fn(calls), images, scales, [(0, 1), (1, 2), (0, 2)], pair_batch=2)
    assert len(calls) == 2 and all(len(c) == 4 for c in calls)
    img0, img1, mask0, mask1 = calls[0]
    assert img0.shape == img1.shape == (2, 40, 40, 1) and mask0.shape == (2, 5, 5)
    np.testing.assert_array_equal(img0[0, :24, :, 0], images[0])
    assert (img0[0, 24:] == 0).all() and mask0[0, :3].all() and not mask0[0, 3:].any()
    np.testing.assert_array_equal(img1[0, :, :24, 0], images[1])
    assert mask1[0, :, :3].all() and not mask1[0, :, 3:].any()
    # the tail batch repeats its last pair; each pair's matches at the fine positions, scaled
    assert [pm.pair for pm in raw] == [(0, 1), (1, 2), (0, 2)]
    k = 8.0 * np.arange(3)
    np.testing.assert_array_equal(raw[1].pts0, np.stack([k, np.full(3, 8.0)], -1) * scales[1])
    np.testing.assert_array_equal(raw[1].pts1, (np.stack([k, np.full(3, 8.0)], -1) + 0.25) * scales[2])


def test_uniform_shapes_take_the_unpadded_path_bitwise():
    """Images of one shape: two arguments, no padding and no mask, and the
    matches of ``match_coarse`` on the stacked images bit for bit."""
    model = LoFTRMatcher(loftr_config_from_dict({"match_coarse": {"thr": 0.0, "max_matches": 16}}))
    model.load_state_dict(random_state_dict(model, seed=1))
    model.eval()
    rng = np.random.default_rng(3)
    base = np.kron(rng.random((8, 8)), np.ones((8, 8))).astype(np.float32)
    images = {i: np.roll(base, 4 * i, axis=1) for i in range(3)}
    coarse_fn, _, _ = make_loftr_fns(model)
    calls = []

    def recording(*args):
        calls.append(args)
        return coarse_fn(*args)

    pairs = [(0, 1), (1, 2), (0, 2)]
    raw = run_pairs(recording, images, {i: np.ones(2) for i in images}, pairs, pair_batch=2)
    assert [len(c) for c in calls] == [2, 2]
    with torch.inference_mode():
        for s in range(0, 3, 2):
            chunk = pairs[s:s + 2]
            chunk = chunk + [chunk[-1]] * (2 - len(chunk))
            out = model.match_coarse(torch.from_numpy(np.stack([images[i] for i, _ in chunk]))[..., None],
                                     torch.from_numpy(np.stack([images[j] for _, j in chunk]))[..., None])
            for b, pm in enumerate(raw[s:s + 2]):
                m = out["match_mask"][b].numpy()
                np.testing.assert_array_equal(pm.pts0, out["mkpts0_c"][b].numpy()[m])
                np.testing.assert_array_equal(pm.pts1, out["mkpts1_c"][b].numpy()[m])
                np.testing.assert_array_equal(pm.conf, out["mconf"][b].numpy()[m])


def test_match_and_full_slot_counts_are_recorded():
    """``sfm.count``, after each batch's ``sfm.unpack``, counts the batch's
    valid matches and its pairs whose matches fill every slot, over the
    batch's real pairs (the tail's repeated pair left out); ``sfm.unpack``
    carries no count."""
    images = _mixed_images()
    profiling.spans(clear=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run_pairs(_fake_match_fn([], full_pairs=(1,)), images, {i: np.ones(2) for i in images},
                  [(0, 1), (1, 2), (0, 2)], pair_batch=2)
    spans = profiling.spans(clear=True)
    counted = [s.counts for s in sorted(spans, key=lambda s: s.id) if s.name == "sfm.count"]
    assert counted == [{"matches": 3 + K, "slots_full": 1}, {"matches": 3, "slots_full": 0}]
    assert [s.counts for s in spans if s.name == "sfm.unpack"] == [{}, {}]
    assert [s.name for s in sorted(spans, key=lambda s: s.id)] == ["run_pairs"] + ["sfm.pad", "sfm.unpack", "sfm.count"] * 2


def test_fine_refinement_names_mixed_shapes_before_any_call():
    """The refine surface takes no padding masks: ``run_fine_refinement`` on
    pairs whose images differ in shape raises a ValueError that names the
    shapes, before it calls the surface; pairs of one shape run as before."""
    import pytest
    from onepose_plus_plus_tpu_torch.sfm.post_optimization import RefinementPair, run_fine_refinement
    images = _mixed_images()
    calls = []

    def refine_fn(img0, img1, mk0, mk1, mask):
        calls.append(img0.shape)
        return {"mkpts1_f": torch.from_numpy(mk1)}

    pts = np.zeros((2, 2), np.float32)
    mixed = [RefinementPair((0, 1), pts, pts, np.arange(2))]
    with pytest.raises(ValueError, match=r"uniform image shapes.*\(24, 40\).*\(40, 24\)"):
        run_fine_refinement(refine_fn, images, mixed, match_capacity=4, pair_batch=2)
    assert calls == []
    images[3] = images[0].copy()
    out = run_fine_refinement(refine_fn, images, [RefinementPair((0, 3), pts, pts + 1, np.arange(2))],
                              match_capacity=4, pair_batch=2)
    assert calls == [(2, 24, 40, 1)] and np.array_equal(out[(0, 3)]["mkpts1_f"], pts + 1)
