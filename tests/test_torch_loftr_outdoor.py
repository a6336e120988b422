"""LoFTR's outdoor model through the port's normal path against the plain
reference (``benchmark/reference/loftr_outdoor.py``), on the CPU.

Published widths (ResNet-FPN 128 / (128, 196, 256), coarse d 256 with 8
heads and 4 x (self, cross), fine d 128, window 5, the coarse features merged
into the fine windows), float32, seeded random weights in LoFTR's state-dict
names with the coarse projection centred as the benchmark centres it, at a
small size: two pairs of a 96 x 128 and a 128 x 96 view cut from one block
texture, which ``run_pairs`` pads to 128 x 128 with coarse masks. The
reference pads each view itself and keeps every mutual match. It runs at the
port's temperature, 0.1 + 1e-4 (the port divides by ``dsmax_temperature +
1e-4``, LoFTR by 0.1: the configuration's one noted departure, 0.1 % on the
logits, which moves these confidences by up to 8e-4), so that rounding alone
is left between the two.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import exact_fp32
from benchmark.reference.loftr_outdoor import LoFTROutdoor
from benchmark.weights import centre_coarse_descriptors, draw_state_dict
from onepose_plus_plus_tpu_torch.models.build import (
    loftr_config_from_dict,
    loftr_matcher_from_dict,
    make_loftr_match_fn,
)
from onepose_plus_plus_tpu_torch.sfm.coarse_match import run_pairs

torch.set_num_threads(2)

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "benchmark/configs/loftr_outdoor_ds.json").read_text())
PAIRS = [(0, 1), (2, 3)]


@pytest.fixture(scope="module")
def run():
    """The port's outputs through ``run_pairs`` (with its merged fine windows)
    and the reference's, pair by pair."""
    cfg = copy.deepcopy(CONFIG["model"])
    cfg["compute_dtype"] = "float32"
    cfg["match_coarse"]["max_matches"] = 256
    with torch.device("meta"):
        template = LoFTROutdoor(cfg).state_dict()
    weights = draw_state_dict(template, 5, "cpu")
    rng = np.random.default_rng(0)
    tex = np.kron(rng.random((40, 40)), np.ones((8, 8))).astype(np.float32)
    images = {0: tex[10:106, 20:148], 1: tex[14:142, 24:120], 2: tex[30:158, 12:108], 3: tex[26:122, 30:158]}
    ref_cfg = copy.deepcopy(cfg)
    ref_cfg["match_coarse"]["dsmax_temperature"] += 1e-4
    ref = LoFTROutdoor(ref_cfg).eval()
    ref.load_state_dict(weights)
    with exact_fp32():
        weights = centre_coarse_descriptors(weights, ref.backbone, torch.from_numpy(tex[None, :128, :128].copy()), 3.0)
    ref.load_state_dict(weights)
    model = loftr_matcher_from_dict(cfg).eval()
    model.load_state_dict(weights)
    kept = {}
    model.fine_preprocess.register_forward_hook(lambda mod, inp, out: kept.update(windows=out))
    match_fn = make_loftr_match_fn(model)

    def recording(*args):
        kept["res"] = match_fn(*args)
        return kept["res"]

    raw = run_pairs(recording, images, {i: np.ones(2) for i in images}, PAIRS, pair_batch=2)

    def padded(i):  # the reference's own padding: bottom-right zeros, the pixel mask downsampled by nearest
        im = torch.from_numpy(images[i])
        h, w = im.shape
        img, valid = torch.zeros(128, 128), torch.zeros(128, 128)
        img[:h, :w], valid[:h, :w] = im, 1.0
        mask = torch.nn.functional.interpolate(valid[None, None], scale_factor=1 / 8, mode="nearest")[0].bool()
        return img[None, ..., None], mask

    with torch.no_grad(), exact_fp32():
        refs = []
        for i, j in PAIRS:
            (img0, mask0), (img1, mask1) = padded(i), padded(j)
            refs.append(ref(img0, img1, mask0, mask1)[0])
    return raw, kept, refs, images


def _common(res, b, r):
    """Slots of the port and rows of the reference at the matches both found,
    and the two sets of matches (coarse cells in pixels)."""
    mask = res["match_mask"][b].numpy()
    slots = np.nonzero(mask)[0]
    port = {(*p, *q): s for p, q, s in zip(res["mkpts0_c"][b].numpy()[mask].astype(int).tolist(),
                                            res["mkpts1_c"][b].numpy()[mask].astype(int).tolist(), slots)}
    want = {(*p, *q): n for n, (p, q) in enumerate(zip(r["mkpts0_c"].numpy().astype(int).tolist(),
                                                        r["mkpts1_c"].numpy().astype(int).tolist()))}
    both = sorted(set(port) & set(want))
    return [port[k] for k in both], [want[k] for k in both], set(port), set(want)


def test_selected_matches_equal_the_references(run):
    """Every mutual match of the reference, none else: in float32 no
    confidence lies within rounding of the threshold or of its row's and
    column's runner-up here, so the two sets are equal."""
    raw, kept, refs, _ = run
    for b, r in enumerate(refs):
        _, _, port, want = _common(kept["res"], b, r)
        assert port == want and len(want) >= 8, (b, len(port), len(want))


def test_coarse_confidences_agree(run):
    """Confidences within 1e-5: float32 both sides, the port's factorised
    through K2's row and column log-sum-exps (plain version) where the
    reference takes the product of two softmaxes, and its linear attention
    summed in another order (K1's plain version)."""
    raw, kept, refs, _ = run
    for b, r in enumerate(refs):
        ps, rs, _, _ = _common(kept["res"], b, r)
        got = kept["res"]["mconf"][b].numpy()[ps]
        np.testing.assert_allclose(got, r["mconf"].numpy()[rs], atol=1e-5)


def test_merged_fine_windows_agree(run):
    """``merge_feat``'s output at the common matches within 1e-6 of the
    reference's relative to its norm: the same float32 products (windows by
    K3's gather against ``F.unfold``, the coarse features through
    ``down_proj``, concatenated and merged), summed in another order."""
    raw, kept, refs, _ = run
    w0, w1 = kept["windows"]
    for b, r in enumerate(refs):
        ps, rs, _, _ = _common(kept["res"], b, r)
        got = torch.cat([w0[b][ps], w1[b][ps]])
        want = torch.cat([r["win0"][rs], r["win1"][rs]])
        assert ((got - want).norm() / want.norm()).item() < 1e-6, b


def test_fine_positions_agree_and_stay_in_pixels_of_each_view(run):
    """Fine positions within 1e-3 px of the reference's (a softmax over
    correlations of the fine transformer's float32 outputs, its expectation
    times 2 px); ``run_pairs`` returns them, in each view's own pixels: the
    padding lies bottom-right, so every match lies inside its view."""
    raw, kept, refs, images = run
    for b, (r, pm) in enumerate(zip(refs, raw)):
        ps, rs, _, _ = _common(kept["res"], b, r)
        got = kept["res"]["mkpts1_f"][b].numpy()[ps]
        np.testing.assert_allclose(got, r["mkpts1_f"].numpy()[rs], atol=1e-3)
        i, j = pm.pair
        mask = kept["res"]["match_mask"][b].numpy()
        np.testing.assert_array_equal(pm.pts1, kept["res"]["mkpts1_f"][b].numpy()[mask])
        np.testing.assert_array_equal(pm.pts0, kept["res"]["mkpts0_f"][b].numpy()[mask])
        for pts, im in ((pm.pts0, images[i]), (pm.pts1, images[j])):
            assert (pts[:, 0] < im.shape[1]).all() and (pts[:, 1] < im.shape[0]).all()


def test_config_reads_window_slots_bug_fix_and_the_concat_option():
    cfg = loftr_config_from_dict(CONFIG["model"])
    assert (cfg.fine_window_size, cfg.coarse_matching.max_matches, cfg.pe_temp_bug_fix) == (
        5, CONFIG["model"]["match_coarse"]["max_matches"], True)
    model = loftr_matcher_from_dict(CONFIG["model"])
    names = [k for k in model.state_dict() if not k.endswith("num_batches_tracked")]
    assert len(names) == 194
    assert sorted(k for k in names if k.startswith("fine_preprocess.")) == [
        "fine_preprocess.down_proj.bias", "fine_preprocess.down_proj.weight",
        "fine_preprocess.merge_feat.bias", "fine_preprocess.merge_feat.weight"]
    assert loftr_matcher_from_dict({}).fine_preprocess is None
