"""The port's match figures (``utils/plotting.py``), drawn with cv2 and numpy.

Pixel equality with the JAX package's matplotlib figures is not the aim; the
geometry and the colours are: matplotlib's viridis table, the confidence
colour of each match line at both of its ends, lime points, yellow whiskers
with lime and red ends, the stated sizes, and no matplotlib import.
"""
import sys
import types

import numpy as np
import pytest

from onepose_plus_plus_tpu_torch.sfm import runner
from onepose_plus_plus_tpu_torch.utils import plotting


@pytest.fixture
def no_matplotlib(monkeypatch):
    for name in ("matplotlib", "matplotlib.pyplot", "matplotlib.cm"):
        monkeypatch.setitem(sys.modules, name, None)


def test_viridis_table_is_matplotlibs():
    mpl = pytest.importorskip("matplotlib")
    want = np.asarray(mpl.colormaps["viridis"](np.arange(256)))[:, :3] * 255
    assert plotting.VIRIDIS.shape == (256, 3) and plotting.VIRIDIS.dtype == np.uint8
    assert np.abs(plotting.VIRIDIS - want).max() <= 1.0
    # a float is indexed as matplotlib indexes it
    values = np.array([0.0, 0.2, 0.5, 0.999, 1.0])
    want = np.asarray(mpl.colormaps["viridis"](values))[:, :3] * 255
    assert np.abs(plotting.viridis(values).astype(float) - want).max() <= 1.0


def _pair(h0=64, w0=80, h1=56, w1=72, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((h0, w0)).astype(np.float32), rng.random((h1, w1, 1)).astype(np.float32)


@pytest.mark.parametrize("shapes", [(64, 80, 56, 72), (48, 48, 64, 40)])
def test_pair_figure_size_and_match_colours(shapes, no_matplotlib):
    """[max(H0, H1), W0 + gap + W1, 3] uint8; each match line carries its
    confidence colour at both ends (on the right image, shifted by W0 + gap),
    lime points lie under the lines, the left image is the first one in gray."""
    h0, w0, h1, w1 = shapes
    img0, img1 = _pair(h0, w0, h1, w1)
    k0 = np.array([[10.0, 10.0], [30.4, 40.0], [60.0, 20.0]])
    k1 = np.array([[20.0, 30.0], [5.0, 10.0], [35.0, 45.0]])
    conf = np.array([0.05, 0.5, 0.95])
    out = plotting.plot_image_pair_matches(img0, img1, k0, k1, mconf=conf)
    assert out.shape == (max(h0, h1), w0 + plotting.PAIR_GAP + w1, 3) and out.dtype == np.uint8
    colors = plotting.viridis(conf)
    for (x0, y0), (x1, y1), c in zip(k0, k1, colors):
        np.testing.assert_array_equal(out[int(round(y0)), int(round(x0))], c)
        np.testing.assert_array_equal(out[int(round(y1)), int(round(x1)) + w0 + plotting.PAIR_GAP], c)
        # a lime point beside each end, under the line
        assert (out[int(y0) - 2:int(y0) + 3, int(round(x0)) - 2:int(round(x0)) + 3] == plotting.LIME).all(-1).any()
    gray = out[h0 - 1, 0]
    assert gray[0] == gray[1] == gray[2]
    none = plotting.plot_image_pair_matches(img0, img1, np.zeros((0, 2)), np.zeros((0, 2)))
    assert (none[:, w0:w0 + plotting.PAIR_GAP] == 255).all()  # the white gap, crossed only by lines


def test_pair_figure_without_confidences_and_line_cap(no_matplotlib):
    img0, img1 = _pair()
    rng = np.random.default_rng(1)
    k0, k1 = rng.uniform(5, 50, (300, 2)), rng.uniform(5, 50, (300, 2))
    capped = plotting.plot_image_pair_matches(img0, img1, k0, k1, max_lines=3)
    first3 = plotting.plot_image_pair_matches(img0, img1, k0[:3], k1[:3])
    np.testing.assert_array_equal(capped, first3)  # only the first max_lines matches are drawn
    x0, y0 = np.round(k0[0]).astype(int)
    np.testing.assert_array_equal(capped[y0, x0], plotting.LIME)  # lime lines without confidences
    k0[1] = np.nan  # a non-finite match is left out, not an error
    plotting.plot_image_pair_matches(img0, img1, k0, k1, mconf=np.linspace(0, 1, 300))


def test_reprojection_figure(no_matplotlib):
    """[H + TITLE_ROWS, W, 3] uint8; a yellow whisker between a prediction
    (lime) and its projection (red), the title band white but for its text."""
    img = np.random.default_rng(2).random((64, 96, 1)).astype(np.float32)
    pred = np.array([[20.0, 20.0], [70.0, 40.0]])
    gt = np.array([[32.0, 20.0], [70.0, 52.0]])
    out = plotting.plot_reprojection_comparison(img, pred, gt, title="step 4")
    assert out.shape == (64 + plotting.TITLE_ROWS, 96, 3) and out.dtype == np.uint8
    t = plotting.TITLE_ROWS
    np.testing.assert_array_equal(out[20 + t, 20], plotting.LIME)
    np.testing.assert_array_equal(out[20 + t, 32], plotting.RED)
    np.testing.assert_array_equal(out[20 + t, 26], plotting.YELLOW)  # the whisker's middle
    np.testing.assert_array_equal(out[46 + t, 70], plotting.YELLOW)
    band = out[:t]
    assert (band == 255).mean() > 0.5 and (band != 255).any()  # white, with the title drawn
    empty = plotting.plot_reprojection_comparison(img, np.zeros((0, 2)), np.zeros((0, 2)))
    assert empty.shape == out.shape


def test_sfm_gallery_writes_pngs_without_matplotlib(tmp_path, no_matplotlib):
    import cv2

    rng = np.random.default_rng(3)
    images = {i: rng.random((48, 64)).astype(np.float32) for i in range(3)}
    scales = {i: np.array([2.0, 2.0], np.float32) for i in images}  # matches in original pixels
    raw = [types.SimpleNamespace(pair=(i, j), pts0=rng.uniform(0, 96, (n, 2)), pts1=rng.uniform(0, 96, (n, 2)),
                                 conf=rng.random(n)) for (i, j), n in (((0, 1), 5), ((0, 2), 9), ((1, 2), 2))]
    runner.save_match_gallery(raw, images, scales, str(tmp_path), {i: f"{i}.png" for i in images}, top_n=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["0_1.png", "0_2.png"]
    png = cv2.imread(str(tmp_path / "0_2.png"))
    assert png.shape == (48, 64 + plotting.PAIR_GAP + 64, 3)
