"""The port's page crops (``yomitoku_tpu_torch.ops.device_crop`` and
``ops.separable_resize``) against the JAX package's on the same inputs,
CPU, f32.

The host functions (the maps, the page padding) must be equal exactly;
the device samplers (the projective gather for lines, the separable
region program) within 5e-3 on the 0-255 scale of the jitted JAX
functions (sums in another order).  Then the route's own contracts:
identity-padded bucket lanes crop to black, a narrow canvas crops the
left slice of the full one bit for bit, the staged maps are cached per
device, the switches, and the page padded to 512 on its device."""

from functools import partial

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yomitoku_tpu.ops import device_crop as jdc
from yomitoku_tpu.ops import separable_resize as jsr
from yomitoku_tpu_torch.ops import device_crop as dc
from yomitoku_tpu_torch.ops import separable_resize as sr

TOL = 5e-3  # on the 0-255 scale

QUADS = [
    [[8, 6], [250, 6], [250, 30], [8, 30]],        # wide line
    [[10, 40], [60, 40], [60, 52], [10, 52]],      # short line
    [[300, 10], [330, 10], [330, 190], [300, 190]],  # vertical
    [[20, 80], [200, 92], [198, 120], [18, 108]],  # skewed
    [[40, 140], [260, 130], [262, 170], [44, 176]],  # perspective
    [[5, 190], [6, 190], [6, 191], [5, 191]],      # one pixel
    [[100, 60], [1100, 60], [1100, 75], [100, 75]],  # wider than the canvas
]
ALIGNED = [QUADS[i] for i in (0, 1, 2, 6)]


def text_page(h=220, w=1200, seed=0):
    rng = np.random.RandomState(seed)
    page = np.full((h, w, 3), 255, np.uint8)
    page[..., 2] = rng.randint(200, 256, (h, w))
    for i, y in enumerate(range(24, h, 28)):
        cv2.putText(page, f"LINE {i} abc 0123 XYZ", (10 + 7 * i, y),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 0, 0), 2)
    cv2.rectangle(page, (300, 10), (330, 190), (30, 90, 160), -1)
    return page


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a)) if dtype is None else \
        torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= tol, d.max()
    return d


# ---------------------------------------------------------------- host functions


@pytest.mark.parametrize("rot180", [False, True])
@pytest.mark.parametrize("out_hw", [(32, 800), (32, 32), (32, 400)])
def test_line_homographies_equal(out_hw, rot180):
    want = jdc.line_homographies(QUADS, out_hw, rot180=rot180)
    got = dc.line_homographies(QUADS, out_hw, rot180=rot180)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("hw,align", [((220, 1200), 512), ((512, 1024), 512),
                                      ((601, 899), 64), ((3, 5), 512)])
def test_pad_page_equal(hw, align):
    page = np.random.RandomState(1).randint(0, 256, hw + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(dc.pad_page(page, align), jdc.pad_page(page, align))


def test_region_mats_equal():
    regions = [(0, 0, 1280, 960), (3, 5, 70, 40), (0, 0, 1, 1), (17, 2, 640, 333)]
    for out_hw in ((640, 640), (64, 96)):
        for g, w in zip(dc.region_mats(regions, out_hw), jdc.region_mats(regions, out_hw)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- device samplers


_jit_lines = jax.jit(jdc.sample_lines, static_argnames=("out_hw", "flip_bgr", "supersample"))


@pytest.mark.parametrize("rot180", [False, True])
def test_sample_lines_matches_jax(rot180):
    """The projective gather on lines, a vertical one, skewed and
    perspective quads and the 180-degree retry maps."""
    page = dc.pad_page(text_page())
    mats, wh = dc.line_homographies(QUADS, (32, 800), rot180=rot180)
    want = _jit_lines(jnp.asarray(page), jnp.asarray(mats), jnp.asarray(wh), out_hw=(32, 800))
    got = dc.sample_lines(_t(page), _t(mats), _t(wh), out_hw=(32, 800))
    d = _close(got, want)
    assert d.mean() <= 1e-3
    assert float(got.max()) > 100  # content was sampled


def test_sample_lines_single_tap_and_bgr():
    page = dc.pad_page(text_page())
    mats, wh = dc.line_homographies(QUADS[:4], (32, 200))
    want = _jit_lines(jnp.asarray(page), jnp.asarray(mats), jnp.asarray(wh),
                      out_hw=(32, 200), flip_bgr=False, supersample=False)
    got = dc.sample_lines(_t(page), _t(mats), _t(wh), out_hw=(32, 200),
                          flip_bgr=False, supersample=False)
    _close(got, want)


@pytest.mark.parametrize("what,regions,out_hw,flip", [
    ("full_page_down", [(0, 0, 1200, 220)], (64, 352), False),
    ("full_page_up", [(0, 0, 300, 100)], (256, 640), False),
    ("tables", [(3, 5, 70, 40), (10, 10, 1100, 200), (0, 0, 33, 21), (0, 0, 1, 1),
                (600, 100, 1200, 220)], (64, 64), True),
])
def test_sample_regions_separable_matches_jax(what, regions, out_hw, flip):
    """The detector's full-page resize (both contraction orders), the
    table crops with a (1, 1) region and a remainder chunk (5 regions)."""
    page = dc.pad_page(text_page())
    mats, _ = dc.region_mats(regions, out_hw)
    run = jax.jit(partial(jsr.sample_regions_separable, out_hw=out_hw, flip_bgr=flip))
    want = run(jnp.asarray(page), jnp.asarray(mats))
    got = sr.sample_regions_separable(_t(page), _t(mats), out_hw, flip_bgr=flip)
    assert got.dtype == torch.float32
    _close(got, want)


# ---------------------------------------------------------------- the route's contracts


def test_identity_padded_bucket_crops_black():
    """The recognizer pads a batch to its bucket with identity maps and zero
    extents: the padded lanes crop to black, the real lines as alone."""
    page = dc.pad_page(text_page())
    mats, wh = dc.line_homographies(QUADS, (32, 800))
    pad = 8 - len(mats)
    mats_p = np.concatenate([mats, np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])
    wh_p = np.concatenate([wh, np.zeros((pad, 2), np.int32)])
    got = dc.sample_lines(_t(page), _t(mats_p), _t(wh_p), out_hw=(32, 800))
    assert float(got[len(mats):].abs().max()) == 0.0
    alone = dc.sample_lines(_t(page), _t(mats), _t(wh), out_hw=(32, 800))
    assert torch.equal(got[:len(mats)], alone)


def test_narrow_crop_is_left_slice_of_full_crop():
    page = dc.pad_page(text_page())
    quads = [QUADS[1], [[10, 60], [120, 60], [120, 72], [10, 72]]]
    mats, wh = dc.line_homographies(quads, (32, 800))
    assert int(wh[:, 0].max()) <= 400
    full = dc.sample_lines(_t(page), _t(mats), _t(wh), out_hw=(32, 800))
    narrow = dc.sample_lines(_t(page), _t(mats), _t(wh), out_hw=(32, 400))
    assert torch.equal(narrow, full[:, :, :400])


def test_staged_page_mat_cached_per_device():
    a = dc.staged_page_mat((960, 1280), (640, 640), "cpu")
    assert a is dc.staged_page_mat((960, 1280), (640, 640), torch.device("cpu"))
    np.testing.assert_array_equal(a.numpy(), dc.region_mats([(0, 0, 1280, 960)], (640, 640))[0])
    np.testing.assert_array_equal(a.numpy(), np.asarray(jdc.staged_page_mat((960, 1280),
                                                                            (640, 640))))
    other = dc.staged_page_mat((960, 1280), (640, 640), "meta")
    assert other is not a and other.device.type == "meta" and a.device.type == "cpu"


@pytest.mark.parametrize("host,dev,device,want", [
    (None, None, "cpu", False), (None, None, "cuda", True), (None, None, "cuda:1", True),
    ("1", None, "cuda", False), ("1", None, "cpu", False),
    (None, "1", "cpu", True), (None, "1", "cuda", True),
    ("1", "1", "cpu", False),  # the host switch wins, as in the JAX package
])
def test_device_crops_enabled(monkeypatch, host, dev, device, want):
    for name, value in (("YOMITOKU_TPU_HOST_CROPS", host), ("YOMITOKU_TPU_DEVICE_CROPS", dev)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert dc.device_crops_enabled(device) is want
    assert dc.device_crops_enabled(torch.device(device)) is want


@pytest.mark.parametrize("hw,align,padded", [((220, 1200), 512, (512, 1536)),
                                             ((512, 512), 512, (512, 512)),
                                             ((601, 899), 64, (640, 960))])
def test_device_page_padded_on_its_device(hw, align, padded):
    img = np.random.RandomState(2).randint(0, 256, hw + (3,)).astype(np.uint8)
    page = dc.DevicePage(img, "cpu", align=align)
    assert page.hw == hw and page.device == torch.device("cpu")
    assert page.dev.dtype == torch.uint8 and tuple(page.dev.shape) == padded + (3,)
    np.testing.assert_array_equal(page.dev.numpy(), dc.pad_page(img, align))
    assert dc.page_on(page, "cpu") is page.dev
    assert dc.lies_on(page, "cpu") and not dc.lies_on(page, "meta")
    with pytest.raises(ValueError, match="page lies on"):
        dc.page_on(page, "meta")
