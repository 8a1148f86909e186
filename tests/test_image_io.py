"""PNG IO with the standard library (utils/image.py) and texture decode."""

import glob
import os
import sys

import numpy as np
import pytest

from physically_based_ray_tracer_tpu.utils import image

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(channels, tmp_path):
    rng = np.random.default_rng(channels)
    arr = rng.integers(0, 256, (19, 31, channels), dtype=np.uint8)
    assert np.array_equal(image.decode_png(image.encode_png(arr)), arr)
    if channels == 3:
        path = image.write_png(str(tmp_path / "x.png"), arr.astype(np.float32) / 255.0)
        np.testing.assert_array_equal(
            np.rint(image.read_image(path) * 255.0).astype(np.uint8), arr)


def test_reads_committed_goldens():
    """The goldens (written by another encoder, with adaptive filters)
    decode to what an independent decoder reads, where one is installed,
    and re-encode losslessly."""
    paths = sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.png")))
    assert paths
    try:
        from PIL import Image
    except ImportError:
        Image = None
    for p in paths:
        img = image.read_image(p)
        assert img.dtype == np.float32 and img.ndim == 3
        assert img.shape[-1] in (3, 4) and 0.0 <= img.min() <= img.max() <= 1.0
        u8 = np.rint(img * 255.0).astype(np.uint8)
        assert np.array_equal(image.decode_png(image.encode_png(u8)), u8)
        if Image is not None:
            ref = np.asarray(Image.open(p).convert("RGB"))
            assert np.array_equal(u8[..., :3], ref), p


def test_texture_decode_needs_pillow(monkeypatch):
    from physically_based_ray_tracer_tpu.models import textures

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        textures.decode_image_bytes(image.encode_png(
            np.zeros((2, 2, 3), np.uint8)))
    assert textures.load_texture("") is None
