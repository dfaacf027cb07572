"""The port's JPEG decoder and encoder (nerf_fl_torch/data/jpeg.py) against
PIL (libjpeg-turbo), on the CPU.

  * the port's decode of PIL-written JPEGs equals PIL's
    ``open(...).convert("RGB")`` exactly (max |d| = 0): quality 50 / 75 /
    95 x 4:4:4 / 4:2:2 / 4:2:0 at 37 x 23, odd and tiny sizes, grayscale,
    restart markers every few blocks and every MCU row, 4:1:1, RGB kept
    without YCbCr (an Adobe marker), optimised Huffman tables, and codes
    whose length and magnitude bits pass the 16-bit lookahead;
  * progressive files (spectral selection, successive approximation, end
    of band runs) equal PIL's decode exactly as well, at every quality,
    subsampling and size above, with restart markers and optimised tables;
  * PIL's decode of the port's encoder output equals the port's decode of
    it exactly, and the encoder writes PIL's quality tables;
  * an arithmetic-coded frame raises, naming the file and its marker;
  * ``image_io.read_rgb`` reads PNGs and JPEGs by their first bytes.
"""
import io

import numpy as np
import pytest
from PIL import Image

from nerf_fl_torch.data import jpeg
from nerf_fl_torch.data.image_io import read_rgb


def _image(h, w, seed=0, noise=12.0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + y / 11.0),
                    128 + 90 * np.cos(x / 5.0 - y / 3.0), (x * y) % 256], -1)
    img = img + rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_jpeg(img, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _same(data: bytes):
    want = _pil_rgb(data)
    got = jpeg.decode_jpeg(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.array_equal(got, want), np.abs(got.astype(int) - want).max()


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_decode_matches_pil(quality, subsampling):
    _same(_pil_jpeg(_image(23, 37), quality=quality, subsampling=subsampling))


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (9, 17), (131, 100),
                                  (8, 8), (16, 40)])
def test_decode_matches_pil_at_odd_sizes(size):
    for sub in (0, 1, 2):
        _same(_pil_jpeg(_image(*size, seed=1), quality=80, subsampling=sub))


@pytest.mark.parametrize("kw", [
    {"restart_marker_blocks": 3}, {"restart_marker_rows": 1},
    {"subsampling": "4:1:1"}, {"keep_rgb": True}, {"optimize": True},
    {"quality": 100, "subsampling": 0}])
def test_decode_matches_pil_on_other_streams(kw):
    kw = {"quality": 75, **kw}
    _same(_pil_jpeg(_image(45, 61, seed=2, noise=40.0), **kw))


def test_decode_grayscale_spreads_to_rgb():
    data = _pil_jpeg(_image(23, 37)[..., 0], quality=75)
    _same(data)
    got = jpeg.decode_jpeg(data)
    assert (got[..., 0] == got[..., 1]).all() and \
        (got[..., 1] == got[..., 2]).all()


def test_long_codes_take_the_second_read():
    """At quality 100 with 4:4:4, noise gives AC codes and a checker of
    black and white 8 x 8 blocks DC differences (11-bit magnitudes) whose
    code and magnitude bits pass 16."""
    img = np.random.default_rng(3).integers(0, 256, (32, 48, 3)) \
        .astype(np.uint8)
    _same(_pil_jpeg(img, quality=100, subsampling=0))
    y, x = np.mgrid[0:32, 0:48]
    checker = (((y // 8) + (x // 8)) % 2 * 255).astype(np.uint8)
    _same(_pil_jpeg(np.dstack([checker] * 3), quality=100, subsampling=0))


@pytest.mark.parametrize("size", [(23, 37), (1, 1), (17, 9), (384, 384)])
def test_encoder_output_reads_the_same_in_pil(size):
    img = _image(*size, seed=4)
    data = jpeg.encode_jpeg(img)
    _same(data)
    # the quality tables PIL writes at 75, and a sane reconstruction
    qy, qc = jpeg.quality_tables(75)
    pil = _pil_jpeg(img, quality=75)
    assert qy.astype(np.uint8).tobytes() in pil
    assert qc.astype(np.uint8).tobytes() in pil
    if size[0] > 8:
        err = np.abs(jpeg.decode_jpeg(data).astype(int) - img).mean()
        ref = np.abs(_pil_rgb(pil).astype(int) - img).mean()
        assert err <= 1.05 * ref + 0.5, (err, ref)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_progressive_decode_matches_pil(quality, subsampling):
    for size in ((23, 37), (1, 1), (9, 17), (64, 64)):
        for kw in ({}, {"restart_marker_blocks": 2}, {"optimize": True}):
            _same(_pil_jpeg(_image(*size, seed=6, noise=30.0),
                            quality=quality, subsampling=subsampling,
                            progressive=True, **kw))
    _same(_pil_jpeg(_image(23, 37)[..., 0], progressive=True))


def test_unsupported_frames_raise_with_file_and_marker(tmp_path):
    data = _pil_jpeg(_image(16, 16))
    path = tmp_path / "arith.jpg"
    path.write_bytes(data.replace(b"\xff\xc0", b"\xff\xc9", 1))
    with pytest.raises(ValueError, match=r"arith\.jpg.*SOF9.*0xFFC9"):
        jpeg.read_jpeg(str(path))


def test_read_rgb_decides_by_content(tmp_path):
    img = _image(19, 27, seed=5)
    (tmp_path / "a.png").write_bytes(_pil_jpeg(img, quality=90))   # a JPEG
    Image.fromarray(img).save(tmp_path / "b.jpg", "PNG")           # a PNG
    rgba = np.dstack([img, np.full(img.shape[:2], 7, np.uint8)])
    Image.fromarray(rgba).save(tmp_path / "c.png")
    for name in ("a.png", "b.jpg", "c.png"):
        want = np.asarray(Image.open(tmp_path / name).convert("RGB"))
        assert np.array_equal(read_rgb(str(tmp_path / name)), want), name
