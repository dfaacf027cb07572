"""The port's data layer against PIL, cv2 and the JAX package's loaders.

  * the PNG decoder against PIL, bit for bit, in every mode PIL writes (L,
    LA, RGB, RGBA, P with and without tRNS, a 4-bit palette, L and RGB
    with a colour key) and on files
    whose rows cycle through all five filters; the encoder's files read back
    by PIL, bit for bit;
  * ``resize_lanczos`` against ``PIL.Image.resize(..., LANCZOS)`` at 800 ->
    400, 800 -> 401 x 299 and 40 -> 40 on RGBA (with partial alpha), RGB
    and L images: at most 1 level apart is the limit; against PIL 12.1 no
    pixel differs (share 0);
  * ``add_perturbation`` against the JAX package's (PIL) on an 800 x 800
    RGBA frame, seeds 0-9, every combination of color and occ, bit for bit;
  * ``BlenderDataset`` against the JAX package's on a scene that the JAX
    package's ``make_blender_scene`` writes (PIL's PNG filters), at the
    native 400 and at half size, with and without color + occ: all_rays /
    all_ts exact, all_rgbs within 1/255, val / test / test_train items alike;
    under pose refinement the train split's camera-frame rays and its poses
    exact, and test_train's items alike after ``apply_refined_poses``;
  * the port's ``make_blender_scene`` gives the JAX one's pixels and JSON;
  * the GIF encoder read back by PIL, and ``visualize_depth`` against cv2's.
"""
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from nerf_fl_tpu.data import blender as jblender
from nerf_fl_tpu.data import perturbations as jpert
from nerf_fl_tpu.data import synthetic as jsynthetic
from nerf_fl_tpu.utils import visualization as jvis
from nerf_fl_torch.data import blender, image_io, perturbations, synthetic
from nerf_fl_torch.utils import visualization


def _png_bytes(img, mode, **kw):
    b = io.BytesIO()
    Image.fromarray(img, mode).save(b, format="PNG", **kw)
    return b.getvalue()


def _pil(data):
    return Image.open(io.BytesIO(data))


def _ball(n, rng, partial=True):
    yy, xx = np.mgrid[:n, :n]
    m = (yy - n / 2) ** 2 + (xx - n / 2) ** 2 < (0.38 * n) ** 2
    img = np.zeros((n, n, 4), np.uint8)
    img[m, :3] = rng.integers(0, 256, (m.sum(), 3))
    img[m, 3] = 255
    if partial:
        img[n // 8:n // 4, n // 8:n // 3, 3] = 77
    return img


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P_trns",
                                  "P4", "L_trns", "RGB_trns"])
def test_png_decoder_matches_pil(mode):
    rng = np.random.default_rng(0)
    h, w = 37, 53
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "L_trns": 1,
          "RGB_trns": 3}.get(mode, 1)
    img = rng.integers(0, 16 if mode == "P4" else 256, (h, w, ch), np.uint8)
    img[:9] = 3                                    # flat rows, smooth rows
    img[9:20] = (np.arange(w)[None, :, None] * 4).astype(np.uint8) % 251
    img = img[..., 0] if ch == 1 else img
    kw = {}
    if mode.startswith("P"):
        pil = Image.fromarray(img, "P")
        n = 16 if mode == "P4" else 256
        pil.putpalette(rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes())
        if mode == "P_trns":
            kw["transparency"] = bytes(rng.integers(0, 256, 200, np.uint8))
        b = io.BytesIO()
        pil.save(b, format="PNG", **kw)
        data = b.getvalue()
    elif mode.endswith("_trns"):         # a colour key: the flat rows' 3
        data = _png_bytes(img, mode[:-5],
                          transparency=3 if ch == 1 else (3, 3, 3))
    else:
        data = _png_bytes(img, mode)
    got = image_io.decode_png(data)
    ref = _pil(data)
    if mode == "P4":
        assert struct.unpack(">B", data[24:25])[0] == 4     # a 4-bit file
    assert np.array_equal(got.pixels, np.asarray(ref))
    assert np.array_equal(image_io.to_rgba(got),
                          np.asarray(_pil(data).convert("RGBA")))


def _filtered_png(img, filters):
    """RGBA image as a PNG whose row y uses filters[y % len(filters)]."""
    h, w, c = img.shape
    x = img.astype(np.int64).reshape(h, w * c)
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        up = x[y - 1] if y else np.zeros(w * c, np.int64)
        out = np.empty(w * c, np.int64)
        for i in range(w * c):
            a = x[y, i - c] if i >= c else 0
            b = up[i]
            cc = up[i - c] if i >= c else 0
            pred = [0, a, b, (a + b) // 2, 0][f]
            if f == 4:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            out[i] = (x[y, i] - pred) & 255
        rows.append(bytes([f]) + out.astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0, 1, 2), (0, 1, 2, 3, 4), (4,), (3,)])
def test_png_decoder_reads_every_row_filter(filters):
    img = np.random.default_rng(1).integers(0, 256, (19, 23, 4), np.uint8)
    data = _filtered_png(img, filters)
    assert np.array_equal(np.asarray(_pil(data)), img)
    assert np.array_equal(image_io.decode_png(data).pixels, img)


def test_png_decoder_refuses_what_it_does_not_read():
    b = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(b, "PNG")
    with pytest.raises(ValueError, match="16-bit L"):
        image_io.decode_png(b.getvalue())
    # the same 8-bit file with its IHDR's interlace byte set to Adam7
    data = bytearray(image_io.encode_png(np.zeros((4, 4, 3), np.uint8)))
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match="interlaced"):
        image_io.decode_png(bytes(data))
    with pytest.raises(ValueError, match="signature"):
        image_io.decode_png(b"GIF89a" + bytes(40))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_encoder_is_read_back_by_pil(tmp_path, channels):
    img = np.random.default_rng(2).integers(0, 256, (31, 45, channels),
                                            np.uint8)
    path = str(tmp_path / "x.png")
    image_io.write_png(path, img)
    assert np.array_equal(np.asarray(Image.open(path)), img)
    assert np.array_equal(image_io.read_png(path).pixels, img)


@pytest.mark.parametrize("size", [(400, 400), (401, 299), (40, 40)])
@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L"])
def test_resize_lanczos_matches_pil(size, mode):
    rng = np.random.default_rng(3)
    n = 40 if size == (40, 40) else 800
    img = _ball(n, rng)
    img = {"RGBA": img, "RGB": img[..., :3], "L": img[..., 0]}[mode]
    img = np.ascontiguousarray(img)
    ref = np.asarray(Image.fromarray(img, mode).resize(size, Image.LANCZOS))
    got = image_io.resize_lanczos(img, size)
    d = np.abs(got.astype(np.int64) - ref)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() == 0.0      # the share of pixels that differ


@pytest.mark.parametrize("pert", [(), ("color",), ("occ",),
                                  ("color", "occ")])
def test_add_perturbation_matches_pil_bytes(pert):
    img = _ball(800, np.random.default_rng(4))
    for seed in range(10):
        want = np.asarray(jpert.add_perturbation(
            Image.fromarray(img, "RGBA"), list(pert), seed))
        got = perturbations.add_perturbation(img, list(pert), seed)
        assert got.dtype == np.uint8 and np.array_equal(got, want), seed


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene400"))
    jsynthetic.make_blender_scene(root, n_train=3, n_val=1, n_test=1,
                                  size=400, texture=True)
    return root


@pytest.mark.parametrize("pert", [(), ("color", "occ")])
@pytest.mark.parametrize("wh", [400, 200])
def test_blender_dataset_matches_jax(jax_scene, wh, pert):
    kw = dict(img_wh=(wh, wh), perturbation=list(pert))
    a = blender.BlenderDataset(jax_scene, "train", **kw)
    b = jblender.BlenderDataset(jax_scene, "train", **kw)
    assert np.array_equal(a.all_rays, b.all_rays)
    assert np.array_equal(a.all_ts, b.all_ts)
    assert a.all_rays.dtype == b.all_rays.dtype == np.float32
    assert np.abs(a.all_rgbs - b.all_rgbs).max() <= 1 / 255 + 1e-7
    assert a.white_back and a.ray_format == "world" and len(a) == len(b)
    for split in ("val", "test", "test_train"):
        a = blender.BlenderDataset(jax_scene, split, **kw)
        b = jblender.BlenderDataset(jax_scene, split, **kw)
        assert len(a) == len(b)
        for i in range(len(b)):
            sa, sb = a[i], b[i]
            assert sorted(sa) == sorted(sb)
            for k in sb:
                if k in ("rgbs", "original_rgbs"):
                    assert np.abs(sa[k] - sb[k]).max() <= 1 / 255 + 1e-7
                else:
                    assert np.array_equal(sa[k], sb[k]), (split, k)


def test_blender_dataset_camdir_rays_and_refined_poses_match_jax(jax_scene):
    """Pose refinement: the train split's camera-frame rays (dir, near,
    far) and its poses equal JAX's bit for bit, the other splits stay
    world-space; ``apply_refined_poses`` puts given poses in place of the
    frames' own in both packages alike (eval's --refine_pose)."""
    kw = dict(img_wh=(40, 40), refine_pose=True)
    a = blender.BlenderDataset(jax_scene, "train", **kw)
    b = jblender.BlenderDataset(jax_scene, "train", **kw)
    assert a.ray_format == b.ray_format == "camdir"
    assert a.all_rays.shape == b.all_rays.shape == (3 * 40 * 40, 5)
    for k in ("all_rays", "all_ts", "poses"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert np.abs(a.all_rgbs - b.all_rgbs).max() <= 1 / 255 + 1e-7
    refined = b.poses + np.random.default_rng(0).normal(
        0, 0.05, b.poses.shape).astype(np.float32)
    a = blender.BlenderDataset(jax_scene, "test_train", **kw)
    b = jblender.BlenderDataset(jax_scene, "test_train", **kw)
    assert a.ray_format == b.ray_format == "world"
    for ds in (a, b):
        ds.apply_refined_poses(refined)
    for i in range(len(b)):
        sa, sb = a[i], b[i]
        assert np.array_equal(sa["c2w"], refined[i])
        for k in ("rays", "c2w", "ts"):
            assert np.array_equal(sa[k], sb[k]), (i, k)


def test_make_blender_scene_matches_jax(tmp_path):
    kw = dict(n_train=2, n_val=1, n_test=1, size=48, texture=True)
    jsynthetic.make_blender_scene(str(tmp_path / "j"), **kw)
    synthetic.make_blender_scene(str(tmp_path / "t"), **kw)
    for split in ("train", "val", "test"):
        name = f"transforms_{split}.json"
        ja = open(tmp_path / "j" / name).read()
        assert open(tmp_path / "t" / name).read() == ja
        for frame in json.loads(ja)["frames"]:
            rel = frame["file_path"] + ".png"
            pa = np.asarray(Image.open(os.path.join(tmp_path, "j", rel)))
            pb = np.asarray(Image.open(os.path.join(tmp_path, "t", rel)))
            assert pa.shape == pb.shape and np.array_equal(pa, pb)


def test_gif_encoder_is_read_back_by_pil(tmp_path):
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (60, 70, 3), np.uint8),
              np.full((60, 70, 3), 255, np.uint8),
              np.concatenate([np.zeros((30, 70, 3), np.uint8),
                              rng.integers(0, 256, (30, 70, 3), np.uint8)])]
    path = str(tmp_path / "v.gif")
    image_io.write_gif(path, frames)
    im = Image.open(path)
    pal = image_io.gif_palette()
    assert im.n_frames == 3
    for i, f in enumerate(frames):
        im.seek(i)
        assert np.array_equal(np.asarray(im.convert("RGB")),
                              pal[image_io.gif_indices(f)])


def test_visualize_depth_matches_cv2():
    d = np.random.default_rng(6).normal(size=(30, 41)).astype(np.float32)
    d[0, 0] = np.nan
    assert np.array_equal(visualization.visualize_depth(d),
                          jvis.visualize_depth(d))
