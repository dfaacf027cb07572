"""The port's LLFF dataset, its scene generator and PFM files against the
JAX package's, on the CPU.

  * ``LLFFDataset``: the train split's rays, ids and colours, and every
    other split's first sample (NDC and spheric; val, test, test_train)
    equal the JAX package's bit for bit, on PNG and on JPEG images (read
    as PIL reads them);
  * ``make_llff_scene``: the same ``poses_bounds.npy`` and pixels;
  * ``save_pfm`` writes the JAX package's bytes and ``read_pfm`` reads
    them back (gray and colour).
"""
import os

import numpy as np
import pytest
from PIL import Image

from nerf_fl_tpu.data import pfm as jpfm
from nerf_fl_tpu.data.llff import LLFFDataset as JLLFF
from nerf_fl_tpu.data.synthetic import make_llff_scene as jmake_llff
from nerf_fl_torch.data import pfm
from nerf_fl_torch.data.llff import LLFFDataset
from nerf_fl_torch.data.synthetic import make_llff_scene

WH = (40, 30)


@pytest.fixture(scope="module")
def llff_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("llff"))
    jmake_llff(root, n_images=5)
    return root


@pytest.fixture(scope="module")
def llff_jpeg_scene(tmp_path_factory, llff_scene):
    """The same capture with its images as JPEGs at twice the size, so
    the resize runs too."""
    root = str(tmp_path_factory.mktemp("llff_jpg"))
    os.makedirs(os.path.join(root, "images"))
    for name in sorted(os.listdir(os.path.join(llff_scene, "images"))):
        img = Image.open(os.path.join(llff_scene, "images", name))
        img = img.resize((80, 60), Image.BILINEAR)
        img.save(os.path.join(root, "images", name[:-4] + ".jpg"),
                 quality=90)
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.load(os.path.join(llff_scene, "poses_bounds.npy")))
    return root


def _equal(a, b, keys):
    for k in keys:
        x, y = a[k] if isinstance(a, dict) else getattr(a, k), \
            b[k] if isinstance(b, dict) else getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("spheric", [False, True])
@pytest.mark.parametrize("split", ["train", "val", "test", "test_train"])
@pytest.mark.parametrize("which", ["png", "jpeg"])
def test_llff_dataset_matches_jax(llff_scene, llff_jpeg_scene, which, split,
                                  spheric):
    root = llff_scene if which == "png" else llff_jpeg_scene
    want = JLLFF(root, split, WH, spheric)
    got = LLFFDataset(root, split, WH, spheric)
    assert len(got) == len(want)
    assert got.ray_format == want.ray_format == "world"
    assert got.white_back == want.white_back
    if split == "train":
        _equal(got, want, ("all_rays", "all_ts", "all_rgbs"))
    else:
        a, b = got[0], want[0]
        assert sorted(a) == sorted(b)
        _equal(a, b, list(b))
    np.testing.assert_array_equal(got.poses, want.poses)


def test_make_llff_scene_matches_jax(tmp_path):
    jmake_llff(str(tmp_path / "j"), n_images=3)
    make_llff_scene(str(tmp_path / "t"), n_images=3)
    np.testing.assert_array_equal(
        np.load(tmp_path / "t" / "poses_bounds.npy"),
        np.load(tmp_path / "j" / "poses_bounds.npy"))
    names = sorted(os.listdir(tmp_path / "j" / "images"))
    assert names == sorted(os.listdir(tmp_path / "t" / "images"))
    for n in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "t" / "images" / n)),
            np.asarray(Image.open(tmp_path / "j" / "images" / n)))


@pytest.mark.parametrize("shape", [(7, 5), (4, 6, 3), (3, 2, 1)])
def test_pfm_matches_jax(tmp_path, shape):
    img = np.random.default_rng(0).normal(0, 3, shape).astype(np.float32)
    jpfm.save_pfm(str(tmp_path / "j.pfm"), img, 2.5)
    pfm.save_pfm(str(tmp_path / "t.pfm"), img, 2.5)
    assert (tmp_path / "t.pfm").read_bytes() == \
        (tmp_path / "j.pfm").read_bytes()
    data, scale = pfm.read_pfm(str(tmp_path / "j.pfm"))
    jdata, jscale = jpfm.read_pfm(str(tmp_path / "t.pfm"))
    assert scale == jscale == 2.5
    flat = img.reshape(img.shape[:2]) if img.ndim == 3 and \
        img.shape[2] == 1 else img
    np.testing.assert_array_equal(data, flat)
    np.testing.assert_array_equal(jdata, flat)
    with pytest.raises(ValueError):
        pfm.save_pfm(str(tmp_path / "x.pfm"), img.astype(np.float64))
