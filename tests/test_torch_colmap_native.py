"""The port's native COLMAP points decoder (``nerf_fl_torch/data/
colmap_native.py`` over ``nerf_fl_torch/csrc/colmap_fast.c``) against the
JAX package's readers, on the CPU.

  * on the same bytes, the port's decoder and its pure-Python reader give
    what ``nerf_fl_tpu.data.colmap_native._python_fallback`` and
    ``nerf_fl_tpu.data.colmap.read_points3d_binary`` give, exactly (xyz and
    error bit for bit): a ``make_phototourism_scene`` file, tracks of mixed
    lengths 0-20, an empty cloud;
  * the columnar writer writes ``write_points3d_binary``'s bytes;
  * truncated files raise ``ValueError`` in both packages (the JAX
    package's C decoder built from its own source into a temporary
    directory);
  * with no C compiler, the port says so in one line and reads the same
    arrays in Python;
  * ``PhototourismDataset(use_cache=False)`` over a cloud with tracks: the
    near / far planes and the rescaled points bit for bit the JAX
    package's, as tests/test_torch_phototourism.py holds them.
"""
import os
import subprocess

import numpy as np
import pytest

from nerf_fl_tpu.data import colmap as jcolmap
from nerf_fl_tpu.data import colmap_native as jnative
from nerf_fl_tpu.data import synthetic as jsyn
from nerf_fl_tpu.data.phototourism import PhototourismDataset as JTour
from nerf_fl_torch.data import colmap, colmap_native
from nerf_fl_torch.data import synthetic as tsyn
from nerf_fl_torch.data.phototourism import PhototourismDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mixed_cloud(n, max_track=20, seed=0):
    rng = np.random.default_rng(seed)
    track_len = rng.integers(0, max_track + 1, n)
    return dict(xyz=rng.normal(0, 0.5, (n, 3)),
                rgb=rng.integers(0, 256, (n, 3)),
                error=rng.random(n), track_len=track_len,
                tracks=rng.integers(0, 2000, (int(track_len.sum()), 2))
                .astype(np.int32))


def _as_points(c):
    """The cloud as ``write_points3d_binary``'s dict."""
    starts = np.concatenate([[0], np.cumsum(c["track_len"])])
    return {i + 1: {"xyz": c["xyz"][i].tolist(), "rgb": c["rgb"][i].tolist(),
                    "error": float(c["error"][i]),
                    "image_ids": c["tracks"][starts[i]:starts[i + 1], 0]
                    .tolist(),
                    "point2D_idxs": c["tracks"][starts[i]:starts[i + 1], 1]
                    .tolist()}
            for i in range(len(c["track_len"]))}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("points")
    tour = str(d / "tour")
    jsyn.make_phototourism_scene(tour, n_images=4, sizes=[24, 16],
                                 n_points=300)
    out = {"scene": os.path.join(tour, "dense/sparse/points3D.bin")}
    for name, n in (("mixed", 500), ("empty", 0)):
        out[name] = str(d / f"{name}.bin")
        tsyn.write_points3d_arrays(out[name], **_mixed_cloud(n))
    return out


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        a, b = a.view(np.uint64), b.view(np.uint64)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_tracks", [False, True])
@pytest.mark.parametrize("case", ["scene", "mixed", "empty"])
def test_decoder_matches_jax_readers(files, case, with_tracks):
    path = files[case]
    assert colmap_native.native_available()
    got = colmap_native.read_points3d_arrays(path, with_tracks=with_tracks)
    pure = colmap.read_points3d_arrays(path, with_tracks=with_tracks)
    want = jnative._python_fallback(open(path, "rb").read(), with_tracks)
    assert got._fields == want._fields
    for g, p, w in zip(got, pure, want):
        if w is None:
            assert g is None and p is None
            continue
        _same(g, w)
        _same(p, w)
    ref = jcolmap.read_points3d_binary(path)
    assert list(got.ids) == list(ref)
    _same(got.xyz, np.array([ref[k].xyz for k in ref],
                            np.float64).reshape(-1, 3))
    _same(got.error, np.array([ref[k].error for k in ref], np.float64))
    np.testing.assert_array_equal(got.rgb, np.array(
        [ref[k].rgb for k in ref]).reshape(-1, 3))
    np.testing.assert_array_equal(got.track_len,
                                  [len(ref[k].image_ids) for k in ref])
    if with_tracks:
        pairs = [np.stack([ref[k].image_ids, ref[k].point2D_idxs], 1)
                 for k in ref]
        np.testing.assert_array_equal(
            got.tracks, np.concatenate(pairs) if pairs else
            np.empty((0, 2), np.int32))


def test_columnar_writer_writes_the_struct_writers_bytes(tmp_path):
    cloud = _mixed_cloud(200, seed=3)
    tsyn.write_points3d_arrays(str(tmp_path / "cols.bin"), **cloud)
    tsyn.write_points3d_binary(_as_points(cloud), str(tmp_path / "t.bin"))
    jsyn.write_points3d_binary(_as_points(cloud), str(tmp_path / "j.bin"))
    cols = (tmp_path / "cols.bin").read_bytes()
    assert cols == (tmp_path / "t.bin").read_bytes() \
        == (tmp_path / "j.bin").read_bytes()
    assert len(cols) == 8 + 51 * 200 + 8 * int(cloud["track_len"].sum())


@pytest.fixture()
def jax_native(tmp_path, monkeypatch):
    """The JAX package's C decoder, built from its own source into a
    temporary directory (the package's files untouched)."""
    lib = tmp_path / "libcolmap_fast.so"
    subprocess.run(["cc", "-O3", "-shared", "-fPIC", "-o", str(lib),
                    os.path.join(ROOT, "csrc", "colmap_fast.c")], check=True)
    monkeypatch.setattr(jnative, "_LIB_PATH", str(lib))
    monkeypatch.setattr(jnative, "_lib", None)
    assert jnative.native_available()
    return jnative


@pytest.mark.parametrize("cut", [5, 30, 8 + 51 + 3, -1])
def test_truncated_files_raise_in_both_packages(files, tmp_path, jax_native,
                                                cut):
    """Cut inside the count, inside the first record's header, inside its
    track, and one byte short of the end."""
    data = open(files["mixed"], "rb").read()
    path = str(tmp_path / "cut.bin")
    with open(path, "wb") as f:
        f.write(data[:cut])
    for reader in (colmap_native.read_points3d_arrays,
                   colmap.read_points3d_arrays,
                   jax_native.read_points3d_arrays):
        for with_tracks in (False, True):
            with pytest.raises(ValueError, match="corrupt points3D"):
                reader(path, with_tracks=with_tracks)


def test_without_a_compiler_it_says_so_and_reads_in_python(
        files, tmp_path, monkeypatch, capsys):
    want = colmap_native.read_points3d_arrays(files["mixed"],
                                              with_tracks=True)
    monkeypatch.setattr(colmap_native, "_compiler", lambda: None)
    monkeypatch.setattr(colmap_native, "_target",
                        lambda: tmp_path / "unbuilt.so")
    monkeypatch.setattr(colmap_native, "_lib", None)
    monkeypatch.setattr(colmap_native, "_unavailable", None)
    capsys.readouterr()
    assert not colmap_native.native_available()
    for _ in range(2):
        got = colmap_native.read_points3d_arrays(files["mixed"],
                                                 with_tracks=True)
        for g, w in zip(got, want):
            _same(g, w)
    out = capsys.readouterr().out.splitlines()
    assert out == ["[colmap] native points decoder unavailable (no C "
                   "compiler (cc) found); reading points3D.bin with the "
                   "pure-Python reader"]


def test_library_builds_into_the_build_directory():
    path = colmap_native.build()
    assert path.parent.name == "_build" \
        and path.parent.parent.name == "nerf_fl_torch"
    assert path.name.startswith("colmap_fast-") and path.exists()


def test_dataset_near_far_match_jax_over_a_cloud_with_tracks(
        tmp_path, capsys):
    root = str(tmp_path / "scene")
    jsyn.make_phototourism_scene(root, n_images=5, sizes=[24, 16],
                                 n_points=20)
    sparse = os.path.join(root, "dense/sparse")
    ids = sorted(colmap.read_images_binary(os.path.join(sparse,
                                                        "images.bin")))
    tsyn.write_point_cloud(os.path.join(sparse, "points3D.bin"), 20000, ids,
                           track_len=8, seed=5)
    capsys.readouterr()
    got = PhototourismDataset(root, "test_train", 2)
    assert "[colmap]" not in capsys.readouterr().out
    want = JTour(root, "test_train", 2)
    assert sorted(got.nears) == sorted(want.nears) == sorted(got.img_ids)
    for k in want.nears:
        assert type(got.nears[k]) is type(want.nears[k])
        assert got.nears[k] == want.nears[k]
        assert got.fars[k] == want.fars[k]
    _same(got.xyz_world, want.xyz_world)
    np.testing.assert_array_equal(got.poses, want.poses)
    assert set(got.stage_s) == {"points", "near_far"}
    assert all(v >= 0 for v in got.stage_s.values())
    cloud = colmap_native.read_points3d_arrays(
        os.path.join(sparse, "points3D.bin"), with_tracks=True)
    assert cloud.tracks.shape == (8 * 20000, 2)
    assert set(np.unique(cloud.tracks[:, 0])) <= set(ids)
