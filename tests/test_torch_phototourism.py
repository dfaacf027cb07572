"""The port's Phototourism data path and the camera-frame ray path against
the JAX package's, on the CPU.

  * COLMAP: the port's binary and text readers and the columnar
    ``read_points3d_arrays`` return what the JAX package's do
    on a scene of its ``make_phototourism_scene`` (three cameras); the
    port's generator writes byte-equal COLMAP binaries and tsv, and JPEGs
    that PIL reads as the port does;
  * ``PhototourismDataset`` (train, val, test_train at img_downscale 1 and
    2): rays, ids, colours, Ks, poses, nears / fars and the val sample bit
    for bit; the tsv's id filter against pandas';
  * the ray cache both ways: the JAX ``prepare_phototourism.py``'s cache
    read by the port and the port's read by the JAX dataset, bit for bit,
    and a dataset built from the cache equal to one built from the images;
  * the pose path: ``exp_so3`` / ``make_c2w`` with their gradients (also
    at r = 0, where the gradient must be finite), ``assemble_world_rays``
    with sparse ids, values and gradients within 1e-6; one f32 train step
    on camera-frame rays, port against JAX from the same weights (the pose
    table carried by the bridge): metrics rtol 2e-3 / atol 2e-5 and the
    parameters after the step within 2e-3 (max) / 1e-4 (mean) per leaf, as
    tests/test_torch_lockstep.py holds them, gradients within 5e-3 of each
    leaf's norm (the coarse net's first layers are 2-3e-3 apart in f32
    there), and the frozen pose table bit for bit as it was;
  * a JAX checkpoint with a pose table loads into the port and a torch one
    round-trips it;
  * eval's ``--split test`` on a ``brandenburg_gate`` scene holding image
    1123: the port's 120 frames against the JAX CLI's, within one level.
"""
import os
import pickle
import re
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import eval as jeval
import prepare_phototourism as jprep
from nerf_fl_tpu.core import lie as jlie
from nerf_fl_tpu.data import colmap as jcolmap
from nerf_fl_tpu.data import colmap_native as jnative
from nerf_fl_tpu.data import synthetic as jsyn
from nerf_fl_tpu.data.phototourism import PhototourismDataset as JTour
from nerf_fl_tpu.render import RenderConfig as JRenderConfig
from nerf_fl_tpu.training import checkpoints as jckpt
from nerf_fl_tpu.training import optimizers as jopt
from nerf_fl_tpu.training import system as jsys
from nerf_fl_torch import eval as teval
from nerf_fl_torch import prepare_phototourism as tprep
from nerf_fl_torch.bridge import (from_jax_params, grads_to_numpy_tree,
                                  to_numpy_tree)
from nerf_fl_torch.core import lie
from nerf_fl_torch.data import RayBatcher, colmap, jpeg
from nerf_fl_torch.data import synthetic as tsyn
from nerf_fl_torch.data.phototourism import PhototourismDataset, \
    read_scene_tsv
from nerf_fl_torch.render import RenderConfig
from nerf_fl_torch.training import build_params, checkpoints, optimizers
from nerf_fl_torch.training import system

SIZES = [40, 32, 24]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def tour(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tour") / "scene")
    jsyn.make_phototourism_scene(root, n_images=6, sizes=SIZES, n_points=300)
    return root


def _same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert getattr(a, "_fields", None) == getattr(b, "_fields", None)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


# ----------------------------------------------------------------------
# COLMAP
# ----------------------------------------------------------------------

def test_colmap_binary_readers_match_jax(tour):
    sparse = os.path.join(tour, "dense/sparse")
    for name, fn in (("cameras.bin", "read_cameras_binary"),
                     ("images.bin", "read_images_binary"),
                     ("points3D.bin", "read_points3d_binary")):
        path = os.path.join(sparse, name)
        _same_tree(getattr(colmap, fn)(path), getattr(jcolmap, fn)(path))
    path = os.path.join(sparse, "points3D.bin")
    for tracks in (False, True):
        got = colmap.read_points3d_arrays(path, with_tracks=tracks)
        want = jnative._python_fallback(open(path, "rb").read(), tracks)
        _same_tree(got._asdict(), want._asdict())
    R = jcolmap.qvec2rotmat(np.array([0.8, 0.2, -0.3, 0.1]) / 0.9)
    _same_tree(colmap.qvec2rotmat(np.array([0.8, 0.2, -0.3, 0.1]) / 0.9), R)
    _same_tree(colmap.rotmat2qvec(R), jcolmap.rotmat2qvec(R))


def _write_text_model(sparse, out):
    cams, imgs, pts = jcolmap.read_model(sparse, ".bin")
    with open(os.path.join(out, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(out, "images.txt"), "w") as f:
        f.write("# Image list\n")
        for im in imgs.values():
            f.write(" ".join(str(v) for v in [im.id, *im.qvec.tolist(),
                                              *im.tvec.tolist(),
                                              im.camera_id, im.name]) + "\n")
            f.write("1.5 2.5 7 3.25 4.0 -1\n")
    with open(os.path.join(out, "points3D.txt"), "w") as f:
        f.write("# 3D point list\n")
        for p in pts.values():
            track = " ".join(f"{i} {j}" for i, j in zip(p.image_ids,
                                                       p.point2D_idxs))
            f.write(f"{p.id} {' '.join(repr(float(v)) for v in p.xyz)} "
                    f"{' '.join(str(int(v)) for v in p.rgb)} "
                    f"{float(p.error)} {track}\n")


def test_colmap_text_readers_match_jax(tour, tmp_path):
    _write_text_model(os.path.join(tour, "dense/sparse"), str(tmp_path))
    got = colmap.read_model(str(tmp_path), ".txt")
    want = jcolmap.read_model(str(tmp_path), ".txt")
    for a, b in zip(got, want):
        _same_tree(a, b)
    _same_tree(colmap.read_model(os.path.join(tour, "dense/sparse"), ".bin"),
               jcolmap.read_model(os.path.join(tour, "dense/sparse"), ".bin"))


def test_scene_generator_matches_jax(tour, tmp_path):
    root = str(tmp_path / "t")
    tsyn.make_phototourism_scene(root, n_images=6, sizes=SIZES, n_points=300)
    for name in ("dense/sparse/cameras.bin", "dense/sparse/images.bin",
                 "dense/sparse/points3D.bin", "minitour.tsv"):
        with open(os.path.join(root, name), "rb") as f, \
                open(os.path.join(tour, name), "rb") as g:
            assert f.read() == g.read(), name
    names = sorted(os.listdir(os.path.join(tour, "dense/images")))
    assert sorted(os.listdir(os.path.join(root, "dense/images"))) == names
    for n in names:
        path = os.path.join(root, "dense/images", n)
        pil = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(jpeg.read_jpeg(path), pil)
        ref = np.asarray(Image.open(os.path.join(tour, "dense/images", n)))
        # two quality-75 4:2:0 encoders of the same pixels
        assert np.abs(pil.astype(int) - ref).mean() < 1.0


def test_tsv_id_filter_matches_pandas(tmp_path):
    path = tmp_path / "s.tsv"
    path.write_text("filename\tid\tsplit\tdataset\n"
                    "a.jpg\t3\ttrain\tx\nb.jpg\t\ttrain\tx\n"
                    "c.jpg\tNaN\ttest\tx\nd.jpg\t9\ttest\tx\n\n"
                    "e.jpg\tnull\ttrain\tx\nf.jpg\t12\ttrain\tx\n")
    df = pd.read_csv(path, sep="\t")
    df = df[~df["id"].isnull()].reset_index(drop=True)
    rows = read_scene_tsv(str(path))
    assert [r["filename"] for r in rows] == list(df["filename"])
    assert [r["split"] for r in rows] == list(df["split"])


# ----------------------------------------------------------------------
# the dataset and its cache
# ----------------------------------------------------------------------

def _check_dataset(got, want):
    assert got.img_ids == want.img_ids and got.image_to_cam == \
        want.image_to_cam and got.image_paths == want.image_paths
    assert got.img_ids_train == want.img_ids_train
    assert got.img_ids_test == want.img_ids_test
    _same_tree(got.Ks, want.Ks)
    np.testing.assert_array_equal(got.poses, want.poses)
    _same_tree(got.nears, want.nears)
    _same_tree(got.fars, want.fars)
    np.testing.assert_array_equal(got.xyz_world, want.xyz_world)
    assert len(got) == len(want)
    assert got.ray_format == want.ray_format == "camdir"
    if got.split == "train":
        for k in ("all_rays", "all_ts", "all_rgbs"):
            a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    else:
        for i in (0, len(got) - 1):
            a, b = got[i], want[i]
            assert sorted(a) == sorted(b)
            for k in b:
                assert a[k].dtype == b[k].dtype and \
                    np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("split", ["train", "val", "test_train"])
@pytest.mark.parametrize("downscale", [1, 2])
def test_dataset_matches_jax(tour, downscale, split):
    got = PhototourismDataset(tour, split, downscale)
    _check_dataset(got, JTour(tour, split, downscale))


def test_cache_reads_both_ways(tour, tmp_path):
    roots = {k: str(tmp_path / k) for k in ("j", "t")}
    for r in roots.values():
        shutil.copytree(tour, r)
    jprep.main(types.SimpleNamespace(root_dir=roots["j"], img_downscale=2))
    tprep.main(tprep.get_opts(["--root_dir", roots["t"],
                               "--img_downscale", "2"]))
    names = sorted(os.listdir(os.path.join(roots["j"], "cache")))
    assert names == sorted(os.listdir(os.path.join(roots["t"], "cache")))
    for n in names:
        a, b = (os.path.join(r, "cache", n) for r in (roots["t"],
                                                        roots["j"]))
        if n.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and np.array_equal(x, y), n
        else:
            with open(a, "rb") as f, open(b, "rb") as g:
                _same_tree(pickle.load(f), pickle.load(g))
    images = PhototourismDataset(tour, "train", 2)
    for split in ("train", "val"):
        # the port reads JAX's cache, JAX reads the port's
        got = PhototourismDataset(roots["j"], split, 2, use_cache=True)
        _check_dataset(got, JTour(roots["j"], split, 2, use_cache=True))
        _check_dataset(JTour(roots["t"], split, 2, use_cache=True),
                       PhototourismDataset(roots["t"], split, 2,
                                           use_cache=True))
        if split == "train":
            for k in ("all_rays", "all_ts", "all_rgbs"):
                np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                              getattr(images, k))


# ----------------------------------------------------------------------
# the pose path
# ----------------------------------------------------------------------

def test_lie_matches_jax_with_gradients():
    rng = np.random.default_rng(0)
    r = rng.normal(0, 0.3, (5, 3)).astype(np.float32)
    r[0] = 0.0                       # the origin: the Taylor branch
    r[1] = 1e-6                      # just inside it
    t = rng.normal(0, 1, (5, 3)).astype(np.float32)
    w = rng.normal(0, 1, (5, 4, 4)).astype(np.float32)

    def jf(r, t):
        return jnp.sum(jlie.make_c2w(r, t) * w)

    jv = jlie.make_c2w(jnp.asarray(r), jnp.asarray(t))
    jg = jax.grad(jf, argnums=(0, 1))(jnp.asarray(r), jnp.asarray(t))
    tr, tt = _t(r).requires_grad_(), _t(t).requires_grad_()
    tv = lie.make_c2w(tr, tt)
    (tv * _t(w)).sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               atol=1e-6)
    assert np.isfinite(tr.grad.numpy()).all()
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jg[0]), atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg[1]), atol=1e-6)
    np.testing.assert_allclose(
        lie.exp_so3(_t(r)).numpy(), np.asarray(jlie.exp_so3(r)), atol=1e-6)
    m = rng.normal(0, 1, (2, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(lie.convert3x4_4x4_np(m),
                                  jlie.convert3x4_4x4_np(m))
    np.testing.assert_array_equal(lie.convert3x4_4x4_np(m[0]),
                                  jlie.convert3x4_4x4_np(m[0]))


def _pose_tree(rng, n):
    init = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    init[:, :3, :4] = rng.normal(0, 1, (n, 3, 4))
    return {"r": rng.normal(0, 0.1, (n, 3)).astype(np.float32),
            "t": rng.normal(0, 0.1, (n, 3)).astype(np.float32),
            "init_c2w": init}


def test_assemble_world_rays_matches_jax():
    rng = np.random.default_rng(1)
    ids = [1, 2, 5, 9]                            # sparse image ids
    idmap = np.zeros(10, np.int32)
    for i, id_ in enumerate(ids):
        idmap[id_] = i
    poses = _pose_tree(rng, len(ids))
    rays = np.concatenate([rng.normal(0, 1, (64, 3)),
                           rng.uniform(0.1, 1, (64, 1)),
                           rng.uniform(2, 5, (64, 1))], 1).astype(np.float32)
    ts = rng.choice(ids, 64).astype(np.int32)
    w = rng.normal(0, 1, (64, 8)).astype(np.float32)

    def jf(p):
        out = jsys.assemble_world_rays({"learn_poses": p}, jnp.asarray(rays),
                                       jnp.asarray(ts), ray_format="camdir",
                                       id_to_cam=jnp.asarray(idmap))
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jf, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, poses))
    tp = from_jax_params({"learn_poses": poses}, RenderConfig())
    out = system.assemble_world_rays(tp, _t(rays), _t(ts),
                                     ray_format="camdir",
                                     id_to_cam=_t(idmap).long())
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-6)
    grads = grads_to_numpy_tree(tp)["learn_poses"]
    for k in ("r", "t"):
        np.testing.assert_allclose(grads[k], np.asarray(jg[k]), atol=1e-5,
                                   rtol=1e-5)
    world = _t(rays[:, :5])
    assert system.assemble_world_rays(tp, world, _t(ts),
                                      ray_format="world") is world


def test_camdir_train_step_matches_jax(tour):
    ds = PhototourismDataset(tour, "train", 2)
    kw = dict(N_samples=8, N_importance=8, encode_a=True, encode_t=True,
              perturb=0.0, noise_std=0.0, beta_min=0.1, mlp_depth=4,
              mlp_width=32)
    jcfg, tcfg = JRenderConfig(**kw), RenderConfig(**kw)
    init = np.concatenate([ds.poses.astype(np.float32), np.tile(
        np.array([[[0, 0, 0, 1]]], np.float32), (len(ds.poses), 1, 1))], 1)
    idmap = np.zeros(max(ds.img_ids) + 1, np.int32)
    for i, id_ in enumerate(ds.img_ids):
        idmap[id_] = i
    jp = jsys.build_params(jax.random.PRNGKey(0), jcfg, 16, init_poses=init)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    mask = optimizers.make_trainable_mask(tp, False)
    for name, p in optimizers.named_leaves(tp):
        p.requires_grad_(mask[name])
    h = types.SimpleNamespace(optimizer="adam", lr=5e-4, weight_decay=0.0)
    tx = jopt.build_optimizer(h)
    jstep = jsys.make_train_step(jcfg, tx, jopt.make_trainable_mask(jp, False),
                                 donate=False, ray_format="camdir",
                                 id_to_cam=idmap)
    opt = optimizers.build_optimizer(h, optimizers.trainable_parameters(
        tp, mask))
    tstep = system.make_train_step(tcfg, opt, ray_format="camdir",
                                   id_to_cam=idmap)
    b = next(RayBatcher(ds.all_rays, ds.all_ts, ds.all_rgbs, 128,
                        seed=3).epoch(0))
    assert b["rays"].shape == (128, 5)

    def loss_j(p):
        rays = jsys.assemble_world_rays(p, jnp.asarray(b["rays"]),
                                        jnp.asarray(b["ts"]),
                                        ray_format="camdir",
                                        id_to_cam=jnp.asarray(idmap))
        from nerf_fl_tpu.render import render_rays as jrender
        from nerf_fl_tpu.training import losses as jlosses
        res = jrender(p, rays, jnp.asarray(b["ts"]), jax.random.PRNGKey(0),
                      jcfg)
        return sum(jlosses.nerfw_loss(res, jnp.asarray(b["rgbs"])).values())

    jg = jax.jit(jax.grad(loss_j))(jp)
    jp2, _, jm = jstep(jp, tx.init(jp), {k: jnp.asarray(v)
                                         for k, v in b.items()},
                       jnp.float32(5e-4), jnp.float32(0.0),
                       jax.random.PRNGKey(0))
    tm = tstep(tp, {k: _t(v) for k, v in b.items()}, 5e-4)
    assert set(tm) == set(jm)
    np.testing.assert_allclose([float(tm[k]) for k in sorted(jm)],
                               [float(jm[k]) for k in sorted(jm)],
                               rtol=2e-3, atol=2e-5)
    tg = grads_to_numpy_tree(tp)
    for key in ("nerf_coarse", "nerf_fine", "embedding_a", "embedding_t"):
        for a, c in zip(jax.tree_util.tree_leaves(jg[key]),
                        jax.tree_util.tree_leaves(tg[key])):
            a = np.asarray(a)
            assert np.linalg.norm(a - c) <= 5e-3 * np.linalg.norm(a) + 1e-9
    got = to_numpy_tree(tp)
    for key in got:
        diffs = [np.abs(np.asarray(a) - c) for a, c in zip(
            jax.tree_util.tree_leaves(jp2[key]),
            jax.tree_util.tree_leaves(got[key]))]
        assert max(float(d.max()) for d in diffs) <= 2e-3, key
        assert max(float(d.mean()) for d in diffs) <= 1e-4, key
    for k, v in jax.tree_util.tree_map(np.asarray, jp["learn_poses"]).items():
        np.testing.assert_array_equal(got["learn_poses"][k], v)
        np.testing.assert_array_equal(np.asarray(jp2["learn_poses"][k]), v)


def test_pose_table_checkpoints(tmp_path):
    rng = np.random.default_rng(2)
    cfg = JRenderConfig(N_samples=4, N_importance=4, encode_a=True,
                        mlp_depth=2, mlp_width=16)
    poses = _pose_tree(rng, 3)
    jp = jsys.build_params(jax.random.PRNGKey(1), cfg, 6,
                           init_poses=poses["init_c2w"])
    jp["learn_poses"] = {k: jnp.asarray(v) for k, v in poses.items()}
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, jp)
    tcfg = RenderConfig(N_samples=4, N_importance=4, encode_a=True,
                        mlp_depth=2, mlp_width=16)
    tp = build_params(tcfg, 6, device="cpu",
                      init_poses=np.tile(np.eye(4, dtype=np.float32),
                                         (3, 1, 1)))
    checkpoints.load_into(tp, checkpoints.load_checkpoint(path))
    got = to_numpy_tree(tp)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, jp), got)
    own = str(tmp_path / "torch.ckpt")
    checkpoints.save_checkpoint(own, tp, epoch=3)
    fresh = build_params(tcfg, 6, device="cpu",
                         init_poses=np.zeros((3, 4, 4), np.float32))
    checkpoints.load_into(fresh, checkpoints.load_checkpoint(own))
    jax.tree_util.tree_map(np.testing.assert_array_equal, got,
                           to_numpy_tree(fresh))


# ----------------------------------------------------------------------
# eval's test split
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """A brandenburg_gate-named scene of three 16 px images whose ids are
    1, 1123 and 1124, and a JAX checkpoint of a tiny NeRF-W."""
    base = tmp_path_factory.mktemp("gate")
    root = str(base / "brandenburg_gate")
    jsyn.make_phototourism_scene(root, n_images=3, size=16, n_points=100)
    sparse = os.path.join(root, "dense/sparse")
    imgs = jcolmap.read_images_binary(os.path.join(sparse, "images.bin"))
    new = {1: 1, 2: 1123, 3: 1124}
    jsyn.write_images_binary(
        {new[i]: {"qvec": im.qvec.tolist(), "tvec": im.tvec.tolist(),
                  "camera_id": im.camera_id, "name": im.name, "xys": [],
                  "point3D_ids": []} for i, im in imgs.items()},
        os.path.join(sparse, "images.bin"))
    tsv = os.path.join(root, "minitour.tsv")
    with open(tsv) as f:
        text = f.read()
    with open(tsv, "w") as f:
        f.write(re.sub(r"\t2\t", "\t1123\t", re.sub(r"\t3\t", "\t1124\t",
                                                      text)))
    cfg = JRenderConfig(N_samples=8, N_importance=8, encode_a=True,
                        encode_t=True, mlp_depth=2, mlp_width=32)
    ckpt = str(base / "jax.ckpt")
    jckpt.save_checkpoint(ckpt, jsys.build_params(jax.random.PRNGKey(5),
                                                  cfg, 1200))
    return root, ckpt


def test_eval_test_split_matches_jax(gate, tmp_path, monkeypatch):
    root, ckpt = gate
    argv = ["--dataset_name", "phototourism", "--root_dir", root,
            "--N_samples", "8", "--N_importance", "8", "--mlp_depth", "2",
            "--mlp_width", "32", "--encode_a", "--encode_t", "--N_vocab",
            "1200", "--img_wh", "6", "4", "--split", "test", "--chunk", "64",
            "--ckpt_path", ckpt, "--scene_name", "s"]
    for d in ("j", "t"):
        os.makedirs(tmp_path / d)
    monkeypatch.chdir(tmp_path / "j")
    assert jeval.main(jeval.get_opts(argv)) is None
    monkeypatch.chdir(tmp_path / "t")
    assert teval.main(teval.get_opts(argv), device="cpu") is None
    j = tmp_path / "j/results/phototourism/s"
    t = tmp_path / "t/results/phototourism/s"
    frames = sorted(n for n in os.listdir(j) if n.endswith(".png"))
    assert len(frames) == 120
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))   # + s.gif
    for n in frames:
        a = np.asarray(Image.open(j / n))
        b = np.asarray(Image.open(t / n))
        assert a.shape == b.shape == (4, 6, 3)
        assert np.abs(a.astype(int) - b).max() <= 1, n
    # any other scene has no test path
    other = str(tmp_path / "other")
    shutil.copytree(root, other)
    with pytest.raises(NotImplementedError, match="brandenburg_gate"):
        teval.main(teval.get_opts([*argv[:3], other, *argv[4:]]),
                   device="cpu")
