"""Synthetic scenes, built from scratch (no download): a Blender-format
analytic scene, a miniature LLFF capture and a COLMAP-binary Phototourism
reconstruction.

The port's copy of ``nerf_fl_tpu/data/synthetic.py``: the same poses,
pixels, JSON, ``poses_bounds.npy``, COLMAP binaries and scene tsv (the
COLMAP writers are the inverse of ``data/colmap.py``'s readers and write
the JAX package's bytes), with the PNGs written by ``image_io.write_png``
and the Phototourism JPEGs by ``jpeg.write_jpeg`` (quality 75, 4:2:0,
PIL's defaults) instead of PIL.
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np

from .image_io import write_png
from .jpeg import write_jpeg


def _look_at_pose(theta: float, radius: float = 4.0, height: float = 1.0):
    """Camera on a circle looking at the origin, OpenGL convention
    (right/up/back): -z is the viewing direction."""
    eye = np.array([radius * np.cos(theta), radius * np.sin(theta), height])
    forward = -eye / np.linalg.norm(eye)          # toward origin
    up0 = np.array([0.0, 0.0, 1.0])
    right = np.cross(forward, up0)
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = -forward                          # back
    c2w[:3, 3] = eye
    return c2w


def _render_ball(size: int, c2w: np.ndarray, focal: float,
                 texture: bool = False) -> np.ndarray:
    """Analytic RGBA render of a unit ball at the origin — enough structure
    for loss-goes-down tests.  With texture=True a checker pattern in
    spherical surface coordinates modulates the luminance: the smooth
    position gradient alone leaves the static/appearance color split
    underdetermined (a global color shift is absorbable by every NeRF-W
    appearance code), while the checker pins the static field the way
    lego's texture does."""
    i, j = np.meshgrid(np.arange(size), np.arange(size), indexing="xy")
    dirs = np.stack([(i - size / 2) / focal, -(j - size / 2) / focal,
                     -np.ones_like(i)], -1).astype(np.float64)
    rd = dirs @ c2w[:3, :3].T
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = c2w[:3, 3]
    b = 2 * np.sum(rd * ro, -1)
    c = np.sum(ro * ro) - 1.0
    disc = b * b - 4 * c
    hit = disc > 0
    t = (-b - np.sqrt(np.maximum(disc, 0))) / 2
    p = ro + rd * t[..., None]
    color = np.clip(0.5 + 0.5 * p, 0, 1)
    if texture:
        az = np.arctan2(p[..., 1], p[..., 0])          # [-pi, pi]
        pol = np.arccos(np.clip(p[..., 2], -1, 1))     # [0, pi]
        checker = (np.floor(az / (np.pi / 6))
                   + np.floor(pol / (np.pi / 12))) % 2
        color = color * (0.35 + 0.65 * checker[..., None])
    img = np.zeros((size, size, 4))
    img[hit, :3] = color[hit]
    img[hit, 3] = 1.0
    return (img * 255).astype(np.uint8)


def make_blender_scene(root: str, n_train: int = 4, n_val: int = 2,
                       n_test: int = 2, size: int = 40,
                       camera_angle_x: float = 0.8,
                       texture: bool = False) -> None:
    focal = 0.5 * size / np.tan(0.5 * camera_angle_x)
    counts = {"train": n_train, "val": n_val, "test": n_test}
    k = 0
    for split, n in counts.items():
        frames = []
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for idx in range(n):
            theta = 2 * np.pi * (k * 0.37 % 1.0)
            k += 1
            c2w = _look_at_pose(theta)
            img = _render_ball(size, c2w, focal, texture=texture)
            rel = f"./{split}/r_{idx}"
            write_png(os.path.join(root, f"{rel}.png"), img)
            frames.append({"file_path": rel,
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)


def make_llff_scene(root: str, n_images: int = 5, width: int = 40,
                    height: int = 30, focal: float = 45.0) -> None:
    """Miniature LLFF root: images/ + poses_bounds.npy in the "down right
    back" on-disk convention, a nearly-forward-facing capture of the
    analytic ball."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rows = []
    for i in range(n_images):
        c2w = _look_at_pose(0.12 * i - 0.3, radius=4.0, height=0.3)
        img = _render_ball(max(width, height), c2w, focal)[:height, :width,
                                                           :3]
        write_png(os.path.join(root, f"images/im_{i:02d}.png"),
                  np.ascontiguousarray(img))
        # re-encode as LLFF "down right back": columns [-y, x, z]
        m = np.concatenate(
            [-c2w[:3, 1:2], c2w[:3, 0:1], c2w[:3, 2:4]], 1)
        hwf = np.array([[height], [width], [focal]])
        rows.append(np.concatenate(
            [np.concatenate([m, hwf], 1).reshape(-1), [2.0, 9.0]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))


# ----------------------------------------------------------------------
# COLMAP binary writers (inverse of the parsers; used to build fixtures)
# ----------------------------------------------------------------------

def write_cameras_binary(cameras: dict, path: str) -> None:
    """cameras: {id: dict(model_id, width, height, params)}"""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cid, cam in cameras.items():
            f.write(struct.pack("<iiQQ", cid, cam["model_id"],
                                cam["width"], cam["height"]))
            f.write(struct.pack("<" + "d" * len(cam["params"]), *cam["params"]))


def write_images_binary(images: dict, path: str) -> None:
    """images: {id: dict(qvec(4), tvec(3), camera_id, name, xys(N,2),
    point3D_ids(N,))}"""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, im in images.items():
            f.write(struct.pack("<idddddddi", iid, *im["qvec"], *im["tvec"],
                                im["camera_id"]))
            f.write(im["name"].encode() + b"\x00")
            n = len(im["point3D_ids"])
            f.write(struct.pack("<Q", n))
            for (x, y), pid in zip(im["xys"], im["point3D_ids"]):
                f.write(struct.pack("<ddq", x, y, pid))


def write_points3d_binary(points: dict, path: str) -> None:
    """points: {id: dict(xyz(3), rgb(3), error, image_ids(N,),
    point2D_idxs(N,))}"""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pid, pt in points.items():
            f.write(struct.pack("<QdddBBBd", pid, *pt["xyz"],
                                *[int(v) for v in pt["rgb"]], pt["error"]))
            n = len(pt["image_ids"])
            f.write(struct.pack("<Q", n))
            for im, p2 in zip(pt["image_ids"], pt["point2D_idxs"]):
                f.write(struct.pack("<ii", im, p2))


_POINT_HEAD = np.dtype([("id", "<u8"), ("xyz", "<f8", (3,)),
                        ("rgb", "u1", (3,)), ("error", "<f8"),
                        ("track_len", "<u8")])      # packed: 51 bytes


def write_points3d_arrays(path: str, xyz: np.ndarray, rgb: np.ndarray,
                          error: np.ndarray, track_len: np.ndarray,
                          tracks: np.ndarray, ids=None) -> None:
    """points3D.bin from columns, the bytes ``write_points3d_binary``
    writes for the same points: ``xyz`` (n, 3), ``rgb`` (n, 3), ``error``
    (n,), ``track_len`` (n,), ``tracks`` (sum(track_len), 2) (image id,
    point2D index) pairs in point order, ``ids`` (n,) (default 1..n).  Each
    record is 43 + 8 + 8 * track_len bytes, laid out with numpy, so a
    million points take well under a second."""
    track_len = np.asarray(track_len, np.int64)
    n = len(track_len)
    head = np.empty(n, _POINT_HEAD)
    head["id"] = np.arange(1, n + 1) if ids is None else ids
    head["xyz"], head["rgb"] = xyz, rgb
    head["error"], head["track_len"] = error, track_len
    body = np.ascontiguousarray(tracks, "<i4").view(np.uint8)
    if body.size != 8 * int(track_len.sum()):
        raise ValueError("tracks must hold sum(track_len) pairs")
    # each record: its 51 header bytes, then its 8 * track_len track bytes
    runs = np.stack([np.full(n, _POINT_HEAD.itemsize), 8 * track_len], 1)
    is_head = np.repeat(np.tile([True, False], n), runs.ravel())
    out = np.empty(is_head.size, np.uint8)
    out[is_head] = head.view(np.uint8)
    out[~is_head] = body.ravel()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        out.tofile(f)


def write_point_cloud(path: str, n: int, image_ids, track_len: int = 8,
                      seed: int = 0) -> None:
    """A reconstruction-sized points3D.bin: ``n`` points around the origin
    (``make_phototourism_scene``'s N(0, 0.5) cloud), each seen in
    ``track_len`` of ``image_ids`` at random point2D indices."""
    rng = np.random.default_rng(seed)
    image_ids = np.asarray(image_ids, np.int32)
    tracks = np.stack([
        image_ids[rng.integers(0, len(image_ids), n * track_len)],
        rng.integers(0, 10_000, n * track_len, dtype=np.int32)], 1)
    write_points3d_arrays(path, rng.normal(0, 0.5, (n, 3)),
                          rng.integers(0, 256, (n, 3)),
                          rng.random(n) * 2.0, np.full(n, track_len),
                          tracks)


def make_phototourism_scene(root: str, n_images: int = 5, size: int = 32,
                            n_points: int = 200, seed: int = 0,
                            sizes=None) -> None:
    """Miniature-to-brandenburg-shaped phototourism root: dense/sparse
    COLMAP binaries, images, and the scene tsv.

    ``sizes``: optional list of image sizes cycled per image — one COLMAP
    camera per distinct size, exercising the per-image K-rescale path the
    way a real photo collection does.  With the default None, all images
    share one camera at ``size``.  At n_images in the hundreds this is a
    brandenburg-scale reconstruction."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "dense/sparse"), exist_ok=True)
    os.makedirs(os.path.join(root, "dense/images"), exist_ok=True)

    size_cycle = list(sizes) if sizes else [size]
    # PINHOLE [fx, fy, cx, cy]: the layout the dataset's K rescale assumes
    cameras = {
        ci + 1: {"model_id": 1, "width": s, "height": s,
                 "params": [s * 1.2, s * 1.2, s / 2, s / 2]}
        for ci, s in enumerate(size_cycle)}
    write_cameras_binary(cameras,
                         os.path.join(root, "dense/sparse/cameras.bin"))

    images, rows = {}, []
    # image ids deliberately non-contiguous (the dataset takes them from
    # images.bin, not the tsv 'id' column) but bounded like the real
    # scenes: the brandenburg recipe trains 1363 images with --N_vocab
    # 1500, so its sparse ids all fit under 1500.  Skip every 11th
    # integer: max id = n + (n-1)//10 < 1.1*n, i.e. 1499 at n=1363.
    ids = [1 + i + i // 10 for i in range(n_images)]
    for n, iid in enumerate(ids):
        cam_id = (n % len(size_cycle)) + 1
        size = size_cycle[n % len(size_cycle)]
        focal = size * 1.2
        theta = 2 * np.pi * n / n_images
        c2w = _look_at_pose(theta, radius=6.0)
        # COLMAP stores w2c, "right down front" convention; our pose builder
        # is "right up back" — flip y/z axes then invert.
        c2w_cv = c2w.copy()
        c2w_cv[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w_cv)
        R, t = w2c[:3, :3], w2c[:3, 3]
        # rotmat -> quaternion (w, x, y, z), branching on the largest
        # diagonal term so near-trace(-1) rotations stay finite
        tr = np.trace(R)
        if tr > 0:
            s = 2 * np.sqrt(1 + tr)
            w, x, y, z = (s / 4, (R[2, 1] - R[1, 2]) / s,
                          (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s)
        else:
            k = int(np.argmax(np.diag(R)))
            i, j, l = k, (k + 1) % 3, (k + 2) % 3
            s = 2 * np.sqrt(max(0.0, 1 + R[i, i] - R[j, j] - R[l, l]))
            q = [0.0, 0.0, 0.0]
            q[i] = s / 4
            q[j] = (R[j, i] + R[i, j]) / s
            q[l] = (R[l, i] + R[i, l]) / s
            w = (R[l, j] - R[j, l]) / s
            x, y, z = q
        name = f"img_{n:04d}.jpg"
        img = _render_ball(size, c2w, focal)[..., :3]
        write_jpeg(os.path.join(root, "dense/images", name),
                   np.ascontiguousarray(img))
        images[iid] = {"qvec": [w, x, y, z], "tvec": t.tolist(),
                       "camera_id": cam_id, "name": name,
                       "xys": [], "point3D_ids": []}
        split = "test" if n == n_images - 1 else "train"
        rows.append((name, iid, split, "minitour"))
    write_images_binary(images, os.path.join(root, "dense/sparse/images.bin"))

    pts = {}
    xyz = rng.normal(0, 0.5, (n_points, 3))
    for i in range(n_points):
        pts[i + 1] = {"xyz": xyz[i].tolist(),
                      "rgb": rng.integers(0, 255, 3).tolist(),
                      "error": 0.5, "image_ids": [ids[0]],
                      "point2D_idxs": [0]}
    write_points3d_binary(pts, os.path.join(root, "dense/sparse/points3D.bin"))

    with open(os.path.join(root, "minitour.tsv"), "w") as f:
        f.write("filename\tid\tsplit\tdataset\n")
        for name, iid, split, ds in rows:
            f.write(f"{name}\t{iid}\t{split}\t{ds}\n")
