"""COLMAP sparse-reconstruction readers (binary and text).

The port's copy of ``nerf_fl_tpu/data/colmap.py``: each file is read once
into memory and decoded with ``struct.unpack_from`` / ``np.frombuffer``;
``qvec2rotmat`` / ``rotmat2qvec``; and ``read_points3d_arrays``, the
pure-Python columnar points reader (``nerf_fl_tpu/data/colmap_native.py``'s
``_python_fallback``), the reference of the C decoder in
``colmap_native.py`` and its path where no C compiler is found.
"""
from __future__ import annotations

import collections
import os
import struct
from typing import Dict, NamedTuple, Optional

import numpy as np

CameraModel = collections.namedtuple(
    "CameraModel", ["model_id", "model_name", "num_params"])
Camera = collections.namedtuple(
    "Camera", ["id", "model", "width", "height", "params"])
BaseImage = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"])
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])

CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


class Image(BaseImage):
    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


def qvec2rotmat(q) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x**2 - 2 * y**2]])


def rotmat2qvec(R) -> np.ndarray:
    """3x3 rotation -> (w, x, y, z) quaternion via the eigen decomposition of
    the symmetric K matrix."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R).flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    cameras = {}
    for _ in range(n):
        cid, model_id, w, h = struct.unpack_from("<iiQQ", buf, off)
        off += 24
        np_ = CAMERA_MODEL_IDS[model_id].num_params
        params = np.frombuffer(buf, "<f8", np_, off).copy()
        off += 8 * np_
        cameras[cid] = Camera(cid, CAMERA_MODEL_IDS[model_id].model_name,
                              w, h, params)
    return cameras


def read_images_binary(path: str) -> Dict[int, Image]:
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    images = {}
    for _ in range(n):
        vals = struct.unpack_from("<idddddddi", buf, off)
        off += 64
        iid, qvec, tvec, cam_id = vals[0], np.array(vals[1:5]), \
            np.array(vals[5:8]), vals[8]
        end = buf.index(b"\x00", off)
        name = buf[off:end].decode("utf-8")
        off = end + 1
        (n2d,) = struct.unpack_from("<Q", buf, off)
        off += 8
        rec = np.frombuffer(buf, np.dtype("<f8,<f8,<i8"), n2d, off)
        off += 24 * n2d
        xys = np.column_stack([rec["f0"], rec["f1"]])
        p3d = rec["f2"].astype(np.int64)
        images[iid] = Image(iid, qvec, tvec, cam_id, name, xys, p3d)
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    points = {}
    head = struct.Struct("<QdddBBBd")
    for _ in range(n):
        pid, x, y, z, r, g, b, err = head.unpack_from(buf, off)
        off += 43
        (tl,) = struct.unpack_from("<Q", buf, off)
        off += 8
        track = np.frombuffer(buf, "<i4", 2 * tl, off)
        off += 8 * tl
        points[pid] = Point3D(pid, np.array([x, y, z]), np.array([r, g, b]),
                              np.array(err), track[0::2].astype(np.int64),
                              track[1::2].astype(np.int64))
    return points


# ---------------------------------------------------------------- text
def read_cameras_text(path: str) -> Dict[int, Camera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line[0] == "#":
                continue
            e = line.split()
            cameras[int(e[0])] = Camera(
                int(e[0]), e[1], int(e[2]), int(e[3]),
                np.array([float(v) for v in e[4:]]))
    return cameras


def read_images_text(path: str) -> Dict[int, Image]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() and ln[0] != "#"]
    for i in range(0, len(lines), 2):
        e = lines[i].split()
        iid = int(e[0])
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([[float(pts[j]), float(pts[j + 1])]
                        for j in range(0, len(pts), 3)])
        p3d = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)])
        images[iid] = Image(iid, np.array([float(v) for v in e[1:5]]),
                            np.array([float(v) for v in e[5:8]]),
                            int(e[8]), e[9], xys, p3d)
    return images


def read_points3D_text(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line[0] == "#":
                continue
            e = line.split()
            pid = int(e[0])
            points[pid] = Point3D(
                pid, np.array([float(v) for v in e[1:4]]),
                np.array([int(v) for v in e[4:7]]), float(e[7]),
                np.array([int(v) for v in e[8::2]]),
                np.array([int(v) for v in e[9::2]]))
    return points


def read_model(path: str, ext: str):
    if ext == ".txt":
        return (read_cameras_text(os.path.join(path, "cameras" + ext)),
                read_images_text(os.path.join(path, "images" + ext)),
                read_points3D_text(os.path.join(path, "points3D" + ext)))
    return (read_cameras_binary(os.path.join(path, "cameras" + ext)),
            read_images_binary(os.path.join(path, "images" + ext)),
            read_points3d_binary(os.path.join(path, "points3D" + ext)))


# ---------------------------------------------------------------- columnar
class Points3DArrays(NamedTuple):
    ids: np.ndarray        # (n,) int64
    xyz: np.ndarray        # (n, 3) float64
    rgb: np.ndarray        # (n, 3) uint8
    error: np.ndarray      # (n,) float64
    track_len: np.ndarray  # (n,) int64
    tracks: Optional[np.ndarray]  # (sum(track_len), 2) int32 or None


def read_points3d_arrays(path: str, *, with_tracks: bool = False
                         ) -> Points3DArrays:
    """Columnar points3D.bin decode in Python: ids, xyz, rgb, error, track
    lengths and (with ``with_tracks``) the (image id, point2D index)
    pairs."""
    with open(path, "rb") as f:
        return points3d_from_bytes(f.read(), with_tracks, path)


def points3d_from_bytes(buf: bytes, with_tracks: bool = False,
                        path: str = "<bytes>") -> Points3DArrays:
    """``read_points3d_arrays`` of a file's bytes.  A truncated stream
    raises ``ValueError``, as the C decoder's reader does."""
    if len(buf) < 8:
        raise ValueError(f"corrupt points3D file: {path}")
    (n,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    ids = np.empty(n, np.int64)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    error = np.empty(n, np.float64)
    track_len = np.empty(n, np.int64)
    track_chunks = []
    head = struct.Struct("<QdddBBBd")
    for i in range(n):
        if off + 51 > len(buf):
            raise ValueError(f"corrupt points3D file: {path}")
        pid, x, y, z, r, g, b, err = head.unpack_from(buf, off)
        ids[i] = pid
        xyz[i] = (x, y, z)
        rgb[i] = (r, g, b)
        error[i] = err
        (tl,) = struct.unpack_from("<Q", buf, off + 43)
        track_len[i] = tl
        off += 51
        if off + 8 * tl > len(buf):
            raise ValueError(f"corrupt points3D file: {path}")
        if with_tracks:
            track_chunks.append(np.frombuffer(buf, "<i4", 2 * tl, off))
        off += 8 * tl
    tracks = (np.concatenate(track_chunks).reshape(-1, 2)
              if with_tracks and track_chunks else
              (np.empty((0, 2), np.int32) if with_tracks else None))
    return Points3DArrays(ids, xyz, rgb, error, track_len, tracks)
