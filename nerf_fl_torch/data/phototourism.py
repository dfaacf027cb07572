"""Phototourism (COLMAP photo-collection) dataset, host numpy pipeline.

The port's counterpart of ``nerf_fl_tpu/data/phototourism.py``, without
PIL or pandas:
  * the scene's *.tsv (read with the ``csv`` module, rows whose ``id`` is
    empty or one of pandas' missing-value strings dropped, as pandas'
    ``isnull`` drops them) drives the train / test split; image ids come
    from images.bin;
  * per-camera intrinsics rescaled by --img_downscale in the JAX package's
    arithmetic order;
  * w2c -> c2w in one batched inverse, with the "right down front" ->
    "right up back" flip;
  * per-image near / far from the 0.1 / 99.9 percentiles of the points in
    front of the camera, rescaled so that the largest far plane is 5; the
    points are read by the native decoder (``colmap_native``, the pure-Python
    reader where no C compiler is found), and ``stage_s`` keeps the host
    seconds of that read (``points``) and of the near / far loop
    (``near_far``), timed by the spans ``nerf.data.points`` and
    ``nerf.data.near_far``;
  * train rays stored as camera-frame directions + [near, far] (``ray_format
    "camdir"``), posed on the device from the learned-pose table, with the
    image ids in an int32 ``all_ts``;
  * val forces img_downscale >= 2 and repeats one image val_num times;
  * the cache of ``prepare_phototourism`` (pickles and .npy files of the
    same names and contents as the JAX package's, memory-mapped where they
    are large; ``Ks{d}.pkl`` computed when that scale has none).
Images are read by ``image_io.read_rgb`` (JPEG or PNG, PIL's pixels) and
resized by ``image_io.resize_lanczos`` (PIL's LANCZOS).  The test split
renders the poses and intrinsics that eval sets (``poses_test``,
``test_K``, ``test_img_w`` / ``test_img_h``, ``test_appearance_idx``).
"""
from __future__ import annotations

import csv
import glob
import os
import pickle
from typing import Dict, List

import numpy as np

from .colmap import read_cameras_binary, read_images_binary
from .colmap_native import read_points3d_arrays
from .image_io import read_rgb, resize_lanczos
from .rays_np import get_ray_directions, get_rays
from ..utils.spans import span

# the strings pandas' read_csv reads as missing by default
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
       "nan", "null"}


def read_scene_tsv(path: str) -> List[Dict[str, str]]:
    """The scene tsv's rows as dicts, those without an id dropped."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    head = rows[0]
    out = [dict(zip(head, r + [""] * (len(head) - len(r)))) for r in rows[1:]
           if r]
    return [r for r in out if r["id"] not in _NA]


class PhototourismDataset:
    def __init__(self, root_dir: str, split: str = "train",
                 img_downscale: int = 1, val_num: int = 1,
                 use_cache: bool = False, refine_pose: bool = False):
        if img_downscale < 1:
            raise ValueError("image can only be downsampled, please set "
                             "img_downscale>=1!")
        self.root_dir = root_dir
        self.split = split
        self.refine_pose = refine_pose
        self.img_downscale = img_downscale
        if split == "val":  # downscale 1 at val would take much host memory
            self.img_downscale = max(2, self.img_downscale)
        self.val_num = max(1, val_num)
        self.use_cache = use_cache
        self.ray_format = "camdir"  # pose composed on the device
        self.stage_s: Dict[str, float] = {}
        self.read_meta()
        self.white_back = False

    # ------------------------------------------------------------------
    def _cache(self, name: str) -> str:
        return os.path.join(self.root_dir, "cache", name)

    def _load(self, name: str):
        with open(self._cache(name), "rb") as f:
            return pickle.load(f)

    def read_meta(self):
        tsv = glob.glob(os.path.join(self.root_dir, "*.tsv"))[0]
        self.scene_name = os.path.basename(tsv)[:-4]
        self.files = read_scene_tsv(tsv)

        if self.use_cache:
            self.img_ids = self._load("img_ids.pkl")
            self.image_to_cam = self._load("img_to_cam_id.pkl")
            self.image_paths = self._load("image_paths.pkl")
        else:
            imdata = read_images_binary(
                os.path.join(self.root_dir, "dense/sparse/images.bin"))
            img_path_to_id = {v.name: v.id for v in imdata.values()}
            self.image_to_cam = {v.id: v.camera_id for v in imdata.values()}
            self.img_ids = []
            self.image_paths: Dict[int, str] = {}
            for row in self.files:
                id_ = img_path_to_id[row["filename"]]
                self.image_paths[id_] = row["filename"]
                self.img_ids.append(id_)

        # intrinsics, rescaled per image and keyed by camera id; a scale
        # with no cached Ks (val forces img_downscale >= 2) computes them
        ks_cache = self._cache(f"Ks{self.img_downscale}.pkl")
        if self.use_cache and os.path.exists(ks_cache):
            self.Ks = self._load(f"Ks{self.img_downscale}.pkl")
        else:
            self.Ks = {}
            camdata = read_cameras_binary(
                os.path.join(self.root_dir, "dense/sparse/cameras.bin"))
            for id_ in self.img_ids:
                cam_id = self.image_to_cam[id_]
                cam = camdata[cam_id]
                # PINHOLE (fx, fy, cx, cy), principal point at the centre:
                # cx * 2 / cy * 2 are the full-size dimensions; each
                # intrinsic scales by its axis's (downscaled / full) ratio
                img_w, img_h = int(cam.params[2] * 2), int(cam.params[3] * 2)
                img_w_ = img_w // self.img_downscale
                img_h_ = img_h // self.img_downscale
                K = np.zeros((3, 3), dtype=np.float32)
                K[0, [0, 2]] = cam.params[[0, 2]] * img_w_ / img_w
                K[1, [1, 2]] = cam.params[[1, 3]] * img_h_ / img_h
                K[2, 2] = 1
                self.Ks[cam_id] = K

        # camera-to-world poses, flipped into "right up back"
        if self.use_cache:
            self.poses = np.load(self._cache("poses.npy"))
        else:
            w2c_mats = np.stack(
                [np.block([[imdata[i].qvec2rotmat(),
                            imdata[i].tvec.reshape(3, 1)],
                           [np.zeros((1, 3)), np.ones((1, 1))]])
                 for i in self.img_ids])
            self.poses = np.linalg.inv(w2c_mats)[:, :3]
            self.poses[..., 1:3] *= -1

        # per-image near / far, then one rescale pinning the largest far to 5
        if self.use_cache:
            self.xyz_world = np.load(self._cache("xyz_world.npy"))
            self.nears = self._load("nears.pkl")
            self.fars = self._load("fars.pkl")
        else:
            with span("nerf.data.points") as points:
                self.xyz_world = read_points3d_arrays(
                    os.path.join(self.root_dir,
                                 "dense/sparse/points3D.bin")).xyz
            with span("nerf.data.near_far") as near_far:
                xyz_h = np.concatenate(
                    [self.xyz_world, np.ones((len(self.xyz_world), 1))], -1)
                self.nears, self.fars = {}, {}
                for i, id_ in enumerate(self.img_ids):
                    xyz_cam = (xyz_h @ w2c_mats[i].T)[:, :3]
                    # in front of the camera
                    xyz_cam = xyz_cam[xyz_cam[:, 2] > 0]
                    self.nears[id_] = np.percentile(xyz_cam[:, 2], 0.1)
                    self.fars[id_] = np.percentile(xyz_cam[:, 2], 99.9)
                max_far = np.fromiter(self.fars.values(), np.float32).max()
                scale = max_far / 5
                self.poses[..., 3] /= scale
                for k in self.nears:
                    self.nears[k] /= scale
                for k in self.fars:
                    self.fars[k] /= scale
                self.xyz_world /= scale
            self.stage_s = {"points": points.seconds,
                            "near_far": near_far.seconds}

        self.poses_dict = {id_: self.poses[i]
                           for i, id_ in enumerate(self.img_ids)}

        # train / test membership from the scene tsv
        self.img_ids_train = [id_ for i, id_ in enumerate(self.img_ids)
                              if self.files[i]["split"] == "train"]
        self.img_ids_test = [id_ for i, id_ in enumerate(self.img_ids)
                             if self.files[i]["split"] == "test"]
        self.N_images_train = len(self.img_ids_train)
        self.N_images_test = len(self.img_ids_test)

        if self.split == "train":
            self._bake_train_rays()
        elif self.split in ("val", "test_train"):
            self.val_id = self.img_ids_train[0]
        # 'test': poses_test / test_K set by eval

    def _image(self, id_: int):
        """(rgbs (H W, 3) float32, W, H) of an image at this scale."""
        img = read_rgb(os.path.join(self.root_dir, "dense/images",
                                    self.image_paths[id_]))
        img_h, img_w = img.shape[:2]
        if self.img_downscale > 1:
            img_w //= self.img_downscale
            img_h //= self.img_downscale
            img = resize_lanczos(img, (img_w, img_h))
        return np.asarray(img, np.float32).reshape(-1, 3) / 255.0, img_w, \
            img_h

    def _bake_train_rays(self):
        if self.use_cache:
            # memory-mapped: at img_downscale 1 the ray cache is tens of GB
            all_rays = np.load(self._cache(f"rays{self.img_downscale}.npy"),
                               mmap_mode="r")
            all_rgbs = np.load(self._cache(f"rgbs{self.img_downscale}.npy"),
                               mmap_mode="r")
            # the cache's 6 columns: [dir, near, far, id]
            self.all_rays = all_rays[:, :5]
            self.all_ts = np.asarray(all_rays[:, 5], np.int32)
            self.all_rgbs = all_rgbs
            return
        rays_list, rgb_list, ts_list = [], [], []
        for id_ in self.img_ids_train:
            rgbs, img_w, img_h = self._image(id_)
            rgb_list.append(rgbs)
            directions = get_ray_directions(
                img_h, img_w, self.Ks[self.image_to_cam[id_]]).reshape(-1, 3)
            n = len(directions)
            rays_list.append(np.concatenate([
                directions,
                np.full((n, 1), self.nears[id_], np.float32),
                np.full((n, 1), self.fars[id_], np.float32)], 1))
            ts_list.append(np.full((n,), id_, np.int32))
        self.all_rays = np.concatenate(rays_list, 0).astype(np.float32)
        self.all_rgbs = np.concatenate(rgb_list, 0).astype(np.float32)
        self.all_ts = np.concatenate(ts_list, 0)

    def reference_format_rays(self) -> np.ndarray:
        """(N, 6) [dir, near, far, id]: the cache file's layout."""
        return np.concatenate(
            [self.all_rays, self.all_ts[:, None].astype(np.float32)], 1)

    def apply_refined_poses(self, poses_3x4: np.ndarray) -> None:
        """Replace the poses with learned / refined ones."""
        self.poses = np.asarray(poses_3x4, np.float32)[:, :3, :4]
        self.poses_dict = {id_: self.poses[i]
                           for i, id_ in enumerate(self.img_ids)}

    # ------------------------------------------------------------------
    def __len__(self):
        if self.split == "train":
            return len(self.all_rays)
        if self.split == "test_train":
            return self.N_images_train
        if self.split == "val":
            return self.val_num
        return len(self.poses_test)

    def __getitem__(self, idx: int):
        if self.split == "train":
            return {"rays": self.all_rays[idx], "ts": self.all_ts[idx],
                    "rgbs": self.all_rgbs[idx]}

        if self.split in ("val", "test_train"):
            id_ = self.val_id if self.split == "val" \
                else self.img_ids_train[idx]
            c2w = self.poses_dict[id_].astype(np.float32)
            rgbs, img_w, img_h = self._image(id_)
            directions = get_ray_directions(
                img_h, img_w, self.Ks[self.image_to_cam[id_]])
            rays_o, rays_d = get_rays(directions, c2w)
            n = len(rays_o)
            rays = np.concatenate([
                rays_o, rays_d,
                np.full((n, 1), self.nears[id_], np.float32),
                np.full((n, 1), self.fars[id_], np.float32)], 1)
            return {"rays": rays, "ts": np.full((n,), id_, np.int32),
                    "rgbs": rgbs, "c2w": c2w,
                    "img_wh": np.array([img_w, img_h], np.int64)}

        # 'test': the path eval sets
        c2w = np.asarray(self.poses_test[idx], np.float32)
        directions = get_ray_directions(
            self.test_img_h, self.test_img_w, self.test_K)
        rays_o, rays_d = get_rays(directions, c2w)
        n = len(rays_o)
        near, far = 0.0, 5.0
        rays = np.concatenate([
            rays_o, rays_d,
            np.full((n, 1), near, np.float32),
            np.full((n, 1), far, np.float32)], 1)
        return {"rays": rays,
                "ts": np.full((n,), self.test_appearance_idx, np.int32),
                "c2w": c2w,
                "img_wh": np.array([self.test_img_w, self.test_img_h],
                                   np.int64)}
