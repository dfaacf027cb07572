"""LLFF (forward-facing capture) dataset, host numpy pipeline.

The port's counterpart of ``nerf_fl_tpu/data/llff.py``, without PIL:
poses_bounds.npy parsed, the "down right back" -> "right up back" axis
permutation, the poses centred on their average pose, the near plane
rescaled to ~1.33, NDC rays for forward-facing scenes (spheric scenes keep
world rays with the bounds as near / far), and the spiral and spheric test
paths.  Images are read by ``image_io.read_rgb`` (PNG or JPEG by their
first bytes, as PIL decides) and resized by ``image_io.resize_lanczos``
(PIL's LANCZOS); the rays are the JAX package's bit for bit.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from .image_io import read_rgb, resize_lanczos
from .rays_np import get_ndc_rays, get_ray_directions, get_rays


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """Average pose: mean centre, mean z (normalised), y from x = y' x z."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray):
    """Re-express all poses relative to the average pose."""
    pose_avg = average_poses(poses)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = (np.linalg.inv(pose_avg_homo) @ poses_homo)[:, :3]
    return poses_centered, pose_avg


def create_spiral_poses(radii, focus_depth, n_poses: int = 120) -> np.ndarray:
    """Two-revolution spiral render path."""
    poses_spiral = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = normalize(center - np.array([0, 0, -focus_depth]))
        y_ = np.array([0, 1, 0])
        x = normalize(np.cross(y_, z))
        y = np.cross(z, x)
        poses_spiral.append(np.stack([x, y, z, center], 1))
    return np.stack(poses_spiral, 0)


def create_spheric_poses(radius, n_poses: int = 120) -> np.ndarray:
    """Circular path with a 36-degree downward view."""

    def spheric_pose(theta, phi, radius):
        trans_t = np.array([[1, 0, 0, 0], [0, 1, 0, -0.9 * radius],
                            [0, 0, 1, radius], [0, 0, 0, 1]])
        rot_phi = np.array([[1, 0, 0, 0],
                            [0, np.cos(phi), -np.sin(phi), 0],
                            [0, np.sin(phi), np.cos(phi), 0],
                            [0, 0, 0, 1]])
        rot_theta = np.array([[np.cos(theta), 0, -np.sin(theta), 0],
                              [0, 1, 0, 0],
                              [np.sin(theta), 0, np.cos(theta), 0],
                              [0, 0, 0, 1]])
        c2w = rot_theta @ rot_phi @ trans_t
        c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0],
                        [0, 1, 0, 0], [0, 0, 0, 1]]) @ c2w
        return c2w[:3]

    return np.stack([spheric_pose(th, -np.pi / 5, radius)
                     for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]], 0)


def _rgb_floats(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, np.float32).reshape(-1, 3) / 255.0


class LLFFDataset:
    def __init__(self, root_dir: str, split: str = "train",
                 img_wh=(504, 378), spheric_poses: bool = False,
                 val_num: int = 1):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.spheric_poses = spheric_poses
        self.val_num = max(1, val_num)
        self.ray_format = "world"
        self.read_meta()
        self.white_back = False

    def _K(self) -> np.ndarray:
        w, h = self.img_wh
        K = np.eye(3, dtype=np.float32)
        K[0, 0] = K[1, 1] = self.focal
        K[0, 2], K[1, 2] = w / 2, h / 2
        return K

    def read_meta(self):
        poses_bounds = np.load(
            os.path.join(self.root_dir, "poses_bounds.npy"))  # (N, 17)
        self.image_paths = sorted(
            glob.glob(os.path.join(self.root_dir, "images/*")))
        if self.split in ("train", "val") and \
                len(poses_bounds) != len(self.image_paths):
            raise ValueError("Mismatch between number of images and number "
                             "of poses! Please rerun COLMAP!")

        poses = poses_bounds[:, :15].reshape(-1, 3, 5)
        self.bounds = poses_bounds[:, -2:]

        H, W, self.focal = poses[0, :, -1]
        self.focal *= self.img_wh[0] / W

        # "down right back" -> "right up back"
        poses = np.concatenate(
            [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
        self.poses, self.pose_avg = center_poses(poses)
        distances = np.linalg.norm(self.poses[..., 3], axis=1)
        self.val_idx = int(np.argmin(distances))

        near_original = self.bounds.min()
        scale_factor = near_original * 0.75  # nearest depth ~1/0.75
        self.bounds /= scale_factor
        self.poses[..., 3] /= scale_factor

        w, h = self.img_wh
        self.directions = get_ray_directions(h, w, self._K())

        if self.split == "train":
            self._bake_train_rays()
        elif self.split == "val":
            self.c2w_val = self.poses[self.val_idx]
            self.image_path_val = self.image_paths[self.val_idx]
        else:
            if self.split.endswith("train"):
                self.poses_test = self.poses
            elif not self.spheric_poses:
                focus_depth = 3.5
                radii = np.percentile(np.abs(self.poses[..., 3]), 90, axis=0)
                self.poses_test = create_spiral_poses(radii, focus_depth)
            else:
                radius = 1.1 * self.bounds.min()
                self.poses_test = create_spheric_poses(radius)

    def _image(self, path: str) -> np.ndarray:
        img = read_rgb(path)
        return _rgb_floats(resize_lanczos(img, self.img_wh))

    def _rays_for_pose(self, c2w: np.ndarray) -> np.ndarray:
        w, h = self.img_wh
        rays_o, rays_d = get_rays(self.directions, c2w.astype(np.float32))
        if not self.spheric_poses:
            near, far = 0.0, 1.0
            rays_o, rays_d = get_ndc_rays(h, w, self.focal, 1.0,
                                          rays_o, rays_d)
        else:
            near = self.bounds.min()
            far = min(8 * near, self.bounds.max())
        n = len(rays_o)
        return np.concatenate([
            rays_o, rays_d,
            np.full((n, 1), near, np.float32),
            np.full((n, 1), far, np.float32)], 1).astype(np.float32)

    def _bake_train_rays(self):
        rays_list, rgb_list, ts_list = [], [], []
        for i, image_path in enumerate(self.image_paths):
            if i == self.val_idx:  # val image held out of training
                continue
            img = read_rgb(image_path)
            if img.shape[0] * self.img_wh[0] != img.shape[1] * self.img_wh[1]:
                raise ValueError(f"{image_path} has different aspect ratio "
                                 f"than img_wh, please check your data!")
            rgb_list.append(_rgb_floats(resize_lanczos(img, self.img_wh)))
            rays = self._rays_for_pose(self.poses[i])
            rays_list.append(rays)
            ts_list.append(np.full((len(rays),), i, np.int32))
        self.all_rays = np.concatenate(rays_list, 0)
        self.all_rgbs = np.concatenate(rgb_list, 0)
        self.all_ts = np.concatenate(ts_list, 0)

    def apply_refined_poses(self, poses_3x4: np.ndarray) -> None:
        """Replace per-image poses with learned / refined ones."""
        self.poses = np.asarray(poses_3x4, np.float32)[:, :3, :4]
        if self.split.endswith("train") and hasattr(self, "poses_test"):
            self.poses_test = self.poses
        if self.split == "val":
            self.c2w_val = self.poses[self.val_idx]

    def __len__(self):
        if self.split == "train":
            return len(self.all_rays)
        if self.split == "val":
            return self.val_num
        return len(self.poses_test)

    def __getitem__(self, idx: int):
        if self.split == "train":
            return {"rays": self.all_rays[idx], "ts": self.all_ts[idx],
                    "rgbs": self.all_rgbs[idx]}
        c2w = self.c2w_val if self.split == "val" else self.poses_test[idx]
        rays = self._rays_for_pose(np.asarray(c2w))
        sample = {"rays": rays, "c2w": np.asarray(c2w, np.float32),
                  "ts": np.zeros((len(rays),), np.int32),
                  "img_wh": np.array(self.img_wh, np.int64)}
        if self.split == "val":
            sample["rgbs"] = self._image(self.image_path_val)
        return sample
