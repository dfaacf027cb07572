"""Blender-synthetic dataset (NeRF-W perturbed variant), host numpy pipeline.

The port's counterpart of ``nerf_fl_tpu/data/blender.py``, without PIL:
frames are read by ``image_io.read_rgba`` (PIL's ``convert("RGBA")``),
perturbed at the file's own size (``perturbations.add_perturbation``, PIL's
bytes), resized by ``image_io.resize_lanczos`` (PIL's LANCZOS) and blended
to white.  transforms_{split}.json, the focal from camera_angle_x at the
800 px native width, near/far 2/6, every training frame but index 0
perturbed, and the train split's pre-baked flat ray buffer are the JAX
package's.  Rays are world-space ('world' format), except on the train
split under pose refinement: there each ray is its camera-frame direction
with near and far ('camdir', 5 columns), posed inside the train step from
the learned-pose table.  ``apply_refined_poses`` puts learned poses in
place of the frames' own for eval.  With ``mip`` (``--model mipnerf``) every
split's rays are mip-NeRF's, 9 columns [o, d, radius, near, far]: through
the pixel centres, the direction not normalised, each cone's base radius
(``rays_np.get_cone_rays``; google/mipnerf's Blender loader).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np

from .image_io import read_rgba, resize_lanczos
from .perturbations import add_perturbation
from .rays_np import (blend_alpha_to_white, get_cone_rays,
                      get_ray_directions, get_rays)


def _to_rgba_floats(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, np.float32).reshape(-1, 4) / 255.0


class BlenderDataset:
    """Map-style dataset; the train split exposes flat ray buffers for the
    random-gather batch sampler."""

    def __init__(self, root_dir: str, split: str = "train",
                 img_wh=(800, 800), perturbation: Sequence[str] = (),
                 refine_pose: bool = False, mip: bool = False):
        assert img_wh[0] == img_wh[1], "image width must equal image height!"
        assert set(perturbation).issubset({"color", "occ"}), \
            'Only "color" and "occ" perturbations are supported!'
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.perturbation = list(perturbation)
        self.refine_pose = refine_pose
        self.mip = mip
        if mip and refine_pose:
            raise ValueError("mip-NeRF's rays have no pose refinement")
        self._refined = False           # apply_refined_poses sets it
        self.ray_format = "camdir" if (refine_pose and split == "train") \
            else "world"
        self.white_back = True
        self.read_meta()

    def read_meta(self):
        name = f"transforms_{self.split.split('_')[-1]}.json"
        with open(os.path.join(self.root_dir, name)) as f:
            self.meta = json.load(f)

        w, h = self.img_wh
        # native focal at W=800, rescaled to img_wh
        self.focal = 0.5 * 800 / np.tan(0.5 * self.meta["camera_angle_x"])
        self.focal *= w / 800
        self.K = np.eye(3, dtype=np.float32)
        self.K[0, 0] = self.K[1, 1] = self.focal
        self.K[0, 2] = w / 2
        self.K[1, 2] = h / 2
        if self.mip:
            # through the pixel centres, as mip-NeRF's loader casts them
            self.K[0, 2] -= 0.5
            self.K[1, 2] -= 0.5

        self.near, self.far = 2.0, 6.0
        self.bounds = np.array([self.near, self.far], np.float32)
        self.directions = get_ray_directions(h, w, self.K)  # (h, w, 3)

        self.poses = np.stack(
            [np.asarray(f["transform_matrix"], np.float32)[:3, :4]
             for f in self.meta["frames"]], 0)
        self.poses_dict: Dict[int, np.ndarray] = {
            t: self.poses[t] for t in range(len(self.poses))}
        self.Ks = {t: self.K for t in range(len(self.poses))}
        self.n_images = len(self.meta["frames"])

        if self.split == "train":
            self._bake_train_rays()

    def _frame(self, frame) -> np.ndarray:
        return read_rgba(os.path.join(self.root_dir,
                                      f"{frame['file_path']}.png"))

    def _bake_train_rays(self):
        w, h = self.img_wh
        n_px = h * w
        rays_list, rgbs_list = [], []
        flat_dirs = self.directions.reshape(-1, 3)
        for t, frame in enumerate(self.meta["frames"]):
            img = self._frame(frame)
            if t != 0:  # the first image is never perturbed
                img = add_perturbation(img, self.perturbation, t)
            img = resize_lanczos(img, self.img_wh)
            rgbs_list.append(blend_alpha_to_white(_to_rgba_floats(img)))
            bounds = [np.full((n_px, 1), self.near, np.float32),
                      np.full((n_px, 1), self.far, np.float32)]
            if self.mip:
                rays_list.append(np.concatenate(
                    [get_cone_rays(self.directions, self.poses[t])] + bounds,
                    1))
            elif self.ray_format == "world":
                rays_list.append(np.concatenate(
                    list(get_rays(flat_dirs, self.poses[t])) + bounds, 1))
            else:       # the pose is applied in the train step
                rays_list.append(np.concatenate([flat_dirs] + bounds, 1))

        self.all_rays = np.concatenate(rays_list, 0).astype(np.float32)
        self.all_rgbs = np.concatenate(rgbs_list, 0).astype(np.float32)
        self.all_ts = np.repeat(
            np.arange(self.n_images, dtype=np.int32), n_px)

    def apply_refined_poses(self, poses_3x4: np.ndarray) -> None:
        """Put learned poses (N, >=3, 4) in place of the frames' own:
        frame ``idx`` then renders from ``poses[idx]`` (eval's
        --refine_pose on test_train)."""
        self.poses = np.asarray(poses_3x4, np.float32)[:, :3, :4]
        self.poses_dict = {t: self.poses[t] for t in range(len(self.poses))}
        self._refined = True

    def __len__(self):
        if self.split == "train":
            return len(self.all_rays)
        if self.split == "val":
            return min(8, len(self.meta["frames"]))
        return len(self.meta["frames"])

    def __getitem__(self, idx: int):
        if self.split == "train":
            return {"rays": self.all_rays[idx], "ts": self.all_ts[idx],
                    "rgbs": self.all_rgbs[idx]}

        frame = self.meta["frames"][idx]
        if self._refined and idx < len(self.poses):
            c2w = self.poses[idx]
        else:
            c2w = np.asarray(frame["transform_matrix"], np.float32)[:3, :4]
        t = 0  # no perturbation at val/test

        img = self._frame(frame)
        if self.split == "test_train" and idx != 0:
            t = idx
            img = add_perturbation(img, self.perturbation, idx)
        img = resize_lanczos(img, self.img_wh)
        rgba = _to_rgba_floats(img)
        valid_mask = rgba[:, 3] > 0

        cast = get_cone_rays(self.directions, c2w) if self.mip \
            else np.concatenate(get_rays(self.directions, c2w), 1)
        n_px = len(cast)
        rays = np.concatenate([
            cast,
            np.full((n_px, 1), self.near, np.float32),
            np.full((n_px, 1), self.far, np.float32)], 1)

        sample = {"rays": rays,
                  "ts": np.full((n_px,), t, np.int32),
                  "rgbs": blend_alpha_to_white(rgba),
                  "c2w": c2w,
                  "valid_mask": valid_mask}

        if self.split == "test_train" and self.perturbation:
            rgba = _to_rgba_floats(resize_lanczos(self._frame(frame),
                                                  self.img_wh))
            sample["original_rgbs"] = blend_alpha_to_white(rgba)
            sample["original_valid_mask"] = rgba[:, 3] > 0
        return sample
