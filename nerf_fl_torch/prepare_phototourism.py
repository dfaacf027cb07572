"""Ray-cache builder for Phototourism scenes, the counterpart of the root
prepare_phototourism.py:

    python -m nerf_fl_torch.prepare_phototourism --root_dir <scene> \
        --img_downscale 2

Writes the same cache files, with the same names and contents, as the JAX
package's script: img_ids.pkl, img_to_cam_id.pkl, image_paths.pkl,
Ks{d}.pkl, xyz_world.npy, poses.npy, nears.pkl, fars.pkl, rays{d}.npy (6
columns [dir, near, far, id]) and rgbs{d}.npy, the pickles at
``pickle.HIGHEST_PROTOCOL``; either package reads the other's cache.  Host
work only (numpy and the standard library): it needs no card.
"""
import argparse
import os
import pickle

import numpy as np

from .data.phototourism import PhototourismDataset


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--root_dir', type=str, required=True,
                        help='root directory of dataset')
    parser.add_argument('--img_downscale', type=int, default=1,
                        help='how much to downscale the images for '
                             'phototourism dataset')
    return parser.parse_args(argv)


def main(args) -> PhototourismDataset:
    os.makedirs(os.path.join(args.root_dir, 'cache'), exist_ok=True)
    print(f'Preparing cache for scale {args.img_downscale}...')
    dataset = PhototourismDataset(args.root_dir, 'train', args.img_downscale)

    def path(name):
        return os.path.join(args.root_dir, 'cache', name)

    def dump(name, obj):
        with open(path(name), 'wb') as f:
            pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)

    dump('img_ids.pkl', dataset.img_ids)
    dump('img_to_cam_id.pkl', dataset.image_to_cam)
    dump('image_paths.pkl', dataset.image_paths)
    dump(f'Ks{args.img_downscale}.pkl', dataset.Ks)
    np.save(path('xyz_world.npy'), dataset.xyz_world)
    np.save(path('poses.npy'), dataset.poses)
    dump('nears.pkl', dataset.nears)
    dump('fars.pkl', dataset.fars)
    np.save(path(f'rays{args.img_downscale}.npy'),
            dataset.reference_format_rays())
    np.save(path(f'rgbs{args.img_downscale}.npy'), dataset.all_rgbs)
    print(f"Data cache saved to {os.path.join(args.root_dir, 'cache')} !")
    return dataset


if __name__ == '__main__':
    main(get_opts())
