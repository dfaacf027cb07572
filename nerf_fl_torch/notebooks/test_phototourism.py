"""Phototourism PSNR regression (reference test_phototourism.ipynb): renders
train / val views of a COLMAP scene with per-image PSNR; the notebook's
interpolation cells are appearance_interpolation.py.
All flags of psnr_regression may be added:

    python -m nerf_fl_torch.notebooks.test_phototourism --root_dir <scene> \\
        --ckpt_path <ckpt>
"""
import sys

from .psnr_regression import main as regression

PRESET = ['--dataset_name', 'phototourism', '--encode_a', '--encode_t']


def main(argv=None, device=None):
    return regression(PRESET + list(sys.argv[1:] if argv is None else argv),
                      device=device)


if __name__ == '__main__':
    main()
