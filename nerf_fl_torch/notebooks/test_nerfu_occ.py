"""NeRF-U PSNR regression (reference test_nerfu_occ.ipynb): occlusion-
perturbed lego, transient head.
All flags of psnr_regression may be added:

    python -m nerf_fl_torch.notebooks.test_nerfu_occ --root_dir <scene> \\
        --ckpt_path <ckpt>
"""
import sys

from .psnr_regression import main as regression

PRESET = ['--data_perturb', 'occ', '--encode_t']


def main(argv=None, device=None):
    return regression(PRESET + list(sys.argv[1:] if argv is None else argv),
                      device=device)


if __name__ == '__main__':
    main()
