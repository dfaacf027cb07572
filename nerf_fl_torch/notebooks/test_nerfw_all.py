"""Full NeRF-W PSNR regression (reference test_nerfw_all.ipynb): color+occ
perturbed lego, appearance + transient.
All flags of psnr_regression may be added:

    python -m nerf_fl_torch.notebooks.test_nerfw_all --root_dir <scene> \\
        --ckpt_path <ckpt>
"""
import sys

from .psnr_regression import main as regression

PRESET = ['--data_perturb', 'color', 'occ', '--encode_a', '--encode_t']


def main(argv=None, device=None):
    return regression(PRESET + list(sys.argv[1:] if argv is None else argv),
                      device=device)


if __name__ == '__main__':
    main()
