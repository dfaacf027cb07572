"""NeRF-A PSNR regression (reference test_nerfa_color.ipynb): color-perturbed
lego, appearance embeddings.
All flags of psnr_regression may be added:

    python -m nerf_fl_torch.notebooks.test_nerfa_color --root_dir <scene> \\
        --ckpt_path <ckpt>
"""
import sys

from .psnr_regression import main as regression

PRESET = ['--data_perturb', 'color', '--encode_a']


def main(argv=None, device=None):
    return regression(PRESET + list(sys.argv[1:] if argv is None else argv),
                      device=device)


if __name__ == '__main__':
    main()
