"""Generate a phototourism-style scene tsv from a COLMAP reconstruction.

    python -m nerf_fl_torch.tools.gen_nerf_tsv --root_dir <scene> \\
        [--dataset_name phototourism] [--n_test 0] [--out <scene>.tsv]

Writes filename / id / split / dataset rows, sorted by file name; the ids
come from ``dense/sparse/images.bin`` (the port's COLMAP reader,
``data/colmap.py``), the split is train but for an optional held-out
tail of ``--n_test`` images.
"""
import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument('--root_dir', required=True,
                   help='scene root containing dense/sparse/images.bin')
    p.add_argument('--dataset_name', default='phototourism')
    p.add_argument('--out', default=None,
                   help='output tsv path (default <root>/<scene>.tsv)')
    p.add_argument('--n_test', type=int, default=0,
                   help='hold out the last N images as the test split')
    args = p.parse_args(argv)

    from ..data.colmap import read_images_binary
    imdata = read_images_binary(
        os.path.join(args.root_dir, 'dense/sparse/images.bin'))
    rows = sorted((v.name, v.id) for v in imdata.values())
    scene = os.path.basename(args.root_dir.rstrip('/'))
    out = args.out or os.path.join(args.root_dir, f'{scene}.tsv')
    with open(out, 'w') as f:
        f.write('filename\tid\tsplit\tdataset\n')
        for i, (name, id_) in enumerate(rows):
            split = 'test' if i >= len(rows) - args.n_test and args.n_test \
                else 'train'
            f.write(f'{name}\t{id_}\t{split}\t{args.dataset_name}\n')
    print(f'wrote {len(rows)} rows to {out}')
    return out


if __name__ == '__main__':
    main()
