"""Generate a synthetic Blender-format scene (no dataset download needed).

An analytic ball, optionally with a checker texture, rendered to the
transforms_{split}.json + PNG layout the Blender loader reads, with the
port's own generator (``data/synthetic.make_blender_scene``, whose PNGs
decode to the JAX package's pixels), so every train / eval / perturbation
feature can be exercised without nerf_synthetic.

Usage:
  python -m nerf_fl_torch.tools.make_fixture /data/demo_scene --train 40 \\
      --size 800 --texture
"""
from argparse import ArgumentParser


def main(argv=None):
    p = ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", help="output scene directory")
    p.add_argument("--train", type=int, default=40,
                   help="number of training views")
    p.add_argument("--val", type=int, default=4)
    p.add_argument("--test", type=int, default=8)
    p.add_argument("--size", type=int, default=800,
                   help="native image size (the seeded occlusion "
                        "perturbation is sized for 800)")
    p.add_argument("--texture", action="store_true",
                   help="checker surface texture (anchors the NeRF-W "
                        "static/appearance decomposition)")
    args = p.parse_args(argv)

    from ..data.synthetic import make_blender_scene
    make_blender_scene(args.root, n_train=args.train, n_val=args.val,
                       n_test=args.test, size=args.size,
                       texture=args.texture)
    print(f"wrote {args.train}+{args.val}+{args.test} views at "
          f"{args.size}x{args.size} to {args.root}")


if __name__ == "__main__":
    main()
