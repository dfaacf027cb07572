"""Build the port's native helper, the COLMAP points decoder
(``nerf_fl_torch/csrc/colmap_fast.c``), into ``nerf_fl_torch/_build/``.

    python -m nerf_fl_torch.tools.build_native

The counterpart of the root ``tools/build_native.py``.  Building ahead is
optional: ``data/colmap_native.py`` builds the library at its first use,
and reads with the pure-Python reader (saying so in one line) where no C
compiler is found.
"""


def main(argv=None):
    del argv        # no flags, as the root tools/build_native.py
    from ..data import colmap_native
    out = colmap_native.build()
    print(f"built {out}")
    return out


if __name__ == "__main__":
    main()
