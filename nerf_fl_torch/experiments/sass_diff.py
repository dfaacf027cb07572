"""Compare the machine code of this checkout's CUDA kernels with another's.

    python3 nerf_fl_torch/experiments/sass_diff.py OTHER_ROOT \
        [--src NAME ...] [--pair OLD=NEW ...]

Builds ``csrc/<NAME>.cu`` (default: every source) in both checkouts, each
in a process of its own that imports that checkout's ``nerf_fl_torch``,
dumps each library with ``cuobjdump -sass`` and compares every kernel
found in both under the same name, instruction for instruction.  The
anonymous namespace's name carries a hash of the file, so it is masked
first.  ``--pair OLD=NEW`` also compares the kernel of OTHER_ROOT whose
name holds OLD with this checkout's kernel whose name holds NEW (a kernel
that was renamed or became a template's instantiation).  Prints one line a
source and a pair, and last one JSON object.  Needs nvcc and cuobjdump.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parents[2]
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_[0-9]+_\w+?_cu_[0-9a-f]{8}")


def libraries(root: Path, srcs) -> Dict[str, str]:
    """Source name -> library path, built from ``root``'s sources."""
    code = (f"import json, sys\nsys.path.insert(0, {str(root)!r})\n"
            "from nerf_fl_torch.ops import _build\n"
            f"assert _build.__file__.startswith({str(root)!r})\n"
            f"lib = _build.build({list(srcs)!r})\n"
            "print(json.dumps({k: str(v) for k, v in lib.items()}))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def kernels(lib: str) -> Dict[str, str]:
    """Kernel name (namespace hash masked) -> its SASS, each line's runs
    of blanks made one (cuobjdump pads the instruction column to the
    widest of the whole library, so a kernel added beside another moves
    the other's padding, not its code)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", ANON.sub("ANON", text))
    return {parts[i]: "\n".join(" ".join(line.split())
                                for line in parts[i + 1].strip().splitlines())
            for i in range(1, len(parts), 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--src", nargs="*", default=None,
                    help="csrc/<NAME>.cu to compare (default: all)")
    ap.add_argument("--pair", action="append", default=[],
                    help="OLD=NEW: kernel names (substrings) to compare")
    a = ap.parse_args(argv)
    other = Path(a.other).resolve()
    srcs = a.src or sorted(p.stem for p in (HERE / "nerf_fl_torch" / "csrc")
                           .glob("*.cu"))
    old = libraries(other, srcs)
    new = libraries(HERE, srcs)
    res = {"sources": {}, "pairs": {}}
    funcs = {}
    for src in srcs:
        x, y = kernels(old[src]), kernels(new[src])
        funcs[src] = (x, y)
        both = sorted(set(x) & set(y))
        differ = [k for k in both if x[k] != y[k]]
        res["sources"][src] = {"identical": len(both) - len(differ),
                               "differ": differ,
                               "only_other": sorted(set(x) - set(y)),
                               "only_here": sorted(set(y) - set(x))}
        print(f"[sass] {src}: {len(both)} kernels in both, "
              f"{len(both) - len(differ)} identical, {len(differ)} differ; "
              f"{len(set(x) - set(y))} only in {other.name}, "
              f"{len(set(y) - set(x))} only here", flush=True)
    for pair in a.pair:
        o, n = pair.split("=")
        xs = {k: v for x, _ in funcs.values() for k, v in x.items() if o in k}
        ys = {k: v for _, y in funcs.values() for k, v in y.items() if n in k}
        if len(xs) != 1 or len(ys) != 1:
            raise SystemExit(f"--pair {pair}: {len(xs)} / {len(ys)} kernels "
                             f"match, not one each")
        xo, yn = next(iter(xs.values())), next(iter(ys.values()))
        res["pairs"][pair] = {"identical": xo == yn,
                              "lines": [len(xo.splitlines()),
                                        len(yn.splitlines())]}
        print(f"[sass] {o} ({other.name}) vs {n} (here): "
              f"{len(xo.splitlines())} / {len(yn.splitlines())} lines, "
              f"identical {xo == yn}", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
