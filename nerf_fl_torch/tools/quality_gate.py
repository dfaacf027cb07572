"""One-command quality regression gate of the port.

Generates the textured synthetic fixture, trains the 7-arm README config
matrix (clean / color / occ / color+occ x {NeRF, NeRF-A, NeRF-U, NeRF-W})
through ``python -m nerf_fl_torch.train``, evaluates every arm and both
NeRF-W conventions (raw a_id=0 and the paper's --optimize_appearance
protocol) through ``python -m nerf_fl_torch.eval``, asserts the reference
table's orderings and margins, and writes QUALITY_GATE.json and a markdown
table into the workdir.

Presets (the recipes and margins of the JAX package's tools/quality_gate.py,
plus ``card``):
  smoke  machinery tier on the CPU: every arm, both eval conventions and
         the artifacts at seconds an arm; sentinel margins.
  quick  CPU-viable reduced scale (4 x 64 MLP, 64^2, 16+16 samples); gates
         the fixture's sanity, reports the head-vs-control margins.
  full   100 views at 200^2, 10 epochs, the flagship MLP at bf16: the card.
  e20    the same at 20 epochs: the card.
  card   the flagship width at bf16 (8 x 256, 64+64 samples, batch 1024,
         steps_per_execution 20) on 10 views at 100^2 for 2 epochs, with a
         --profile_dir window on co_nerfw: chip_smoke.py's run on the card;
         sentinel margins.

The gate resumes: an arm whose final checkpoint exists is not trained
again, and an eval whose log already holds "Mean PSNR" is not run again.
A crashed run overwrites the artifact with a failing one.  Presets with
``platform: "cpu"`` run their children with ``NERF_FL_TORCH_DEVICE=cpu``;
the others run on the card (and raise without one).  ``--jobs N`` runs N
arms at a time (co_nerfw's --optimize_appearance eval after its training).
On the card each arm's training log ends in the fused kernels' count of
its run (``[kernels] ...``), which the artifact keeps under ``kernels``.

Usage:
  python -m nerf_fl_torch.tools.quality_gate --preset smoke
  python -m nerf_fl_torch.tools.quality_gate --preset full \\
      --workdir /data/qgate_full
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))

# Each arm: (name, data_perturb, model flags shared by train+eval).
ARMS = [
    ("clean", [], []),
    ("color_nerf", ["color"], []),
    ("color_nerfa", ["color"], ["--encode_a"]),
    ("occ_nerf", ["occ"], []),
    ("occ_nerfu", ["occ"], ["--encode_t", "--beta_min", "0.1"]),
    ("co_nerf", ["color", "occ"], []),
    ("co_nerfw", ["color", "occ"],
     ["--encode_a", "--encode_t", "--beta_min", "0.1"]),
]

SENTINELS = {"color_nerfa_vs_nerf": -99, "occ_nerfu_vs_nerf": -99,
             "co_nerfw_opta_vs_nerf": -99, "clean_minus_best": -99,
             "perturb_hurts": -99}

PRESETS = {
    # machinery: 1 epoch of a 2 x 32 MLP at 40^2 proves the plumbing
    "smoke": dict(
        n_train=6, n_val=2, n_test=2, native=800, img_wh=40,
        batch=128, epochs=1, samples=(8, 8), mlp=(2, 32),
        dtype="float32", spe=1, platform="cpu", margins=SENTINELS),
    # CPU-viable; the head-vs-control margins need full training scale, so
    # they are reported (None), not gated
    "quick": dict(
        n_train=40, n_val=2, n_test=4, native=800, img_wh=64,
        batch=256, epochs=3, samples=(16, 16), mlp=(4, 64),
        dtype="float32", spe=1, platform="cpu",
        margins={"color_nerfa_vs_nerf": None, "occ_nerfu_vs_nerf": None,
                 "co_nerfw_opta_vs_nerf": None, "clean_minus_best": -0.5,
                 "perturb_hurts": 0.15}),
    "full": dict(
        n_train=100, n_val=4, n_test=8, native=800, img_wh=200,
        batch=1024, epochs=10, samples=(64, 64), mlp=(8, 256),
        dtype="bfloat16", spe=8,
        margins={"color_nerfa_vs_nerf": 1.0, "occ_nerfu_vs_nerf": 4.0,
                 "co_nerfw_opta_vs_nerf": 3.0, "clean_minus_best": -0.5}),
    "e20": dict(
        n_train=100, n_val=4, n_test=8, native=800, img_wh=200,
        batch=1024, epochs=20, samples=(64, 64), mlp=(8, 256),
        dtype="bfloat16", spe=8,
        margins={"color_nerfa_vs_nerf": 1.5, "occ_nerfu_vs_nerf": 6.0,
                 "co_nerfw_opta_vs_nerf": 4.0, "clean_minus_best": -0.5}),
    # the flagship width on the card at a size that trains 7 arms in a
    # minute or two: the machinery and the fused kernels, not the science
    "card": dict(
        n_train=10, n_val=1, n_test=2, native=800, img_wh=100,
        batch=1024, epochs=2, samples=(64, 64), mlp=(8, 256),
        dtype="bfloat16", spe=20, profile="co_nerfw", margins=SENTINELS),
}

T0 = time.perf_counter()

# honesty counters for the artifact: a resume run that re-scores parsed
# logs must be distinguishable from a fresh end-to-end run
STATS = {"arms_trained": 0, "evals_run": 0}
_LOCK = threading.Lock()


def log(msg):
    print(f"[quality_gate +{time.perf_counter() - T0:7.1f}s] {msg}",
          flush=True)


def count(key):
    with _LOCK:
        STATS[key] += 1


def git_sha():
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=_REPO, text=True,
            stderr=subprocess.DEVNULL).strip()
    except Exception:
        return None


def write_artifact(out_json, result):
    """Atomic write stamped with the git SHA and the time, so a stale
    passing artifact cannot pass for a current one; the crash path writes
    a failing artifact through here too."""
    result = dict(result, git_sha=git_sha(),
                  generated_at=time.strftime("%Y-%m-%dT%H:%M:%S%z"),
                  arms_trained=STATS["arms_trained"],
                  evals_run=STATS["evals_run"])
    tmp = out_json + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1)
    os.replace(tmp, out_json)


def child_env(platform=None):
    """The environment of a train / eval child: the port importable from
    any working directory, and the CPU when the preset asks for it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    if platform:
        env["NERF_FL_TORCH_DEVICE"] = platform
    return env


def run_cmd(cmd, logfile, timeout, platform=None, cwd=None):
    with open(logfile, "w") as f:
        p = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                           timeout=timeout, cwd=cwd, env=child_env(platform))
    if p.returncode != 0:
        tail = open(logfile).read()[-2000:]
        raise RuntimeError(
            f"command failed rc={p.returncode}: {' '.join(cmd)}\n"
            f"--- log tail ({logfile}) ---\n{tail}")


def parse_psnr(logfile):
    txt = open(logfile).read()
    m = re.findall(r"Mean PSNR : ([0-9.]+)", txt)
    return float(m[-1]) if m else None


def parse_kernels(logfile):
    """The fused kernels' count of a training run on the card, from the
    last ``[kernels]`` line of its log, and its profiled window; None on
    the CPU."""
    if not os.path.exists(logfile):
        return None
    txt = open(logfile).read()
    m = re.findall(r"\[kernels\] (\d+) sub-steps; fused forward / backward: "
                   r"(\d+) / (\d+) host launches, (\d+) / (\d+) runs", txt)
    if not m:
        return None
    steps, lf, lb, rf, rb = (int(x) for x in m[-1])
    out = {"steps": steps, "launches": [lf, lb], "runs": [rf, rb]}
    w = re.findall(r"\[profiler\] trace of (\d+) steps \(([0-9.]+) s\) "
                   r"written to (\S+)", txt)
    if w:
        out["profile"] = {"steps": int(w[-1][0]), "seconds": float(w[-1][1]),
                          "trace": w[-1][2]}
    return out


def ensure_fixture(ws, p):
    from ..data.synthetic import make_blender_scene
    root = os.path.join(ws, "scene")
    marker = os.path.join(root, "transforms_train.json")
    if os.path.exists(marker):
        log(f"fixture exists: {root}")
        return root
    log(f"generating fixture: {p['n_train']} train views, "
        f"native {p['native']}^2, textured ball")
    make_blender_scene(root, n_train=p["n_train"], n_val=p["n_val"],
                       n_test=p["n_test"], size=p["native"], texture=True)
    return root


def common_flags(scene, p):
    return [
        "--dataset_name", "blender", "--root_dir", scene,
        "--img_wh", str(p["img_wh"]), str(p["img_wh"]),
        "--N_samples", str(p["samples"][0]),
        "--N_importance", str(p["samples"][1]),
        "--mlp_depth", str(p["mlp"][0]), "--mlp_width", str(p["mlp"][1]),
        "--compute_dtype", p["dtype"],
    ]


def train_argv(ws, scene, p, name, perturb, model_flags):
    """The flags of ``nerf_fl_torch.train`` for one arm."""
    argv = common_flags(scene, p) + [
        "--noise_std", "0",
        "--num_epochs", str(p["epochs"]), "--batch_size", str(p["batch"]),
        "--optimizer", "adam", "--lr", "5e-4", "--lr_scheduler", "cosine",
        "--steps_per_execution", str(p["spe"]),
        "--save_path", os.path.join(ws, "ckpts"), "--exp_name", name,
        "--refresh_every", "0"] \
        + (["--data_perturb"] + perturb if perturb else []) + model_flags
    if p.get("profile") == name:
        argv += ["--profile_dir", os.path.join(ws, "profile", name)]
    return argv


def eval_argv(ws, scene, p, name, model_flags, eval_extra=(),
              eval_name=None):
    """The flags of ``nerf_fl_torch.eval`` for one arm's test split."""
    return common_flags(scene, p) + [
        "--split", "test", "--ckpt_path", final_ckpt(ws, p, name),
        "--scene_name", eval_name or name] + model_flags + list(eval_extra)


def final_ckpt(ws, p, name):
    return os.path.join(ws, "ckpts", name, f"epoch={p['epochs'] - 1}.ckpt")


def train_arm(ws, scene, p, name, perturb, model_flags, timeout):
    """Train one arm unless its final checkpoint exists."""
    logs = os.path.join(ws, "logs")
    os.makedirs(logs, exist_ok=True)
    if os.path.exists(final_ckpt(ws, p, name)):
        log(f"train {name}: checkpoint exists, skipping")
        return
    count("arms_trained")
    log(f"train {name}")
    cmd = [sys.executable, "-m", "nerf_fl_torch.train"] + train_argv(
        ws, scene, p, name, perturb, model_flags)
    run_cmd(cmd, os.path.join(logs, f"{name}_train.log"), timeout,
            platform=p.get("platform"), cwd=ws)


def eval_arm(ws, scene, p, name, model_flags, timeout, eval_extra=(),
             eval_name=None):
    """Evaluate one arm unless its log holds a Mean PSNR; the test PSNR.
    eval writes results/<dataset>/<scene> relative to its working
    directory, so it runs from the workdir."""
    eval_name = eval_name or name
    ev_log = os.path.join(ws, "logs", f"{eval_name}_eval.log")
    psnr = parse_psnr(ev_log) if os.path.exists(ev_log) else None
    if psnr is None:
        count("evals_run")
        log(f"eval {eval_name}")
        cmd = [sys.executable, "-m", "nerf_fl_torch.eval"] + eval_argv(
            ws, scene, p, name, model_flags, eval_extra, eval_name)
        run_cmd(cmd, ev_log, timeout, platform=p.get("platform"), cwd=ws)
        psnr = parse_psnr(ev_log)
    if psnr is None:
        raise RuntimeError(f"no Mean PSNR in {ev_log}")
    log(f"  {eval_name}: test PSNR {psnr:.2f}")
    return psnr


OPTA = ("co_nerfw", "co_nerfw_opta", ["--optimize_appearance"])


def run_arms(ws, scene, p, timeout, jobs, psnr):
    """Train and evaluate every arm, ``jobs`` at a time, into ``psnr``;
    the paper-protocol eval re-evaluates the trained co_nerfw checkpoint
    after that arm's training."""
    def one(name, perturb, model_flags):
        train_arm(ws, scene, p, name, perturb, model_flags, timeout)
        psnr[name] = eval_arm(ws, scene, p, name, model_flags, timeout)
        if name == OPTA[0]:
            psnr[OPTA[1]] = eval_arm(ws, scene, p, name, model_flags,
                                     timeout, eval_extra=OPTA[2],
                                     eval_name=OPTA[1])

    if jobs <= 1:
        for arm in ARMS:
            one(*arm)
        return
    # the arm with two evaluations first: its chain is the longest
    order = sorted(ARMS, key=lambda arm: arm[0] != OPTA[0])
    with ThreadPoolExecutor(max_workers=jobs) as pool:
        futures = [pool.submit(one, *arm) for arm in order]
        for f in futures:
            f.result()


def check_orderings(psnr, margins):
    """The reference table's orderings: clean >= every perturbed arm; each
    head beats its plain-NeRF control on the perturbation it is built for;
    NeRF-W via the paper protocol.  A margin of None is report-only: the
    value is recorded but never gates the run."""
    checks = []

    def add(name, lhs, rhs, need):
        checks.append({
            "check": name, "lhs": round(lhs, 2), "rhs": round(rhs, 2),
            "margin": round(lhs - rhs, 2), "required_margin": need,
            "pass": True if need is None else bool(lhs - rhs >= need),
            "gated": need is not None})

    best_perturbed = max(v for k, v in psnr.items() if k != "clean")
    add("clean_ge_all_perturbed", psnr["clean"], best_perturbed,
        margins["clean_minus_best"])
    add("color_nerfa_gt_nerf", psnr["color_nerfa"], psnr["color_nerf"],
        margins["color_nerfa_vs_nerf"])
    add("occ_nerfu_gt_nerf", psnr["occ_nerfu"], psnr["occ_nerf"],
        margins["occ_nerfu_vs_nerf"])
    add("co_nerfw_opta_gt_nerf", psnr["co_nerfw_opta"], psnr["co_nerf"],
        margins["co_nerfw_opta_vs_nerf"])
    # perturbations must actually hurt the plain model (fixture sanity: an
    # occluder off the canvas would leave the occ arms equal to clean)
    hurt = margins.get("perturb_hurts", 0.5)
    add("color_hurts_nerf", psnr["clean"], psnr["color_nerf"], hurt)
    add("occ_hurts_nerf", psnr["clean"], psnr["occ_nerf"], hurt)
    return checks


def markdown_table(psnr, checks, preset):
    rows = [
        ("clean", "NeRF", "clean"),
        ("color", "NeRF", "color_nerf"),
        ("color", "NeRF-A", "color_nerfa"),
        ("occ", "NeRF", "occ_nerf"),
        ("occ", "NeRF-U", "occ_nerfu"),
        ("color+occ", "NeRF", "co_nerf"),
        ("color+occ", "NeRF-W (raw a_id=0)", "co_nerfw"),
        ("color+occ", "NeRF-W (optimize_appearance)", "co_nerfw_opta"),
    ]
    out = [f"### Quality gate — preset `{preset}`", "",
           "| data | model | test PSNR |", "|---|---|---|"]
    out += [f"| {d} | {m} | {psnr[k]:.2f} |" for d, m, k in rows]
    out += ["", "| check | margin (dB) | required | pass |",
            "|---|---|---|---|"]
    for c in checks:
        need = ("—" if c["required_margin"] is None
                else f"{c['required_margin']:+.2f}")
        verdict = (("PASS" if c["pass"] else "FAIL") if c.get("gated", True)
                   else "report")
        out += [f"| {c['check']} | {c['margin']:+.2f} | {need} | "
                f"{verdict} |"]
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="quick")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default <tmp>/quality_gate_torch_"
                         "<preset>); re-running resumes finished arms")
    ap.add_argument("--out", default=None,
                    help="output path for QUALITY_GATE.json "
                         "(default <workdir>/QUALITY_GATE.json)")
    ap.add_argument("--arm_timeout", type=float, default=7200)
    ap.add_argument("--jobs", type=int, default=1,
                    help="arms trained and evaluated at a time")
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    ws = os.path.abspath(args.workdir or os.path.join(
        tempfile.gettempdir(), f"quality_gate_torch_{args.preset}"))
    os.makedirs(ws, exist_ok=True)
    out_json = os.path.abspath(args.out or os.path.join(
        ws, "QUALITY_GATE.json"))

    psnr = {}
    try:
        scene = ensure_fixture(ws, p)
        run_arms(ws, scene, p, args.arm_timeout, args.jobs, psnr)
    except BaseException as e:
        # a crashed run must overwrite any previous (possibly passing)
        # artifact with a failing one, never leave a stale pass behind
        write_artifact(out_json, {
            "preset": args.preset, "pass": False, "error": repr(e),
            "psnr": {k: round(v, 2) for k, v in psnr.items()},
            "wall_s": round(time.perf_counter() - T0, 1), "workdir": ws})
        raise

    checks = check_orderings(psnr, p["margins"])
    ok = all(c["pass"] for c in checks)
    table = markdown_table(psnr, checks, args.preset)
    kernels = {name: parse_kernels(os.path.join(ws, "logs",
                                                f"{name}_train.log"))
               for name, _, _ in ARMS}
    result = {
        "preset": args.preset, "pass": ok,
        "psnr": {k: round(v, 2) for k, v in psnr.items()},
        "checks": checks,
        "recipe": {k: v for k, v in p.items() if k != "margins"},
        "wall_s": round(time.perf_counter() - T0, 1),
        "workdir": ws,
    }
    if any(kernels.values()):
        result["kernels"] = kernels
    write_artifact(out_json, result)
    with open(os.path.join(ws, "QUALITY_GATE.md"), "w") as f:
        f.write(table)
    print(table)
    log(f"{'PASS' if ok else 'FAIL'} — wrote {out_json}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
