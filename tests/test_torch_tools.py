"""The port's tools (``nerf_fl_torch/tools/``) against the JAX package's
root ``tools/``, on the CPU.

  * the quality gate's ``check_orderings`` and ``markdown_table`` give the
    root tool's checks and table on the same PSNRs: all passing, a margin
    violation, an occluder off the canvas, a report-only margin;
  * the gate's ``smoke`` preset end to end through ``python -m
    nerf_fl_torch.train`` / ``.eval`` with NERF_FL_TORCH_DEVICE=cpu: 7 arms
    trained and 8 evaluations, the artifacts in the workdir stamped with
    the git sha, a second run that trains and evaluates nothing, and a
    crashed run that overwrites a stale passing artifact; the root
    QUALITY_GATE.json is never written;
  * ``make_fixture`` writes the root tool's transforms and pixels,
    ``gen_nerf_tsv`` the root tool's tsv bytes (and a Phototourism
    scene's own tsv), ``save_weights_only`` a file whose eval equals the
    full checkpoint's, from a port checkpoint and from a JAX one, and
    ``profile_trace`` sums a hand-written Chrome trace.
"""
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_fl_tpu.render import RenderConfig as JRenderConfig
from nerf_fl_tpu.training import checkpoints as jckpt
from nerf_fl_tpu.training import optimizers as jopt
from nerf_fl_tpu.training import system as jsys
from nerf_fl_torch import eval as teval
from nerf_fl_torch.data.synthetic import (make_blender_scene,
                                          make_phototourism_scene)
from nerf_fl_torch.render import RenderConfig
from nerf_fl_torch.tools import (gen_nerf_tsv, make_fixture, profile_trace,
                                 quality_gate, save_weights_only)
from nerf_fl_torch.training import build_params, checkpoints, optimizers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_tool(name):
    """A root tools/ script loaded by path (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"root_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MARGINS = {"color_nerfa_vs_nerf": 1.0, "occ_nerfu_vs_nerf": 4.0,
           "co_nerfw_opta_vs_nerf": 3.0, "clean_minus_best": -0.5}


def _psnr(**over):
    base = {"clean": 25.0, "color_nerf": 21.0, "color_nerfa": 23.0,
            "occ_nerf": 18.0, "occ_nerfu": 23.5, "co_nerf": 17.0,
            "co_nerfw": 16.0, "co_nerfw_opta": 22.0}
    base.update(over)
    return base


# (PSNR overrides, margin overrides, the checks that fail, the verdicts)
GATE_CASES = {
    "all_pass": ({}, {}, [], {"PASS": 6}),
    # NeRF-A only +0.5 over plain NeRF on color data; +1.0 required
    "margin_violation": ({"color_nerfa": 21.5}, {}, ["color_nerfa_gt_nerf"],
                         {"PASS": 5, "FAIL": 1}),
    # an occluder off the canvas leaves the occ arms at the clean PSNR
    "offcanvas_occluder": ({"occ_nerf": 25.0, "occ_nerfu": 25.0}, {},
                           ["occ_nerfu_gt_nerf", "occ_hurts_nerf"],
                           {"PASS": 4, "FAIL": 2}),
    # a None margin is reported, never gated
    "report_only": ({"color_nerfa": 19.0}, {"color_nerfa_vs_nerf": None},
                    [], {"PASS": 5, "report": 1}),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_checks_match_the_root_tool(case):
    over, m_over, failing, verdicts = GATE_CASES[case]
    root = _root_tool("quality_gate")
    psnr, margins = _psnr(**over), dict(MARGINS, **m_over)
    checks = quality_gate.check_orderings(psnr, margins)
    assert checks == root.check_orderings(psnr, margins)
    assert [c["check"] for c in checks if not c["pass"]] == failing
    md = quality_gate.markdown_table(psnr, checks, "quick")
    assert md == root.markdown_table(psnr, checks, "quick")
    for verdict, n in verdicts.items():
        assert md.count(f"| {verdict} |") == n
    assert "NeRF-W (optimize_appearance)" in md
    if case == "report_only":
        c = [c for c in checks if c["check"] == "color_nerfa_gt_nerf"][0]
        assert c["pass"] is True and c["gated"] is False
        assert c["margin"] == -2.0           # still reported


def test_gate_presets_keep_the_root_tool_recipes():
    """Every root preset, recipe and margins, with the CPU's platform named
    for the port's environment; ``card`` is the port's own."""
    root = _root_tool("quality_gate")
    assert quality_gate.ARMS == root.ARMS
    assert set(quality_gate.PRESETS) == set(root.PRESETS) | {"card"}
    for name, p in root.PRESETS.items():
        assert quality_gate.PRESETS[name] == p, name
    card = quality_gate.PRESETS["card"]
    assert (card["mlp"], card["samples"], card["dtype"], card["batch"],
            card["spe"]) == ((8, 256), (64, 64), "bfloat16", 1024, 20)
    assert card["margins"] == root.PRESETS["smoke"]["margins"]
    assert "platform" not in card and card["profile"] == "co_nerfw"


def _gate(ws, *extra, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return subprocess.run(
        [sys.executable, "-m", "nerf_fl_torch.tools.quality_gate",
         "--preset", "smoke", "--workdir", str(ws), *extra],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT, env=env)


def test_port_quality_gate_smoke_trains_every_arm_and_resumes(tmp_path):
    """7 arms trained and 8 evaluations through the port's CLIs on the CPU,
    4 arms at a time; the artifacts in the workdir; a second run trains
    and evaluates nothing."""
    root_artifact = open(os.path.join(ROOT, "QUALITY_GATE.json"), "rb").read()
    ws, out = tmp_path / "ws", tmp_path / "gate.json"
    r = _gate(ws, "--out", str(out), "--jobs", "4", "--arm_timeout", "500")
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    res = json.loads(out.read_text())
    assert res["pass"] is True                 # smoke margins are sentinels
    assert set(res["psnr"]) == {
        "clean", "color_nerf", "color_nerfa", "occ_nerf", "occ_nerfu",
        "co_nerf", "co_nerfw", "co_nerfw_opta"}
    assert all(v > 5 for v in res["psnr"].values())
    assert len(res["checks"]) == 6
    assert (ws / "QUALITY_GATE.md").exists()
    assert "kernels" not in res                # no card, no kernel counts
    git = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, text=True,
                         capture_output=True)
    head = git.stdout.strip() if git.returncode == 0 else None
    assert res["git_sha"] == head and res["generated_at"]
    assert res["arms_trained"] == 7 and res["evals_run"] == 8
    for name, _, _ in quality_gate.ARMS:
        assert (ws / "ckpts" / name / "epoch=0.ckpt").exists()
    assert (ws / "results" / "blender" / "co_nerfw_opta").is_dir()
    # the resume: nothing trained or evaluated; the artifact defaults to
    # the workdir, never the repo's root
    r2 = _gate(ws, "--arm_timeout", "60", timeout=300)
    assert r2.returncode == 0, (r2.stdout[-2000:], r2.stderr[-2000:])
    assert r2.stdout.count("checkpoint exists, skipping") == 7
    res2 = json.loads((ws / "QUALITY_GATE.json").read_text())
    assert res2["arms_trained"] == 0 and res2["evals_run"] == 0
    assert res2["psnr"] == res["psnr"]
    assert open(os.path.join(ROOT, "QUALITY_GATE.json"),
                "rb").read() == root_artifact


def test_port_quality_gate_crash_overwrites_a_stale_pass(tmp_path):
    out = tmp_path / "QUALITY_GATE.json"
    out.write_text(json.dumps({"pass": True, "stale": True}))
    # arm_timeout too small for any training command: TimeoutExpired
    r = _gate(tmp_path / "ws", "--out", str(out), "--arm_timeout", "0.2",
              timeout=300)
    assert r.returncode != 0
    res = json.loads(out.read_text())
    assert res["pass"] is False and "stale" not in res
    assert "TimeoutExpired" in res["error"] and "git_sha" in res
    assert res["arms_trained"] == 1 and res["evals_run"] == 0


def test_make_fixture_matches_the_root_tool(tmp_path):
    args = ["--train", "3", "--val", "1", "--test", "1", "--size", "32",
            "--texture"]
    ref, got = tmp_path / "ref", tmp_path / "got"
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "make_fixture.py"),
                        str(ref), *args], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    make_fixture.main([str(got), *args])
    for split, n in (("train", 3), ("val", 1), ("test", 1)):
        name = f"transforms_{split}.json"
        assert json.loads((got / name).read_text()) == \
            json.loads((ref / name).read_text())
        for i in range(n):
            a = np.asarray(Image.open(got / split / f"r_{i}.png"))
            b = np.asarray(Image.open(ref / split / f"r_{i}.png"))
            assert a.shape == b.shape == (32, 32, 4)
            assert np.array_equal(a, b)


def test_gen_nerf_tsv_matches_the_root_tool(tmp_path):
    root = str(tmp_path / "tour")
    make_phototourism_scene(root, n_images=6, sizes=[24, 16], n_points=20)
    for extra in ([], ["--n_test", "2", "--dataset_name", "brandenburg"]):
        ref, got = str(tmp_path / "ref.tsv"), str(tmp_path / "got.tsv")
        r = subprocess.run([sys.executable, os.path.join(
            ROOT, "tools", "gen_nerf_tsv.py"), "--root_dir", root, "--out",
            ref, *extra], capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        assert gen_nerf_tsv.main(["--root_dir", root, "--out", got,
                                  *extra]) == got
        assert open(got, "rb").read() == open(ref, "rb").read()
    # the scene's own tsv: its last image held out, dataset "minitour"
    gen_nerf_tsv.main(["--root_dir", root, "--out", got, "--n_test", "1",
                       "--dataset_name", "minitour"])
    assert open(got, "rb").read() == \
        open(os.path.join(root, "minitour.tsv"), "rb").read()


KW = dict(N_samples=4, N_importance=4, encode_a=True, encode_t=True,
          mlp_depth=2, mlp_width=16)
MODEL = ["--img_wh", "24", "24", "--N_samples", "4", "--N_importance", "4",
         "--mlp_depth", "2", "--mlp_width", "16", "--encode_a", "--encode_t",
         "--N_vocab", "6"]


@pytest.mark.parametrize("source", ["port", "jax"])
def test_save_weights_only_keeps_what_eval_reads(tmp_path, monkeypatch,
                                                 source):
    """A full checkpoint (with its Adam state) of either format, stripped:
    the slim file holds the same weights, epoch and step and no optimizer
    state, and eval on it gives the full checkpoint's PSNR exactly."""
    make_blender_scene(str(tmp_path / "scene"), n_train=2, n_val=1,
                       n_test=2, size=24)
    full = str(tmp_path / "full.ckpt")
    h = type("H", (), dict(optimizer="adam", lr=1e-3, weight_decay=0.0))
    if source == "port":
        params = build_params(RenderConfig(**KW), 6, device="cpu",
                              generator=torch.Generator().manual_seed(3))
        leaves = [p for _, p in optimizers.named_leaves(params)]
        opt = optimizers.build_optimizer(h, leaves)
        for p in leaves:
            p.grad = torch.randn_like(p)
        opt.step()
        checkpoints.save_checkpoint(full, params, opt, epoch=4,
                                    global_step=11)
    else:
        jp = jsys.build_params(jax.random.PRNGKey(3), JRenderConfig(**KW), 6)
        jckpt.save_checkpoint(full, jp, jopt.build_optimizer(h).init(jp),
                              epoch=4, global_step=11)
    slim = save_weights_only.main(["--ckpt_path", full])
    assert slim == str(tmp_path / "full_weights.ckpt")
    assert os.path.getsize(slim) < os.path.getsize(full)
    a, b = checkpoints.load_checkpoint(full), checkpoints.load_checkpoint(slim)
    assert b["format"] == "torch" and "opt_state" not in b
    assert (b["epoch"], b["global_step"]) == (4, 11)
    assert a["state_dict"].keys() == b["state_dict"].keys()
    for k, v in a["state_dict"].items():
        w = b["state_dict"][k]
        if isinstance(v, dict):
            assert v.keys() == w.keys()
            assert all(torch.equal(v[n], w[n]) for n in v)
        else:
            assert torch.equal(v, w)
    monkeypatch.chdir(tmp_path)
    psnr = [teval.main(teval.get_opts(
        ["--root_dir", "scene", "--split", "test", "--ckpt_path", path,
         "--scene_name", name, *MODEL]), device="cpu")
        for name, path in (("full", full), ("slim", slim))]
    assert np.isfinite(psnr[0]) and psnr[0] == psnr[1]


def test_profile_trace_sums_a_hand_written_trace(tmp_path, capsys):
    """Two sub-steps of F F B B with an elementwise kernel on another
    stream overlapping one of them, a memcpy and a CPU op beside: the
    kernels' total, the busy union over the span, the fused counts and
    the per-step table."""
    def k(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "pid": 0, "tid": 7}

    fwd = "void fused_mlp_fwd_bf16_kernel<1>(Params)"
    bwd = "void fused_mlp_bwd_kernel<true>(Params)"
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
               "dur": 500, "pid": 1, "tid": 1},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
               "ts": 5, "dur": 50, "pid": 0, "tid": 8}]
    t = 100
    for _ in range(2):
        for name, dur in ((fwd, 10), (fwd, 20), (bwd, 30), (bwd, 40)):
            events.append(k(name, t, dur))
            t += dur + 5
    events.append(k("elementwise_kernel", 110, 30))   # overlaps 20 us
    d = tmp_path / "prof"
    d.mkdir()
    (d / "trace.json").write_text(json.dumps({"traceEvents": events}))
    res = profile_trace.main(["--trace_dir", str(tmp_path), "--steps", "2",
                              "--top", "3"])
    out = capsys.readouterr().out
    assert res["kernels"] == 9 and res["total_us"] == 230
    assert (res["fused_fwd"], res["fused_bwd"]) == (4, 4)
    span = t - 5 - 100
    assert res["span_us"] == span and res["busy_us"] == 230 - 20
    assert res["busy_share"] == pytest.approx(210 / span)
    assert "fused kernels: forward 4, backward 4 (2 + 2 a step)" in out
    assert "device kernel total: 0.115 ms/step (2 steps)" in out
    lines = out.split("top 3 device kernels")[1].strip().splitlines()[1:]
    assert len(lines) == 3 and " B void fused_mlp_bwd" in lines[0]
    assert profile_trace.find_trace(str(d / "trace.json")) == \
        str(d / "trace.json")
    with pytest.raises(SystemExit):
        profile_trace.find_trace(str(tmp_path / "none"))
