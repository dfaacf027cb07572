"""The stage split (`benchmark/stages.py`) and the readers of the program's
stage marks and host spans, on windows made by hand: each stage's self
time, the marks' records and the kernels outside every segment left out,
the fused kernels kept out of the `*_other` metrics, and None wherever one
sub-step or chunk lacks a mark.  Last, the marks the program makes on the
CPU, laid out as a window, split as the readers need."""
import ast
import types

import numpy as np
import pytest
import torch

from benchmark import spec, stages, trace

FWD = "void fused_mlp_fwd_f32_kernel(float const*)"
BWD = ["(anonymous namespace)::tb::fused_mlp_bwd_f32_kernel(x)",
       "tb::wgrad_f32_kernel(y)", "tb::reduce_dw_tree(z)"]
# device us of each stage's own small kernel
US = {s: 10 * (i + 1) for i, s in enumerate(stages.POSED_SUB_STEP
                                            + stages.CHUNK[:1])}


def rec(name, ts, dur, stream=7):
    return {"name": name, "ts": ts, "dur": dur, "cat": "kernel",
            "args": {"device": 0, "stream": stream}}


def segment(t, need, drop=(), fused=True):
    """The records of one segment from `t`: each stage's mark (1 us), its
    own kernel (US[stage] us) and, in the MLP stages and the backward, the
    fused kernels; returns (records, end time)."""
    out = []
    for s in need:
        if s in drop:
            continue
        out.append(rec(f"nerf_mark_{s}", t, 1))
        t += 1
        if s == "end":
            break
        out.append(rec(f"k_{s}", t, US[s]))
        t += US[s]
        if fused and s in ("coarse_mlp", "fine_mlp"):
            out.append(rec(FWD, t, 100))
            t += 100
        if fused and s == "backward":
            for name, dur in zip(BWD, (200, 30, 5)):
                out.append(rec(name, t, dur))
                t += dur
    return out, t


def window(need, n, drop_in=None, drop=(), host=(), fused=True):
    """`n` segments after a fill that lies outside them, then another fill
    after the last; the `drop_in`-th segment loses the marks `drop`."""
    ks = [rec("fill", 0, 3)]
    t = 5
    for i in range(n):
        seg, t = segment(t, need, drop if i == drop_in else (), fused)
        ks += seg
    ks.append(rec("clone", t + 1, 2))
    host = [{"name": trace.WINDOW_SPAN, "ts": 0, "dur": t + 10, "ph": "X"}] \
        + list(host)
    runs = (sum(k["name"] == FWD for k in ks),
            sum(k["name"] == BWD[0] for k in ks))
    return trace.Window(1e-3, ks, host, (0, t + 10), runs)


def cell(name, chunks_per_frame=2):
    conf = [c for c in spec.benchmark()["configs"] if c["name"] == name][0]
    return types.SimpleNamespace(config=spec.load_json(spec.ROOT
                                                       / conf["file"]),
                                 chunks_per_frame=chunks_per_frame)


LEGO, BARF = cell("nerfw_lego"), cell("barf_brandenburg")


def read(metric, w, c):
    return spec.reader(metric).read(w, c)


def test_split_keeps_each_stage_and_leaves_marks_and_outside_out():
    w = window(stages.SUB_STEP, 2)
    w.counts = {"sub_steps": 2}
    segs = stages.sub_steps(w, LEGO)
    assert len(segs) == 2
    for seg in segs:
        assert "end" not in seg
        assert not any(stages.stage_of(k) for ks in seg.values() for k in ks)
        assert [k["name"] for k in seg["loss"]] == ["k_loss"]
        assert [k["name"] for k in seg["fine_mlp"]] == ["k_fine_mlp", FWD]
        assert len(seg["backward"]) == 4
    total = sum(k["dur"] for k in w.kernels)
    marks = sum(k["dur"] for k in w.kernels if stages.stage_of(k))
    inside = sum(k["dur"] for s in segs for ks in s.values() for k in ks)
    assert marks == 2 * len(stages.SUB_STEP)
    assert total - marks - inside == 3 + 2       # the fill and the clone
    assert stages.ms(segs, ["optimizer"], 2) == pytest.approx(
        US["optimizer"] / 1e3)


def test_train_readers_on_a_window():
    w = window(stages.SUB_STEP, 3)
    w.counts = {"sub_steps": 3}
    fwd = sum(US[s] for s in stages.FORWARD) / 1e3
    assert read("forward_other_ms.train", w, LEGO) == pytest.approx(fwd)
    assert read("backward_other_ms.train", w, LEGO) == \
        pytest.approx(US["backward"] / 1e3)
    assert read("optimizer_ms.train", w, LEGO) == \
        pytest.approx(US["optimizer"] / 1e3)
    assert read("pose_ms.train", w, LEGO) is None
    # the stages and the fused pair make up step_other_ms but for the
    # marks, the row stage and what lies outside the sub-steps
    other = read("step_other_ms.train", w, LEGO)
    parts = fwd + (US["backward"] + US["optimizer"] + US["row"]) / 1e3
    marks = len(stages.SUB_STEP) / 1e3
    assert other == pytest.approx(parts + marks + 5 / 3 / 1e3)

    w = window(stages.POSED_SUB_STEP, 2)
    w.counts = {"sub_steps": 2}
    assert read("pose_ms.train", w, BARF) == \
        pytest.approx((US["pose"] + US["pose_backward"]) / 1e3)
    assert read("forward_other_ms.train", w, BARF) == pytest.approx(fwd)


@pytest.mark.parametrize("drop", [("loss",), ("load",), ("end",),
                                  ("pose_backward",)])
def test_train_readers_read_nothing_when_a_sub_step_lacks_a_mark(drop):
    w = window(stages.POSED_SUB_STEP, 3, drop_in=1, drop=drop)
    w.counts = {"sub_steps": 3}
    for m in ("pose_ms.train", "forward_other_ms.train",
              "backward_other_ms.train", "optimizer_ms.train"):
        assert read(m, w, BARF) is None, m


def test_train_readers_read_nothing_without_marks_or_at_another_count():
    w = window(stages.SUB_STEP, 2)
    w.counts = {"sub_steps": 3}
    assert read("optimizer_ms.train", w, LEGO) is None
    # the parent's window: no mark at all
    w = window(stages.SUB_STEP, 2)
    w.kernels = [k for k in w.kernels if not stages.stage_of(k)]
    w.counts = {"sub_steps": 2}
    assert read("forward_other_ms.train", w, LEGO) is None
    # a lego sub-step read as BARF's lacks the pose marks
    w = window(stages.SUB_STEP, 2)
    w.counts = {"sub_steps": 2}
    assert read("optimizer_ms.train", w, BARF) is None


def test_marks_split_per_stream():
    a, t = segment(0, stages.SUB_STEP)
    b, _ = segment(3, stages.SUB_STEP)
    for k in b:
        k["args"]["stream"] = 9
    ks = sorted(a + b, key=lambda k: k["ts"])
    assert len(stages.split(ks, stages.SUB_STEP, 2)) == 2
    assert stages.split(ks, stages.SUB_STEP, 1) is None


def host_span(name, ts, dur):
    return {"name": name, "ts": ts, "dur": dur, "ph": "X",
            "cat": "user_annotation"}


def test_render_readers_on_a_window():
    spans = [host_span("nerf.render.upload", 10, 400),
             host_span("nerf.render.upload", 20, 200),
             host_span("nerf.render.readback", 30, 1000),
             host_span("nerf.render.upload", -50, 7000)]   # before the window
    w = window(stages.CHUNK, 4, host=spans, fused=False)
    w.counts = {"frames": 2}
    assert read("sampling_ms.render", w, LEGO) == \
        pytest.approx(2 * (US["sample"] + US["pdf"]) / 1e3)
    assert read("composite_ms.render", w, LEGO) == pytest.approx(
        2 * (US["coarse_composite"] + US["fine_composite"]) / 1e3)
    assert read("upload_ms.render", w, LEGO) == pytest.approx(0.3)
    assert read("readback_ms.render", w, LEGO) == pytest.approx(0.5)
    # the parent's window: no mark, no span
    w = window(stages.CHUNK, 4, fused=False)
    w.kernels = [k for k in w.kernels if not stages.stage_of(k)]
    w.counts = {"frames": 2}
    for m in ("sampling_ms.render", "composite_ms.render",
              "upload_ms.render", "readback_ms.render"):
        assert read(m, w, LEGO) is None, m


def test_render_readers_read_nothing_when_a_chunk_lacks_a_mark():
    w = window(stages.CHUNK, 4, drop_in=3, drop=("pdf",), fused=False)
    w.counts = {"frames": 2}
    assert read("sampling_ms.render", w, LEGO) is None
    assert read("composite_ms.render", w, LEGO) is None


def test_stages_take_no_code_from_the_program():
    tree = ast.parse((spec.HERE / "stages.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert "nerf_fl_torch" not in names


@pytest.mark.parametrize("barf", [False, True], ids=["lego", "barf"])
def test_the_programs_marks_split_as_the_readers_need(monkeypatch, barf):
    """Two sub-steps of the program's K-step on the CPU, each mark it makes
    laid out as a kernel record with one small kernel after it."""
    from nerf_fl_torch.render import RenderConfig, renderer
    from nerf_fl_torch.training import optimizers, system
    from nerf_fl_torch.utils import spans
    seen = []
    for mod in (spans, system, renderer):
        monkeypatch.setattr(mod, "mark", lambda s, d: seen.append(s))
    cfg = RenderConfig(N_samples=4, N_importance=4, mlp_depth=2,
                       mlp_width=16, encode_a=True, encode_t=True,
                       refine_pose=barf, perturb=0.0, noise_std=0.0)
    init = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)) if barf else None
    params = system.build_params(cfg, 4, device="cpu", init_poses=init,
                                 generator=torch.Generator().manual_seed(0))
    mask = optimizers.make_trainable_mask(params, barf)
    for name, p in optimizers.named_leaves(params):
        p.requires_grad_(mask[name])
    opt = optimizers.build_optimizer(
        types.SimpleNamespace(optimizer="adam", lr=5e-4, weight_decay=0.0),
        optimizers.param_groups(params, mask))
    step = system.make_device_pool_step(
        cfg, opt, batch_size=8, steps_per_execution=2,
        **({"ray_format": "camdir"} if barf else {}))
    n = 16
    d = torch.nn.functional.normalize(torch.randn(
        n, 3, generator=torch.Generator().manual_seed(1)), dim=-1)
    nf = torch.tensor([[2.0, 6.0]]).expand(n, 2)
    rays = torch.cat([d, nf] if barf else [d * 0.1, d, nf], 1)
    pool = {"rays": rays, "ts": torch.zeros(n, dtype=torch.int32),
            "rgbs": 0.5 + 0.4 * d}
    step(params, pool, torch.arange(n, dtype=torch.int32), 0, 2, 5e-4)
    ks, t = [], 0
    for s in seen:
        ks += [rec(f"nerf_mark_{s}", t, 1), rec(f"k_{s}", t + 1, 2)]
        t += 3
    w = trace.Window(1e-3, ks, [], (0, t), (0, 0))
    w.counts = {"sub_steps": 2}
    c = BARF if barf else LEGO
    assert read("optimizer_ms.train", w, c) == pytest.approx(2e-3)
    assert (read("pose_ms.train", w, c) is not None) == barf


def test_unnamed_gaps_say_where_the_host_was():
    ks = [rec("a", 0, 10), rec("b", 500, 10), rec("c", 600, 10)]
    host = [host_span("nerf.step", 0, 20), host_span("aten::item", 480, 40),
            host_span("nerf.step", 530, 60)]
    w = trace.Window(1e-3, ks, host, (0, 700), (0, 0))
    assert stages.unnamed_gaps(w) == [
        {"ms": 0.49, "at_ms": 0.01, "after": "nerf.step",
         "before": "aten::item"}]
    assert stages.unnamed_gaps(w, least_us=50) == [
        {"ms": 0.49, "at_ms": 0.01, "after": "nerf.step",
         "before": "aten::item"},
        {"ms": 0.09, "at_ms": 0.61, "after": "nerf.step", "before": None}]
