"""The port's tracing (``nerf_fl_torch/utils/spans.py``) on the CPU.

  * under a CPU ``torch.profiler``, the top-level spans cover the whole of
    a call: every operator that the device-pool K-step runs lies inside its
    ``nerf.step``, every one of ``render_chunked_async`` inside
    ``nerf.render.frame`` and every one of ``finish()`` inside
    ``nerf.render.finish``; the span store counts each call;
  * the stage marks come in the order that the benchmark's stage split
    (``benchmark/stages.py``) reads, a sub-step from ``load`` to ``end``
    (with ``pose`` and ``pose_backward`` under pose refinement) and a
    render chunk from ``upload`` to ``end``;
  * ``mark`` does nothing on the CPU (it never loads the marks' library)
    and refuses a stage it does not know;
  * the pose mark returns its input and its gradient bit for bit;
  * the store's counts and seconds, also when many threads add to it.
The marks on the card, in a replayed CUDA graph: tests/test_torch_cuda.py.
"""
import json
import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from nerf_fl_torch.render import RenderConfig, renderer
from nerf_fl_torch.training import optimizers, system
from nerf_fl_torch.utils import spans

B, K = 32, 3
KW = dict(N_samples=8, N_importance=8, encode_a=True, encode_t=True,
          white_back=True, perturb=0.0, noise_std=0.0, beta_min=0.1,
          mlp_depth=4, mlp_width=32)
SUB_STEP = ["load", "sample", "coarse_mlp", "coarse_composite", "pdf",
            "fine_mlp", "fine_composite", "loss", "backward", "optimizer",
            "row", "end"]
POSED_SUB_STEP = SUB_STEP[:1] + ["pose"] + SUB_STEP[1:9] \
    + ["pose_backward"] + SUB_STEP[9:]
CHUNK = ["upload"] + SUB_STEP[1:7] + ["end"]


def _pool_step(barf=False):
    """The narrow NeRF-W's device-pool K-step on the CPU (with ``barf``:
    camera-frame rays posed from a trained table of 4 cameras), its
    params, pool and order."""
    cfg = RenderConfig(refine_pose=barf, barf_epoch_start=0,
                       barf_epoch_end=2, **KW)
    init = None
    if barf:
        init = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
        init[:, :3, 3] = [[4, 0, 1], [0, 4, 1], [-4, 0, 1], [0, -4, 1]]
    params = system.build_params(cfg, 8, device="cpu", init_poses=init,
                                 generator=torch.Generator().manual_seed(0))
    mask = optimizers.make_trainable_mask(params, barf)
    for name, p in optimizers.named_leaves(params):
        p.requires_grad_(mask[name])
    opt = optimizers.build_optimizer(
        types.SimpleNamespace(optimizer="adam", lr=5e-4, weight_decay=0.0),
        optimizers.param_groups(params, mask))
    kw = dict(ray_format="camdir") if barf else {}
    step = system.make_device_pool_step(cfg, opt, batch_size=B,
                                        steps_per_execution=K, **kw)
    n = 3 * K * B
    rng = np.random.default_rng(0)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nf = np.tile(np.float32([2, 6]), (n, 1))
    rays = np.concatenate([d, nf], 1) if barf else \
        np.concatenate([rng.normal(0, 1, (n, 3)).astype(np.float32), d, nf],
                       1)
    pool = {"rays": torch.from_numpy(rays),
            "ts": torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)),
            "rgbs": torch.from_numpy(0.5 + 0.4 * d)}
    perm = torch.arange(n, dtype=torch.int32)
    return params, step, pool, perm


def _render_case():
    cfg = RenderConfig(**KW).eval_variant()
    params = system.build_params(cfg, 8, device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    n = 40
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.normal(0, 1, (n, 3)), d,
                           np.tile([2.0, 6.0], (n, 1))], 1).astype(np.float32)
    return params, cfg, rays, np.zeros(n, np.int64)


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)
    return [e for e in events.get("traceEvents", events)
            if e.get("ph") == "X"]


def _within(inner, outer):
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner.get("dur", 0) <= outer["ts"] + outer["dur"]


def _covers(events, call, name):
    """The one span ``name`` inside the event ``call``, after checking that
    it holds every operator that ``call`` holds."""
    inside = [e for e in events if e["name"] == name and _within(e, call)]
    assert len(inside) == 1, (name, len(inside))
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and _within(e, call)]
    assert ops and all(_within(o, inside[0]) for o in ops)
    return inside[0]


def _counts(before, names):
    after = spans.STORE.totals()
    return [after.get(n, (0, 0.0))[0] - before.get(n, (0, 0.0))[0]
            for n in names]


def test_step_span_covers_the_pool_k_step(tmp_path):
    params, step, pool, perm = _pool_step()
    step(params, pool, perm, 0, 3 * K, 5e-4)
    before = spans.STORE.totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i0 in (K, 2 * K):
            with record_function("test.call"):
                step(params, pool, perm, i0, 3 * K, 5e-4)
    events = _events(prof, tmp_path)
    calls = [e for e in events if e["name"] == "test.call"]
    assert len(calls) == 2
    for call in calls:
        outer = _covers(events, call, "nerf.step")
        for name in ("nerf.step.prepare", "nerf.step.eager",
                     "nerf.step.rows"):
            assert len([e for e in events if e["name"] == name
                        and _within(e, outer)]) == 1
    assert _counts(before, ["nerf.step", "nerf.step.prepare",
                            "nerf.step.eager", "nerf.step.rows",
                            "nerf.step.replay"]) == [2, 2, 2, 2, 0]


def test_render_spans_cover_the_frame_and_its_finish(tmp_path):
    params, cfg, rays, ts = _render_case()
    before = spans.STORE.totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.dispatch"):
            finish = system.render_chunked_async(
                params, rays, ts, cfg, chunk=16, inflight=2,
                keys=("rgb_fine",), device="cpu")
        with record_function("test.finish"):
            out = finish()
    events = _events(prof, tmp_path)
    [dispatch] = [e for e in events if e["name"] == "test.dispatch"]
    [fin] = [e for e in events if e["name"] == "test.finish"]
    frame = _covers(events, dispatch, "nerf.render.frame")
    tail = _covers(events, fin, "nerf.render.finish")
    # 3 chunks of 16 (the last padded), 2 in flight: 2 read back inside
    # the frame, the last one by finish()
    assert len([e for e in events if e["name"] == "nerf.render.upload"
                and _within(e, frame)]) == 3
    assert [len([e for e in events if e["name"] == "nerf.render.readback"
                 and _within(e, outer)]) for outer in (frame, tail)] == [2, 1]
    assert out["rgb_fine"].shape == (40, 3)
    assert _counts(before, ["nerf.render.frame", "nerf.render.upload",
                            "nerf.render.enqueue", "nerf.render.readback",
                            "nerf.render.finish"]) == [1, 3, 3, 3, 1]


@pytest.fixture
def recorded(monkeypatch):
    """Every stage mark the program makes, in order, with its device's
    type."""
    seen = []

    def record(stage, device):
        assert stage in spans.STAGES
        seen.append((stage, torch.device(device).type))
    for mod in (spans, system, renderer):
        monkeypatch.setattr(mod, "mark", record)
    return seen


@pytest.mark.parametrize("barf", [False, True], ids=["world", "posed"])
def test_sub_step_marks_in_order(recorded, barf):
    params, step, pool, perm = _pool_step(barf)
    step(params, pool, perm, 0, 3 * K, 5e-4)
    order = POSED_SUB_STEP if barf else SUB_STEP
    assert [s for s, _ in recorded] == order * K
    assert {d for _, d in recorded} == {"cpu"}


def test_render_chunk_marks_in_order(recorded):
    params, cfg, rays, ts = _render_case()
    system.render_chunked(params, rays, ts, cfg, chunk=16, device="cpu")
    assert [s for s, _ in recorded] == CHUNK * 3


def test_mark_does_nothing_on_the_cpu(monkeypatch):
    def no_library():
        raise AssertionError("a mark on the CPU loaded the library")
    monkeypatch.setattr(spans, "_lib", no_library)
    for stage in spans.STAGES:
        assert spans.mark(stage, torch.device("cpu")) is None
    with pytest.raises(ValueError, match="no stage 'forward'"):
        spans.mark("forward", torch.device("cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pose_mark_is_the_identity_both_ways(dtype):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(64, 8, generator=g, dtype=dtype).requires_grad_(True)
    cot = torch.randn(64, 8, generator=g, dtype=dtype)
    y = spans.PoseMark.apply(x)
    assert torch.equal(y, x) and y.dtype == dtype
    (y * cot).sum().backward()
    assert torch.equal(x.grad, cot)


def test_span_times_into_the_store():
    store = spans.STORE
    before = store.totals().get("nerf.test.outer", (0, 0.0))
    with spans.span("nerf.test.outer") as outer:
        with spans.span("nerf.test.inner") as inner:
            pass
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert outer.seconds == outer.end - outer.start >= inner.seconds >= 0
    count, seconds = store.totals()["nerf.test.outer"]
    assert count == before[0] + 1
    assert seconds == pytest.approx(before[1] + outer.seconds)
    local = spans.Store()
    local.add("nerf.b", 0.5)
    local.add("nerf.a", 1.25)
    local.add("nerf.a", 0.25)
    assert local.summary() == "nerf.a 2 x 1.500 s; nerf.b 1 x 0.500 s"
    assert local.totals() == {"nerf.a": (2, 1.5), "nerf.b": (1, 0.5)}


def test_store_counts_every_add_from_many_threads():
    store, n_threads, n_adds = spans.Store(), 32, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [store.add("nerf.t", 1.0) for _ in range(n_adds)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert store.totals()["nerf.t"] == (n_threads * n_adds,
                                        float(n_threads * n_adds))
