"""The trace's reduction: the busy union of overlapping kernels, the fused
records held against the kernels' run count, the breakdown, and the
metric readers on a window made by hand."""
import pytest

from benchmark import spec, trace


def k(name, ts, dur):
    return {"name": name, "ts": ts, "dur": dur, "cat": "kernel"}


def test_busy_union_of_overlapping_kernels():
    ks = [k("a", 0, 10), k("b", 5, 10), k("c", 30, 5), k("d", 31, 1)]
    assert trace.busy_union(ks) == (20.0, 35.0)
    assert trace.merged(ks) == [(0, 15), (30, 35)]
    assert trace.busy_union([]) == (0.0, 0.0)
    # a sum of durations would read 26 of a 35 span; stacked kernels over
    # 100%: the union never does
    assert trace.busy_union([k("x", 0, 10)] * 5)[0] == 10.0


def window(fwd=2, bwd=2, seconds=1e-4):
    ks = []
    t = 0
    for i in range(fwd):
        ks.append(k("void fused_mlp_fwd_f32_kernel(float const*)", t, 10))
        t += 10
    for i in range(bwd):
        ks += [k("(anonymous namespace)::tb::fused_mlp_bwd_f32_kernel(x)",
                 t, 20), k("tb::wgrad_f32_kernel(y)", t + 20, 5),
               k("tb::reduce_dw_tree(z)", t + 25, 1)]
        t += 26
    ks.append(k("sm90_xmma_gemm_f32f32_f32f32_f32_tn", t + 10, 4))
    host = [{"name": trace.WINDOW_SPAN, "ts": 0, "dur": 100, "ph": "X"},
            {"name": "aten::index_select", "ts": t, "dur": 12, "ph": "X"}]
    return trace.Window(seconds, ks, host, (0, 100), (2, 2))


def test_window_counts_and_breakdown():
    w = window()
    assert w.fused_ok and (w.fwd_records, w.bwd_records) == (2, 2)
    assert w.kernel_seconds(trace.FWD) == pytest.approx(20e-6)
    assert w.kernel_seconds(trace.BWD) == pytest.approx(52e-6)
    assert w.kernel_seconds(trace.GEMM) == pytest.approx(4e-6)
    assert w.busy_s == pytest.approx(76e-6)
    b = w.breakdown()
    assert b["device_ops"][0][0] == \
        "(anonymous namespace)::tb::fused_mlp_bwd_f32_kernel"
    assert b["idle_gaps"][0] == ["no host event", pytest.approx(1.4e-5)]
    assert b["idle_gaps"][1] == ["aten::index_select", pytest.approx(1e-5)]
    assert not window(fwd=1).fused_ok
    assert trace.short("void at::native::(anonymous namespace)::k<4>(int)") \
        == "void at::native::(anonymous namespace)::k<4>"


class Cell:
    config = spec.load_json(spec.HERE / "configs" / "nerfw_lego.json")
    peak_flops, peak_bw = 495e12, 3.35e12
    chunk, chunks_per_frame, rays_per_frame = 32768, 5, 160000


def test_readers_on_a_window():
    w = window()
    w.counts = {"sub_steps": 1}
    idle = spec.reader("device_idle_pct.train").read(w, Cell)
    assert idle == pytest.approx(100 * (1 - 76e-6 / 1e-4))
    assert spec.reader("step_kernels.train").read(w, Cell) == 9
    other = spec.reader("step_other_ms.train").read(w, Cell)
    assert other == pytest.approx(4e-3)
    w.counts = {}
    assert spec.reader("step_mfu.train").read(w, Cell) is None
    w.counts = {"frames": 1, "dispatch_s": [0.1, 0.3]}
    assert spec.reader("dispatch_ms.render").read(w, Cell) == \
        pytest.approx(200)
    assert spec.reader("coarse_gemm_ms.render").read(w, Cell) == \
        pytest.approx(4e-3)
    w = window(fwd=1)
    w.counts = {"frames": 1}
    assert spec.reader("fused_fwd_roofline.render").read(w, Cell) is None
