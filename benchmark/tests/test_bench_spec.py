"""BENCHMARK.json against the contract it is written to, and every part
of every cell found by name: configuration, traffic and its runner,
limits, metric readers."""
import json
import re

import pytest

from benchmark import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def names(bench):
    """Every name the contract constrains: metrics, cells, configurations,
    traffic, reduced keys."""
    out = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for w in bench["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    for c in bench["configs"]:
        out += [c["name"]] + list(c["reduced"])
    return out
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_and_units():
    for n in names(BENCH):
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if m in BENCH["end_to_end"] else \
            {"layer", "moves"}
        assert set(m) <= allowed, m
    for text in [w["why"] for w in BENCH["workloads"]] + \
            [c["why"] for c in BENCH["configs"]] + \
            [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for kind in (METRICS, BENCH["workloads"], BENCH["configs"]):
        named = [x["name"] for x in kind]
        assert len(named) == len(set(named))


def test_end_to_end_metrics():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert names == {"train_rays_per_s", "frame_ms", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    sp = spec.cell(cell, BENCH)
    assert sp.chips == 1
    assert sp.limits is not None and sp.limits["numbers"]
    assert spec.runner(sp.traffic["kind"]).Runner
    e2e = {m["name"] for m in sp.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and sp.per_layer
    for m in sp.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]).read)


def test_configs():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        conf = spec.load_json(spec.ROOT / c["file"])
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in conf
            assert not re.search(r"(_dim|_rank)$|width|hidden|head",
                                 key), key
        assert conf["dtype"] in ("float32", "bfloat16")
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_every_metric_reader_is_listed():
    files = {p.name[:-3] for p in (spec.HERE / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}
