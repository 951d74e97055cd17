"""BENCHMARK.json keeps to the benchmark format's rules:
names, keys, units, limits of size, and every file it names."""

import json
import re

from perfbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_the_benchmark_file_keeps_its_shape():
    path = core.REPO / "BENCHMARK.json"
    assert path.stat().st_size <= 64 * 1024
    b = json.loads(path.read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(TEXT.match(w) for w in b["command"])
    for p in b["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["why"])
        assert TEXT.match(c["source"]) and (core.REPO / c["file"]).exists()
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        config = json.loads((core.REPO / c["file"]).read_text())
        assert sorted(c["reduced"]) == sorted(config["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
    names = [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(names)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert core.traffic_path(w["traffic"]).exists()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", names)) <= set(names)
    perf = (core.REPO / "PERF.md").read_text()
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        assert core.metric_path(m["name"]).exists()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
        # A layer is named as PERF.md's list of layers names it.
        assert f"| {m['layer']} |" in perf, m["layer"]
    all_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(all_names) == len(set(all_names))
