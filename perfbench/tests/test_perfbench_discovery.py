"""A configuration, a traffic mix or a per-layer metric added as a file
of its own, with its entry in BENCHMARK.json, is found by name with no
edit to any file that is there."""

import json
import shutil

from perfbench import core


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "perfbench"
    shutil.copytree(core.HERE, root)
    bench = core.load_benchmark()
    config = json.loads((root / "configs" / "starcoder2-3b.json").read_text())
    config["num_hidden_layers"] = 2
    (root / "configs" / "new-model.json").write_text(json.dumps(config))
    mix = json.loads(core.traffic_path("chat", root).read_text())
    mix["clients"] = 7
    (root / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (root / "metrics" / "answer.new.py").write_text(
        "def read(record):\n    return record['window']['value'] * 2\n")
    bench["configs"].append({"name": "new-model", "source": "x",
                             "file": "perfbench/configs/new-model.json",
                             "reduced": ["num_hidden_layers"], "why": "x"})
    bench["workloads"].append({"name": "new.cell", "config": "new-model",
                               "traffic": "new-mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "answer.new", "unit": "rows",
                               "better": "higher", "source": "program_counter",
                               "layer": "x", "moves": "serve_tokens_per_s",
                               "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = core.load_cell("new.cell", repo=tmp_path, root=root)
    assert cell.config["num_hidden_layers"] == 2
    assert cell.mix["clients"] == 7
    assert cell.mix["driver"] == "serve"
    assert [m["name"] for m in cell.per_layer] == ["answer.new"]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}
    record = {"window": {"value": 21}}
    assert core.read_metric("answer.new", record, root=root) == 42


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = core.load_benchmark()
    for work in bench["workloads"]:
        cell = core.load_cell(work["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert core.metric_path(m["name"]).exists()
            assert m["moves"] in names


def test_a_metric_falls_back_to_the_reader_of_its_quantity(tmp_path):
    root = tmp_path / "perfbench"
    (root / "metrics").mkdir(parents=True)
    (root / "metrics" / "rate.py").write_text(
        "def read(record):\n    return record['n']\n")
    (root / "metrics" / "rate.train.py").write_text(
        "def read(record):\n    return -record['n']\n")
    record = {"n": 3}
    assert core.read_metric("rate.serve", record, root=root) == 3
    assert core.read_metric("rate.serve.chat", record, root=root) == 3
    assert core.read_metric("rate.train", record, root=root) == -3
    assert core.metric_path("rate.serve", root) == root / "metrics" / "rate.py"
