"""Finding configurations, mixes and metrics by name, from files; the shape
of ``BENCHMARK.json``."""

import json
import re

import pytest

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_config_mix_and_metrics():
    bench = spec.load_benchmark()
    for cell in bench["workloads"]:
        cfg = spec.config(bench, cell["config"])
        assert cfg["name"] == cell["config"]
        mix = spec.traffic(cell["traffic"])
        assert mix["driver"] in ("solve", "timestep")
        for traced in (False, True):
            entries = spec.metrics(bench, cell["name"], traced)
            assert entries, (cell["name"], traced)
            for e in entries:
                assert callable(spec.reader(e["name"]))
        names = {e["name"] for e in spec.metrics(bench, cell["name"], False)}
        assert "setup_s" in names and len(names) >= 2


def test_benchmark_json_names_units_and_bounds():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"] + bench["workloads"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_a_dummy_config_mix_and_metric_added_as_files_are_found(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs" / "dummy_cfg.json").write_text(
        json.dumps({"name": "dummy_cfg", "n": 4}))
    (tmp_path / "traffic" / "dummy_mix.json").write_text(
        json.dumps({"driver": "solve", "checked_answers": 1}))
    (tmp_path / "metrics" / "dummy_metric.layer.py").write_text(
        "def read(run):\n    return run.answer * 2\n")
    bench = {"configs": [{"name": "dummy_cfg",
                          "file": "configs/dummy_cfg.json"}],
             "workloads": [{"name": "dummy_cfg.dummy_mix",
                            "config": "dummy_cfg", "traffic": "dummy_mix",
                            "chips": 1}],
             "end_to_end": [{"name": "setup_s"}],
             "per_layer": [{"name": "dummy_metric.layer", "moves": "setup_s"},
                           {"name": "other", "moves": "setup_s",
                            "workloads": ["elsewhere"]}]}
    assert spec.config(bench, "dummy_cfg", root=tmp_path)["n"] == 4
    assert spec.traffic("dummy_mix", tmp_path)["checked_answers"] == 1
    traced = spec.metrics(bench, "dummy_cfg.dummy_mix", True)
    assert [m["name"] for m in traced] == ["dummy_metric.layer"]

    class Run:
        answer = 21
    assert spec.reader("dummy_metric.layer", tmp_path)(Run()) == 42
    with pytest.raises(FileNotFoundError):
        spec.traffic("absent", tmp_path)
    with pytest.raises(FileNotFoundError):
        spec.reader("absent", tmp_path)
