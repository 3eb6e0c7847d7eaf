"""BENCHMARK.json against the format and limits it keeps to, and every file
the harness finds by name."""

import json
import re

import pytest

from perfbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = [e["name"] for e in MAN["configs"] + MAN["workloads"] + METRICS]
    assert all(NAME.match(n) for n in names), names
    assert len(set(c["name"] for c in MAN["configs"])) == len(MAN["configs"])
    assert len(set(CELLS)) == len(CELLS)
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in MAN["configs"] + MAN["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    assert len(json.dumps(MAN)) < 64 * 1024


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and m["moves"] in e2e


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = {m["name"] for m in harness.reported(MAN, cell, traced=False)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert harness.reported(MAN, cell, traced=True), cell


def test_every_moves_target_is_reported_by_the_metrics_cells():
    for m in MAN["per_layer"]:
        for cell in m["workloads"]:
            assert cell in CELLS
            e2e = {x["name"] for x in harness.reported(MAN, cell, traced=False)}
            assert m["moves"] in e2e, (m["name"], cell)


def test_every_configuration_has_a_cell_and_its_files():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"] == f"perfbench/configs/{c['name']}/config.json"
        cfg = harness.load_config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        d = harness.config_dir(c["name"])
        assert (d / cfg["graph"]).is_file() and (d / cfg["shader_path"]).is_dir()
        for part in ("reference", "work"):
            assert callable(getattr(harness.config_module(c["name"], part),
                                    "frame" if part == "reference" else "least_work"))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_mix_limits_and_readers(cell):
    w = harness.find(MAN["workloads"], cell, "workload")
    assert w["chips"] == 1
    mix = harness.load_mix(w["traffic"])
    from perfbench import drive

    assert mix["loop"] in drive.LOOPS
    limits = harness.load_limits(cell)
    assert limits and all(0 < v["limit"] for v in limits.values())
    for m in harness.reported(MAN, cell, False) + harness.reported(MAN, cell, True):
        assert callable(harness.reader(m["name"]).read)


def test_params_agree_with_the_graph_text():
    """config.json's params (which the reference and the work counts read)
    are the numbers the program parses from the frozen graph."""
    from reforge_tpu_torch.config import parse_file

    for c in MAN["configs"]:
        cfg = harness.load_config(c["name"])
        d = harness.config_dir(c["name"])
        parsed = parse_file((d / cfg["graph"]).read_text(), True, str(d / cfg["shader_path"]))
        assert set(cfg["params"]) == set(parsed.graph_pipelines)
        for node, params in cfg["params"].items():
            path = parsed.graph_pipelines[node].file_path
            kernel = params["kernel"]
            if kernel.endswith(".comp"):
                assert path == str(d / cfg["shader_path"] / kernel)
            else:  # a builtin: no kernel file of that name in the shader path
                assert path == "" and parsed.pipeline_type_of(node) == kernel
            given = {k: v.value for k, v in parsed.parameters_of(node).items()}
            assert given == {k: v for k, v in params.items() if k in given}, node
            # what the graph leaves to a default is stated under "assumed"
            for key in set(params) - set(given) - {"kernel"}:
                assert any(key in k for k in cfg["assumed"]), (node, key)
