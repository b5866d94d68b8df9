"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names."""

import hashlib
import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = harness.benchmark()
E2E = {m["name"] for m in SPEC["end_to_end"]}


def cells_reporting(metric):
    return [w["name"] for w in SPEC["workloads"] if w["name"] in metric.get("workloads", [w["name"]])]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "-m", "portbench.run"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for m in SPEC["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_its_files_and_metrics(w):
    c = harness.cell(w["name"], SPEC)
    assert (harness.BENCH / "drivers" / f"{c['driver']}.py").is_file()
    assert (harness.BENCH / "programs" / f"{c['config']['program']}.py").is_file()
    driver = harness.driver(c)
    assert driver.TASK in ("serve", "train") and callable(driver.control_inputs)
    assert set(driver.SMALL) <= set(c["params"])
    assert c["faults"] and set(c["faults"]) <= set(c["program"].FAULTS)
    assert w["chips"] == 1
    assert "setup_s" in {m["name"] for m in c["end_to_end"]} and len(c["end_to_end"]) >= 2
    assert c["per_layer"]
    assert c["limits"] and all(v >= 0 for v in c["limits"].values())


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(m):
    assert m["moves"] in E2E and m["source"] in ("device_trace", "program_span",
                                                 "program_counter", "host_clock")
    moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in cells_reporting(moved), (m["name"], cell)
    assert callable(harness.reader(m["name"]))


def test_end_to_end_bounds_and_sources():
    assert "setup_s" in E2E
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def weight_files(node):
    """Every (weights, sha256) pair named anywhere in a configuration."""
    if isinstance(node, dict):
        if "weights" in node:
            yield node["weights"], node.get("sha256")
        for v in node.values():
            yield from weight_files(v)
    elif isinstance(node, list):
        for v in node:
            yield from weight_files(v)


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_configs_parse_and_name_their_reductions(c):
    """A configuration names its program module, its reductions and, under
    ``assumed``, where its weights come from; every weight file it names
    exists and matches the SHA-256 beside it, and one whose weights are
    drawn from the seed names none."""
    cfg = harness.load_json(harness.ROOT / c["file"])
    assert c["file"].startswith("portbench/") and c["source"].startswith("https://")
    assert c["reduced"] == cfg["reduced"]
    assert (harness.BENCH / "programs" / f"{cfg['program']}.py").is_file()
    said = [a for a in cfg["assumed"] if a.startswith("weights:")]
    assert len(said) == 1
    files = list(weight_files(cfg))
    for path, digest in files:
        data = (harness.ROOT / path).read_bytes()
        assert hashlib.sha256(data).hexdigest() == digest, path
    assert files or "seed" in said[0]
