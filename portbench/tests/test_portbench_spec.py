"""BENCHMARK.json against the benchmark's contract, and each cell against
its files: every name resolves to a file of its own, every metric has a
reader, and the names and units use only the characters allowed."""

import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import bench  # noqa: E402

SPEC = bench.load_spec(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(SPEC) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16 and 1 <= len(SPEC["command"]) <= 32
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert not p.rstrip("/").endswith("_torch")
    for word in SPEC["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word


def test_run_seconds_fits_the_full_check():
    cells = 24
    total = (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_the_contract_keys(section, keys):
    entries = SPEC[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert keys <= set(e) <= keys | extra, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert TEXT.match(e[k]), (k, e[k])


def test_metrics_units_bounds_and_sources():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        r = bench.resolve(SPEC, w["name"])
        names = {m["name"] for m in r["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert r["per_layer"]
        for m in r["per_layer"]:  # the metric it moves is reported in the cell
            assert m["moves"] in names


def test_four_chip_cells_are_few():
    fours = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert len(fours) <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_to_its_files_by_name(cell):
    r = bench.resolve(SPEC, cell)
    conf = next(c for c in SPEC["configs"] if c["name"] == r["cell"]["config"])
    assert conf["file"].startswith("portbench/configs/") and os.path.isfile(os.path.join(ROOT, conf["file"]))
    assert r["config"]["name"] == conf["name"] and r["config"]["reduced"] == conf["reduced"]
    assert os.path.isfile(os.path.join(bench.HERE, "traffic", r["cell"]["traffic"] + ".json"))
    assert os.path.isfile(os.path.join(bench.HERE, "drivers", r["traffic"]["driver"] + ".py"))
    for m in r["end_to_end"] + r["per_layer"]:
        assert callable(bench.load_metric(m["name"]).read)
    assert r["traffic"]["limits"]


def test_config_files_are_distinct_and_used():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"] and len(c["reduced"]) <= 16


def test_module_check_compares_whole_top_level_names(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in bench.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "raw2film_tpu_torch.ops", object())
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "raw2film_tpu.ops", object())
    assert "raw2film_tpu" in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"raw2film_tpu", "jaxlib"} <= set(bench.forbidden_modules())


def test_reference_imports_nothing_of_the_program():
    for dirpath, _, files in os.walk(os.path.join(bench.HERE, "ref")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    src = fh.read()
                assert not re.search(r"^\s*(from|import)\s+(raw2film|jax|benchmarks)", src, re.M), f
