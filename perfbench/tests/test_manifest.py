"""BENCHMARK.json against the benchmark's rules, and every file a cell,
configuration or metric names."""

import json
import os
import re

import pytest

from perfbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) < 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128
    assert len(MAN["command"]) <= 32
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    texts = [entry[k] for k in ("why", "layer") if k in entry]
    if "file" in entry:  # a configuration's source
        texts.append(entry["source"])
    for v in texts:
        assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v
    for k in entry.get("reduced", []):
        assert NAME.match(k)


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_one_chip_each():
    assert all(w["chips"] == 1 for w in MAN["workloads"])


def test_end_to_end_rules():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in names
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in MAN["workloads"]:
        mine = harness.metrics_of(MAN, w["name"], trace=False)
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert harness.metrics_of(MAN, w["name"], trace=True)


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_suffix_names_what_its_cells_report(metric):
    """Each per-layer metric's suffix names the end-to-end metric it moves
    (``.restore`` moves ``restore_audio_s_per_s``), and every cell it lists
    reports that metric."""
    suffix = metric["name"].rsplit(".", 1)[1]
    assert metric["moves"].startswith(suffix + "_")
    for w in metric["workloads"]:
        harness.cell(MAN, w)
        assert metric["moves"] in {m["name"] for m in harness.metrics_of(
            MAN, w, trace=False)}


def test_files_of_every_cell_and_metric():
    root = harness.ROOT
    for c in MAN["configs"]:
        assert c["file"].startswith("perfbench/")
        with open(os.path.join(root, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for w in MAN["workloads"]:
        for part in (("traffic", w["traffic"] + ".json"),
                     ("limits", w["name"] + ".json")):
            assert os.path.exists(os.path.join(harness.HERE, *part))
    for m in METRICS:
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))


def test_limits_name_the_checks():
    """Each cell's limits file holds a limit for some of the numbers its
    loop reads, and nothing else."""
    from perfbench import traffic

    for w in MAN["workloads"]:
        lim = harness.load_json(harness.HERE, "limits", w["name"] + ".json")
        kind = traffic.load(w["traffic"])["kind"]
        assert lim and set(lim) <= set(harness.loop(kind).CHECKS)
        assert all(v >= 0 for v in lim.values())


def test_command_stays_inside_paths():
    cmd = MAN["command"]
    files = [c for c in cmd if c.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in MAN["paths"])
                         for f in files)
