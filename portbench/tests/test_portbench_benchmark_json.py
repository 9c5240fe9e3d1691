"""``BENCHMARK.json`` holds together with the files it names: each
configuration, traffic mix, driver, limits file and per-layer reader is
there, names and units have the contract's form, and every cell reports
``setup_s``, another end-to-end metric and a per-layer metric."""

import json
import re

import pytest

from portbench.tests.conftest import CHECKOUT

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
PB = CHECKOUT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(cell):
    cfg = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert (CHECKOUT / cfg["file"]).is_file()
    traffic = json.loads((PB / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (PB / "drivers" / f"{traffic['driver']}.py").is_file()
    limits = json.loads((PB / "limits" / f"{cell['name']}.json").read_text())
    assert limits
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell["name"] in m.get("workloads", ())]
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(metric):
    assert (PB / "metrics" / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files_state_their_changes(cfg):
    data = json.loads((CHECKOUT / cfg["file"]).read_text())
    assert set(cfg["reduced"]) == set(data["meta"]["changed"])
