"""``BENCHMARK.json`` and the files it finds by name: the contract's
characters and limits, one file per item, and every per-layer metric's
``moves`` target reported in each cell it lists."""

import json
import re

import pytest

from driftbench import bench
from driftbench.flops import flash_bound_s
from driftbench.reference import dense, ssm

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = bench.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in MAN["paths"])
    assert len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert 1 <= MAN["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(MAN["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in MAN[group]:
            assert NAME.match(item["name"]) and item["name"] not in seen
            seen.add(item["name"])
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in MAN["configs"]} == {w["config"] for w in
                                                   MAN["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_metrics_need(cell):
    loaded = bench.load_cell(cell, man=MAN)
    assert loaded.spec["policy"] and loaded.spec["limits"]["logit_gap"] > 0
    e2e = {m["name"] for m in bench.metrics_for(cell, False, MAN)}
    layer = bench.metrics_for(cell, True, MAN)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS
        assert callable(bench.reader(m["name"]))


def test_layers_are_named_alike():
    by_prefix = {}
    for m in MAN["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


DANUBE = {"n_layers": 24, "d_model": 2560, "n_heads": 32,
          "n_kv_heads": 8, "head_dim": 80, "d_ff": 6912, "vocab": 32000,
          "sliding_window": 4096}
MAMBA2 = {"n_layers": 64, "d_model": 2560, "vocab": 50288,
          "ssm_state": 128, "ssm_headdim": 64, "ssm_ngroups": 1,
          "ssm_conv": 4, "ssm_expand": 2}


def test_flops_against_hand_counts():
    # per layer: 2 * (2560*80*(64+16) + 3*2560*6912) = 138,936,320; head
    # 2*2560*32000; attention 4*32*80 a visible key a layer
    assert dense.token_flops(DANUBE, 0) == 24 * 138_936_320 + 163_840_000
    assert dense.token_flops(DANUBE, 10) - dense.token_flops(DANUBE, 0) \
        == 24 * 10240 * 10
    assert dense.prefill_flops(DANUBE, 3) == 3 * dense.token_flops(DANUBE, 0) \
        + 24 * 10240 * 6
    # 2*(2560*(10240+256+80) + 5120*2560) + 2*4*5376 + 4*5120*128 a
    # layer; head 2*2560*50288
    assert ssm.token_flops(MAMBA2, 1) == 64 * 83_027_968 + 257_474_560
    assert ssm.prefill_flops(MAMBA2, 7) == 7 * ssm.token_flops(MAMBA2, 1)
    # 64 causal keys: 819,200 bytes against 21,299,200 FLOPs -> bytes
    assert flash_bound_s(DANUBE, 64) == pytest.approx(819_200 / 3.35e12)
    assert flash_bound_s(DANUBE, 2048) == pytest.approx(
        4 * 32 * 80 * 2048 * 2049 / 2 / 989e12)
