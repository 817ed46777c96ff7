"""BENCHMARK.json keeps to the contract's shapes, and the harness is
driven by data: a later change adds a configuration, a traffic mix, a
check and a metric by adding files and entries alone."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_names_units_and_keys():
    b = bench()
    assert set(b) == KEYS
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert all(one_line(w) for w in b["command"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and c["file"].startswith("port_bench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "checks" / f"{w['name']}.json").is_file()
    cells = {w["name"] for w in b["workloads"]}
    names = []
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        # every cell a per-layer metric lists reports what it moves
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(moved)
        names.append(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    assert len(names) == len(set(names))
    for w in cells:
        mine = [m for m in b["end_to_end"] if w in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_cell_is_added_by_files_alone(tmp_path):
    """In a copy, a new configuration, traffic mix, check and metric are
    picked up with no edit to a file that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    (root / "port_bench/configs/tiny_box.json").write_text(json.dumps(
        {"name": "tiny_box", "scene": {"generator": "cornell_box",
                                       "args": {"width": 8, "height": 6}}}))
    (root / "port_bench/traffic/tiny_2spp.json").write_text(json.dumps(
        {"spp": 2, "engine": "auto", "loop": "closed", "clients": 1}))
    (root / "port_bench/checks/tiny_box.quick.json").write_text(json.dumps(
        {"pixels_per_image": 8, "limits": {"rad_mismatch": 0.0,
                                           "aov_mismatch": 0.0,
                                           "non_finite": 0}}))
    (root / "port_bench/metrics/images_done.py").write_text(
        "def read(ctx):\n    return ctx['window'].images\n")
    b["configs"].append({"name": "tiny_box", "source": "https://x.org/y",
                         "file": "port_bench/configs/tiny_box.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny_box.quick", "config": "tiny_box",
                           "traffic": "tiny_2spp", "chips": 1,
                           "why": "a test"})
    b["end_to_end"].append({"name": "images_done", "unit": "images",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["tiny_box.quick"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import json, time\n"
            "from port_bench import harness\n"
            "cell = harness.load_cell('tiny_box.quick')\n"
            "res = harness.run_cell(cell, 7, 0.2, False, 'cpu', "
            "time.perf_counter(), log=lambda m: None)\n"
            "print(json.dumps(res))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, env=dict(os.environ,
                            PYTHONPATH=f"{root}{os.pathsep}{ROOT}"))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"images_done", "setup_s"}
    assert res["metrics"]["images_done"]["value"] == res["attempted"]


def test_no_card_no_result():
    """Without a CUDA device a run exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "cornell.final",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
