"""The harness end to end on the CPU: tiny runs of the cells print the
contract's result, and the command refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from helpers import ROOT, run_module, tiny_run

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def _check_result(out, trace):
    assert all(k in out for k in KEYS)
    assert list(out)[-1] == "check"
    assert out["correct"] is True, out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    json.loads(json.dumps(out))
    if trace:
        assert "busy_s" in out["device"] and out["device"]["window_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_live_run(trace):
    out = tiny_run("dn2.live", trace=trace)
    _check_result(out, trace)
    if not trace:
        assert out["metrics"]["hop_ms.p95"]["value"] >= out["metrics"]["hop_ms.p50"]["value"]
        assert set(out["metrics"]) == {"setup_s", "hop_ms.p50", "hop_ms.p95"}
    else:
        # no card: the device readers find nothing and stay silent; the span reader reads
        assert "pool.host_ms.live" in out["metrics"]
        assert "device.idle_share.live" not in out["metrics"]


def test_tiny_offline_run():
    out = tiny_run("hr8.offline", seconds=3.0)
    _check_result(out, False)
    assert out["metrics"]["offline_xrt"]["value"] > 0


def test_tiny_mesh_run():
    """The mesh cell's path on a mesh of two CPU entries."""
    out = tiny_run("hr8.offline.mesh4", seconds=3.0, chips=2)
    _check_result(out, False)
    assert out["device"]["count"] == 2


def _cli(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "hr8.offline",
                           "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_cli_without_a_card_prints_no_result():
    p = _cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_cli_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_listed_end_to_end_metric_that_reads_nothing_fails_on_a_card():
    from benchmark.harness.cells import Spec

    spec = Spec(ROOT)
    run = run_module()
    cell = spec.cell("hr8.offline.mesh4")
    got = run.read_end_to_end(spec, cell, {"offline_xrt": 900.0, "setup_s": 20.0}, strict=True)
    assert got == {"setup_s": {"value": 20.0, "unit": "s"},
                   "offline_xrt.mesh4": {"value": 900.0, "unit": "s/s"}}
    assert run.read_end_to_end(spec, cell, {"setup_s": 20.0}, strict=False) == {
        "setup_s": {"value": 20.0, "unit": "s"}}
    with pytest.raises(run.MissingMetric, match="offline_xrt.mesh4"):
        run.read_end_to_end(spec, cell, {"setup_s": 20.0}, strict=True)


def test_a_listed_per_layer_metric_that_reads_nothing_fails_on_a_card():
    """On cards every listed metric has to read; on the CPU the device's
    readers find no trace and are left out."""
    from benchmark.harness.cells import Spec

    spec = Spec(ROOT)
    cell = spec.cell("hr8.offline")
    ctx = {"cell": cell, "config": spec.config(cell["config"]), "chips": 1, "t0": 0.0,
           "log": [], "trace": None, "peaks": None}
    run = run_module()
    assert run.read_per_layer(spec, cell, ctx, strict=False) == {}
    with pytest.raises(run.MissingMetric):
        run.read_per_layer(spec, cell, ctx, strict=True)


NAME = r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}"
UNIT = r"[A-Za-z0-9_/%.\-]{1,16}"
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not set(text) & {"\n", "\t"}


def test_benchmark_json_has_the_contract_form():
    """Every key and limit of the root file, so that a fault of form shows here."""
    import re

    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    doc = json.loads(raw)
    assert set(doc) == {"command", "paths", "run_seconds", *ENTRY_KEYS}
    assert 1 <= len(doc["command"]) <= 32 and all(_line(w) for w in doc["command"])
    assert 1 <= len(doc["paths"]) <= 16
    assert all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) for p in doc["paths"])
    assert isinstance(doc["run_seconds"], int) and 1 <= doc["run_seconds"] <= 51
    for part, keys in ENTRY_KEYS.items():
        entries = doc[part]
        names = [e["name"] for e in entries]
        assert len(set(names)) == len(names)
        for e in entries:
            extra = {"workloads"} if part in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (part, e["name"])
            assert re.fullmatch(NAME, e["name"])
            if "unit" in e:
                assert re.fullmatch(UNIT, e["unit"]) and e["better"] in ("lower", "higher")
    configs = {c["name"]: c for c in doc["configs"]}
    cells = {w["name"]: w for w in doc["workloads"]}
    assert 1 <= len(configs) <= 24 and 1 <= len(cells) <= 24
    for c in configs.values():
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert (ROOT / c["file"]).is_file()
        assert any(c["file"].startswith(p + "/") for p in doc["paths"])
    for w in cells.values():
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert re.fullmatch(NAME, w["traffic"])
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(doc["per_layer"]) <= 128
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
    for cell in cells:
        listed = [m for m in doc["end_to_end"] if cell in m.get("workloads", [cell])]
        assert any(m["name"] == "setup_s" for m in listed) and len(listed) >= 2, cell
        assert any(cell in m.get("workloads", [cell]) for m in doc["per_layer"]), cell
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert set(m.get("workloads", [])) <= set(cells)
