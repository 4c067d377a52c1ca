"""Every configuration, cell and per-layer metric of BENCHMARK.json has
its file under cfdbench/, found by name, and agrees with it; names and
units keep to the characters the benchmark allows."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["cfdbench"]
    assert BENCH["command"][:2] == ["python3", "-m"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / cfg["file"]
    assert path == ROOT / "cfdbench" / "configs" / f"{cfg['name']}.json"
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert importlib.import_module(f"cfdbench.reference.{data['reference']['module']}")
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_file(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    data = json.loads((ROOT / "cfdbench" / "workloads" / f"{cell['name']}.json").read_text())
    assert data["config"] == cell["config"]
    config = json.loads((ROOT / "cfdbench" / "configs" / f"{cell['config']}.json").read_text())
    numbers = {"mom_diag", "u_star", "p_residual_first", "p_residual"} | (
        {"flux"} if config["reference"]["module"] == "simple_fc" else set()
    )
    assert set(data["limits"]) == numbers
    assert len(cell["why"]) <= 200


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_file(metric):
    mod = importlib.import_module(f"cfdbench.metrics.{metric['name']}")
    assert callable(mod.read) and isinstance(mod.KERNELS, tuple)
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_end_to_end_metrics():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert names == {"iters_per_s", "peak_mem_gib", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            names.append(entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in BENCH[group]]
        assert len(group_names) == len(set(group_names))
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x and 1 <= len(x) <= 200 for x in layers)


def test_settings_match_the_port():
    """The configurations' numerics give the settings the repo names:
    the flagship (models/cavity.flagship_settings) and the numerics of
    examples/cavity_3d.toml."""
    from orc_tpu_torch.models.cavity import flagship_settings
    from orc_tpu_torch.utils.config import parse_case

    from cfdbench.run import load_spec, settings_of

    ghia = load_spec("ghia-3072-ck")
    assert settings_of(ghia.config, (16, 16, 1)) == flagship_settings()
    cube = load_spec("cube-256-fm")
    case = parse_case((ROOT / "examples" / "cavity_3d.toml").read_text())
    assert settings_of(cube.config, (8, 8, 8)) == case.settings
    assert cube.config["fluid"] == {"rho": case.rho, "mu": case.mu}
    assert {k: v["type"] for k, v in cube.config["boundaries"].items()} == {
        k: v["type"] for k, v in case.boundaries.items()
    }
