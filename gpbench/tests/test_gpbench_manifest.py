"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name; the harness imports neither JAX nor the JAX package."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                    r"_rank$|head|expansion|experts_per_tok)")


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["gpbench"]
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and cmd[1].startswith("gpbench/")
    assert (REPO / cmd[1]).is_file()
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    # a full check of 24 cells at this length fits in 12 hours
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = [c["name"] for c in MANIFEST["configs"]] \
        + [w["name"] for w in MANIFEST["workloads"]] \
        + [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names_ = [e["name"] for e in MANIFEST[section]]
        assert len(names_) == len(set(names_)), section
    for n in names:
        assert NAME.match(n), n
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpbench/")
        assert (REPO / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and "\n" not in m["layer"]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_finds_its_files_and_metrics(cell):
    w = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    assert any(c["name"] == w["config"] for c in MANIFEST["configs"])
    gp = REPO / "gpbench"
    traffic = json.loads((gp / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    assert (gp / "loops" / f"{traffic['loop']}.py").is_file()
    limits = json.loads((gp / "limits" / f"{cell}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())

    def reports(m):
        return cell in m.get("workloads", [cell])
    e2e = [m["name"] for m in MANIFEST["end_to_end"] if reports(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = [m for m in MANIFEST["per_layer"] if reports(m)]
    assert layers
    for m in layers:
        assert (gp / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_the_harness_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A tiny cell driven end to end in a fresh process: no module whose
    top-level name is jax, jaxlib, flax or repro (compared whole) is
    loaded."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}, "
        f"{str(REPO / 'gpbench' / 'tests')!r}]\n"
        "import gpbench_tiny as T\n"
        "from pathlib import Path\n"
        f"root = T.make_copy(Path({str(tmp_path)!r}))\n"
        "T.run_cell(root, 'tiny.serve', seconds=0.3)\n"
        "from gpbench import calibrate, harness\n"
        "import gpbench.compare, gpbench.costs, gpbench.data\n"
        "print(harness.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'repro_torch', 'gpbench'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] == "['gpbench', 'repro_torch']"


def test_run_refuses_without_a_card():
    """Without a CUDA device the command exits non-zero and prints no
    result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine "
                    "without one")
    out = subprocess.run(
        [sys.executable, str(REPO / "gpbench" / "run.py"), "--workload",
         MANIFEST["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
