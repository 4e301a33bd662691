"""Guards on the port (repro_torch) and chip_smoke.py: they import neither
JAX nor the JAX package, they run on the card unless the caller asks for
the CPU, and chip_smoke.py refuses to report without a card or without
the port's sources beside it."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.core.consensus import path_graph
from repro_torch.core.prediction import FittedExperts, PredictionEngine
from repro_torch.fleet import FleetConfig, GPFleet
from repro_torch.launch import serve_gp

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src/repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPFleet(FleetConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    f = FittedExperts.from_numpy(
        {"log_theta": np.zeros(4), "Xp": np.zeros((2, 3, 2)),
         "yp": np.zeros((2, 3)), "L": np.tile(np.eye(3), (2, 1, 1)),
         "alpha": np.zeros((2, 3))}, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PredictionEngine(f, path_graph(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FittedExperts.from_numpy({}, device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_gp.main(["--agents", "2", "--per-agent", "8"])


def test_cuda_entry_switches_tf32_off(monkeypatch):
    """On the card the entry points keep float32 products out of TF32."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device() == torch.device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card_or_sources(tmp_path, alone):
    """Here (no card) chip_smoke.py exits non-zero and prints no result,
    from the repository and from a directory holding only the script."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
