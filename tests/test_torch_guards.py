"""Guards on the port (repro_torch) and chip_smoke.py: they import neither
JAX nor the JAX package, they run on the card unless the caller asks for
the CPU, a tensor off the CPU never reaches a kernel's plain version,
what is not yet ported says so, and chip_smoke.py refuses to report
without a card or without the port's sources beside it."""
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
from repro_torch.kernels import _build, ops
from repro_torch.kernels import cholupdate as C
from repro_torch.kernels import nll_grad as G
from repro_torch.kernels import rbf_gram as RG
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


def _meta_nll_grad_inputs(M=3, N=9, D=2):
    meta = dict(device="meta", dtype=torch.float32)
    return (torch.empty(M, D + 2, **meta), torch.empty(M, D, N, N, **meta),
            torch.empty(M, N, N, **meta))


def test_nll_grad_plain_never_takes_a_tensor_off_the_cpu(monkeypatch):
    """Meta tensors stand in for CUDA tensors on a machine without a card:
    they go to the kernel's launch path (here its checks, which refuse a
    non-CUDA device), never to the plain version."""
    def plain(*args, **kw):
        raise AssertionError("plain version reached from a non-CPU tensor")
    monkeypatch.setattr(G, "nll_grad_plain", plain)
    lt, d2u, inner = _meta_nll_grad_inputs()
    before = G.launches
    with pytest.raises(ValueError, match="CUDA device"):
        ops.nll_grad_fused_agents(lt, d2u, inner)
    with pytest.raises(ValueError, match="CUDA device"):
        G.nll_grad(d2u, inner, torch.empty(3, 3, device="meta"))
    assert G.launches == before


def test_nll_grad_raises_when_the_loader_fails(monkeypatch):
    def fail(name):
        raise RuntimeError("nvcc not found")

    def plain(*args, **kw):
        raise AssertionError("plain version reached from a non-CPU tensor")
    monkeypatch.setattr(_build, "load_library", fail)
    monkeypatch.setattr(G, "nll_grad_plain", plain)
    monkeypatch.setattr(G, "_check", lambda *args: None)
    G._library.cache_clear()
    lt, d2u, inner = _meta_nll_grad_inputs()
    before = G.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.nll_grad_fused_agents(lt, d2u, inner)
    assert G.launches == before
    G._library.cache_clear()


@pytest.mark.parametrize("bad,match", [
    ("dtype", "float32"), ("contiguous", "contiguous"), ("shape", "want d2u"),
    ("wide", "D <= 32")])
def test_nll_grad_kernel_input_checks_raise(bad, match):
    _, d2u, inner = _meta_nll_grad_inputs()
    params = torch.empty(3, 3, device="meta")
    if bad == "dtype":
        inner = inner.double()
    elif bad == "contiguous":
        d2u = torch.empty(3, 9, 9, 2, device="meta").permute(0, 3, 1, 2)
    elif bad == "shape":
        params = torch.empty(3, 4, device="meta")
    elif bad == "wide":
        _, d2u, inner = _meta_nll_grad_inputs(D=33)
        params = torch.empty(3, 34, device="meta")
    with pytest.raises((ValueError, TypeError), match=match):
        G._check(d2u, inner, params)


@pytest.mark.parametrize("trainer,item", [
    ("gapx", None), ("dec-gapx", None), ("dec-apx-sharded", None),
    ("fact-sparse", None), ("dec-apx-sparse", None)])
def test_unported_trainers_say_not_yet_ported(trainer, item):
    """Every trainer the reference registers is ported and registered (the
    sharded loop too, with its mesh flag); an unknown one is a KeyError.
    A trainer still to port would say so and name its ROADMAP item."""
    from repro_torch.fleet import get_trainer
    if item is None:
        spec = get_trainer(trainer)
        assert spec.name == trainer
        assert spec.needs_mesh == (trainer == "dec-apx-sharded")
    else:
        with pytest.raises(ValueError, match=f"not yet ported.*{item}"):
            get_trainer(trainer)
    with pytest.raises(KeyError, match="unknown trainer"):
        get_trainer("nope")


def test_fit_trace_is_not_yet_ported():
    """fit(trace=) is ported now (ROADMAP A4): the fleet accepts a
    TraceRecorder and records the trainer's diagnostics on it instead of
    refusing (tests/test_torch_obs.py holds them to the reference)."""
    from repro_torch.obs import TraceRecorder
    rng = np.random.default_rng(0)
    Xp, yp = rng.uniform(0, 2, (4, 6, 2)), rng.normal(size=(4, 6))
    rec = TraceRecorder()
    GPFleet(FleetConfig(admm_iters=2), device="cpu").fit(Xp, yp, trace=rec)
    assert len(rec) == 1 and rec.last()["primal_residuals"].shape == (2,)


def test_training_defaults_to_the_card(no_card):
    """The trainers follow their inputs' device; the fleet that runs them
    defaults to cuda and raises here."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPFleet(FleetConfig(trainer="dec-apx"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_gp.main(["--train-iters", "2", "--agents", "2",
                       "--per-agent", "8"])


def _meta_cholupdate_inputs(M=3, n=9):
    meta = dict(device="meta", dtype=torch.float32)
    return torch.empty(M, n, n, **meta), torch.empty(M, n, **meta)


def test_cholupdate_plain_never_takes_a_tensor_off_the_cpu(monkeypatch):
    """Meta tensors stand in for CUDA tensors: the op sends them to the
    kernel's launch path (its checks refuse a non-CUDA device), never to
    the plain version."""
    def plain(*args, **kw):
        raise AssertionError("plain version reached from a non-CPU tensor")
    monkeypatch.setattr(C, "cholupdate_plain", plain)
    L, x = _meta_cholupdate_inputs()
    before = C.launches
    with pytest.raises(ValueError, match="CUDA device"):
        ops.cholupdate_fleet(L, x, shift=1)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.cholupdate(L[0].double(), x[0].double())
    with pytest.raises(ValueError, match="CUDA device"):
        C.cholupdate(L, x)
    assert C.launches == before


def test_cholupdate_raises_when_the_loader_fails(monkeypatch):
    def fail(name):
        raise RuntimeError("nvcc not found")

    def plain(*args, **kw):
        raise AssertionError("plain version reached from a non-CPU tensor")
    monkeypatch.setattr(_build, "load_library", fail)
    monkeypatch.setattr(C, "cholupdate_plain", plain)
    monkeypatch.setattr(C, "_check", lambda *args: None)
    C._library.cache_clear()
    L, x = _meta_cholupdate_inputs()
    before = C.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.cholupdate_fleet(L, x, shift=1)
    assert C.launches == before
    C._library.cache_clear()


@pytest.mark.parametrize("bad,match", [
    ("dtype", "float32"), ("contiguous", "contiguous"), ("shape", "want L"),
    ("shift", "shift"), ("mask", "active"), ("device", "CUDA device"),
    ("tickets", "ticket counter")])
def test_cholupdate_kernel_input_checks_raise(bad, match):
    L, x = _meta_cholupdate_inputs()
    shift, active = 0, None
    if bad == "tickets":      # 2^26 agents x 32 strips: past the int32 counter
        L, x = _meta_cholupdate_inputs(M=2**26, n=1024)
    elif bad == "dtype":
        x = x.double()
    elif bad == "contiguous":
        L = L.transpose(1, 2)
    elif bad == "shape":
        x = torch.empty(3, 8, device="meta")
    elif bad == "shift":
        shift = 10
    elif bad == "mask":
        active = torch.empty(3, dtype=torch.int32, device="meta")
    with pytest.raises((ValueError, TypeError), match=match):
        C._check(L, x, shift, active)


def test_cholupdate_kernel_takes_a_strided_x():
    """The eviction passes x = L[:, :, 0], a strided view: the kernel reads
    it in place (no scratch copy), so only the device check refuses these
    meta tensors; the largest ticket count the counter holds passes."""
    L, _ = _meta_cholupdate_inputs()
    with pytest.raises(ValueError, match="CUDA device"):
        C._check(L, L[:, :, 0], 1, None)
    most = C.MAX_TICKETS // 32                    # agents of 32 strips
    assert C.schedule(most, 1024, 0).tickets <= C.MAX_TICKETS
    with pytest.raises(ValueError, match="ticket counter"):
        C.schedule(most + 1, 1024, 0)


def test_cholupdate_fault_word_raises_at_the_next_check(monkeypatch):
    """The kernel's watchdog word (-1, or the index of the (agent, panel)
    record that never arrived) is checked after the fact: calls the device
    has not finished stay pending unless check_faults waits for them, and
    a fault names its agent and panel."""
    class Done:
        def __init__(self, finished):
            self.finished = finished

        def query(self):
            return self.finished

        def synchronize(self):
            self.finished = True
    word = torch.tensor([-1], dtype=torch.int32)
    late = (Done(False), torch.tensor([2 * 254 + 7], dtype=torch.int32),
            254, 2.0)
    monkeypatch.setattr(C, "_pending", [(Done(True), word, 254, 2.0), late])
    C.check_faults(wait=False)                # the fault is not done yet
    assert C._pending == [late]
    with pytest.raises(RuntimeError, match="panel 7 of agent 2 never"):
        C.check_faults()
    assert C._pending == []


def test_online_serving_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPFleet(FleetConfig(online=True, window=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_gp.main(["--online", "--agents", "2", "--per-agent", "8"])
    from repro_torch.core.online import OnlineExperts
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineExperts.from_numpy({})


def _meta_rbf_gram_inputs(M=3, m=5, N=9, D=2):
    meta = dict(device="meta", dtype=torch.float32)
    return (torch.empty(M, m, D, **meta), torch.empty(M, N, D, **meta),
            torch.empty(M, N, **meta))


def test_rbf_gram_plain_never_takes_a_tensor_off_the_cpu(monkeypatch):
    """Meta tensors stand in for CUDA tensors: the ops and the sparse fit
    send them to the kernel's launch path (its checks refuse a non-CUDA
    device), never to the plain version."""
    from repro_torch.core.sparse import fit_sparse_experts

    def plain(*args, **kw):
        raise AssertionError("plain version reached from a non-CPU tensor")
    monkeypatch.setattr(RG, "rbf_gram_plain", plain)
    Z, X, y = _meta_rbf_gram_inputs()
    ls = torch.ones(2, device="meta")
    before = RG.launches
    with pytest.raises(ValueError, match="CUDA device"):
        ops.kmn_stats_agents(Z, X, y, ls, 1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.rbf_gram(Z[0].double(), X[0].double(), ls.double(), 1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        fit_sparse_experts(torch.zeros(4, device="meta"), X, y, Z)
    assert RG.launches == before


def test_rbf_gram_raises_when_the_loader_fails(monkeypatch):
    def fail(name):
        raise RuntimeError("nvcc not found")

    def plain(*args, **kw):
        raise AssertionError("plain version reached from a non-CPU tensor")
    monkeypatch.setattr(_build, "load_library", fail)
    monkeypatch.setattr(RG, "rbf_gram_plain", plain)
    monkeypatch.setattr(RG, "_check", lambda *args: None)
    RG._library.cache_clear()
    Z, X, _ = _meta_rbf_gram_inputs()
    before = RG.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.rbf_gram_agents(Z, X, torch.ones(2, device="meta"), 1.0)
    assert RG.launches == before
    RG._library.cache_clear()


@pytest.mark.parametrize("bad,match", [
    ("dtype", "float32"), ("contiguous", "contiguous"), ("shape", "want z"),
    ("col0", "col0"), ("params", "params"), ("device", "CUDA device")])
def test_rbf_gram_kernel_input_checks_raise(bad, match):
    Z, X, _ = _meta_rbf_gram_inputs()
    params = torch.empty(2, device="meta")
    col0, width = 0, 9
    if bad == "dtype":
        X = X.double()
    elif bad == "contiguous":
        Z = torch.empty(3, 2, 5, device="meta").transpose(1, 2)
    elif bad == "shape":
        X = torch.empty(3, 9, 3, device="meta")
    elif bad == "col0":
        col0 = 10
    elif bad == "params":
        params = torch.empty(1, device="meta")
    with pytest.raises((ValueError, TypeError), match=match):
        RG._check(Z, X, params, col0, width)


def test_sparse_serving_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPFleet(FleetConfig(sparse_m=8, method="npae_sparse"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_gp.main(["--sparse-m", "4", "--agents", "2",
                       "--per-agent", "8"])


def _meta_flash_inputs(B=1, H=4, KH=2, Sq=8, Sk=8, D=64,
                       dtype=torch.float32):
    meta = dict(device="meta", dtype=dtype)
    return (torch.empty(B, H, Sq, D, **meta), torch.empty(B, KH, Sk, D, **meta),
            torch.empty(B, KH, Sk, D, **meta))


def _meta_stands_for_cuda(monkeypatch, F):
    """Only the CPU and meta (the dry run's shape-only path) take the
    plain version; with meta taken out of that set, meta tensors stand in
    for CUDA tensors here, where no card is."""
    assert F.PLAIN_DEVICES == ("cpu", "meta")
    monkeypatch.setattr(F, "PLAIN_DEVICES", ("cpu",))


def test_flash_attention_plain_never_takes_a_tensor_off_the_cpu(monkeypatch):
    """Meta tensors stand in for CUDA tensors: the op, the kernel module
    and an attention layer send them to the kernel's launch path (its
    checks refuse a non-CUDA device), never to the plain version."""
    from repro_torch.kernels import flash_attention as F
    from repro_torch.configs import get_config
    from repro_torch.models.attention import Attention

    def plain(*args, **kw):
        raise AssertionError("plain version reached from a non-CPU tensor")
    _meta_stands_for_cuda(monkeypatch, F)
    monkeypatch.setattr(F, "flash_attention_plain", plain)
    q, k, v = _meta_flash_inputs()
    before = F.launches
    with pytest.raises(ValueError, match="CUDA device"):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA device"):
        F.flash_attention(q, k, v, window=4)
    cfg = get_config("internlm2-1.8b").reduced()
    attn = Attention(cfg, device="meta")
    x = torch.empty(2, 8, cfg.d_model, device="meta")
    pos = torch.arange(8, device="meta").expand(2, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        attn(x, pos)
    assert F.launches == before


def test_flash_attention_raises_when_the_loader_fails(monkeypatch):
    from repro_torch.kernels import flash_attention as F

    def fail(name):
        raise RuntimeError("nvcc not found")

    def plain(*args, **kw):
        raise AssertionError("plain version reached from a non-CPU tensor")
    _meta_stands_for_cuda(monkeypatch, F)
    monkeypatch.setattr(_build, "load_library", fail)
    monkeypatch.setattr(F, "flash_attention_plain", plain)
    monkeypatch.setattr(F, "_check", lambda *args: None)
    F._library.cache_clear()
    q, k, v = _meta_flash_inputs()
    before = F.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.flash_attention(q, k, v)
    assert F.launches == before
    F._library.cache_clear()


@pytest.mark.parametrize("bad,match", [
    ("dtype", "float32 or all bfloat16"), ("mixed", "float32 or all"),
    ("contiguous", "contiguous"), ("shape", "want q"),
    ("gqa", "multiple of KH"), ("sq>sk", "no admitted key"),
    ("window", "window"), ("dim", "head dimension"),
    ("device", "CUDA device")])
def test_flash_attention_kernel_input_checks_raise(bad, match):
    from repro_torch.kernels import flash_attention as F
    q, k, v = _meta_flash_inputs()
    window = None
    if bad == "dtype":
        q, k, v = _meta_flash_inputs(dtype=torch.float16)
    elif bad == "mixed":
        k = k.bfloat16()
    elif bad == "contiguous":
        q = torch.empty(1, 8, 4, 64, device="meta").transpose(1, 2)
    elif bad == "shape":
        v = torch.empty(1, 2, 8, 32, device="meta")
    elif bad == "gqa":
        q = torch.empty(1, 3, 8, 64, device="meta")
    elif bad == "sq>sk":
        q = torch.empty(1, 4, 9, 64, device="meta")
    elif bad == "window":
        window = 0
    elif bad == "dim":
        q, k, v = _meta_flash_inputs(D=96)
    with pytest.raises((ValueError, TypeError), match=match):
        F._check(q, k, v, window)


def test_flash_attention_kernel_refuses_inputs_that_require_grad(
        monkeypatch):
    """With grad mode on, the launch path refuses an input that requires
    grad (the kernel's output would carry no gradient path) before any
    other check; the op sends such inputs through FlashAttentionFunction,
    whose forward reaches the launch path with grad mode off."""
    from repro_torch.kernels import flash_attention as F
    _meta_stands_for_cuda(monkeypatch, F)
    q, k, v = _meta_flash_inputs()
    q.requires_grad_()
    before = F.launches
    with pytest.raises(RuntimeError, match="FlashAttentionFunction"):
        F._launch(q, k, v, True, None, None)
    with pytest.raises(RuntimeError, match="no gradient path"):
        F.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.flash_attention(q, k, v)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        F._launch(q, k, v, True, None, None)
    assert F.launches == before


def test_lm_training_defaults_to_the_card(no_card):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "1",
                    "--consensus", "dec_admm"])


def test_lm_serving_defaults_to_the_card(no_card):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import LM
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(get_config("internlm2-1.8b").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "internlm2-1.8b", "--reduced"])


@pytest.mark.parametrize("arch", ["dbrx-132b", "whisper-small",
                                  "jamba-v0.1-52b", "xlstm-350m",
                                  "llama4-maverick-400b-a17b",
                                  "internvl2-76b"])
def test_lm_families_run_or_name_their_roadmap_item(arch, capsys):
    """Every family serves a few tokens and takes a training step on the
    CPU through both launchers (MoE, jamba, xLSTM, the VLM prefix and the
    encoder-decoder); none names a ROADMAP item any more. xLSTM runs no
    attention, so its launchers report no attention layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM, build_model
    from repro_torch.launch import serve, train
    cfg = get_config(arch).reduced()
    build_model(cfg, device="cpu")
    serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen", "2"])
    train.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--steps", "1", "--batch", "2", "--seq", "16"])
    text = capsys.readouterr().out
    assert "decoded 2 tokens/seq" in text and "step    0 loss" in text
    assert "not yet ported" not in text
    if arch == "xlstm-350m":
        assert "0 in the prefill (0 attention layers)" in text
        for dense in ("internlm2-1.8b", "chatglm3-6b", "granite-3-8b",
                      "phi3-medium-14b"):
            LM(get_config(dense).reduced(), device="cpu")
