"""The port's LM sharding (launch/sharding.py, launch/mesh.py's LM meshes,
launch/steps.py's spec builders, models/act_sharding.py) against the JAX
package, and its meta dry run (launch/dryrun.py), on the CPU.

For every (arch, shape) the reference supports, on the production meshes
(16 x 16 and 2 x 16 x 16; the reference's on a
`jax.sharding.AbstractMesh`, which needs no devices) under both dry-run
policies, the bytes one device holds of the step's inputs (parameters,
optimizer state, batch, cache) equal the reference `build`'s, summed
from each input's `shard_shape`, exactly; and every port parameter's spec
equals its reference leaf's with the stacking axes dropped.
"""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.launch.dryrun import POLICIES as JPOLICIES
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun, mesh as tmesh, sharding as shd, steps
from repro_torch.models import act_sharding
from repro_torch.models.convert import _leaf_index

torch.set_num_threads(2)

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
PAIRS = [(a, s) for a in ARCH_IDS for s in steps.SHAPES
         if steps.shape_supported(get_config(a), s)]


def _ref_bytes(inputs) -> int:
    return sum(math.prod(leaf.sharding.shard_shape(leaf.shape))
               * np.dtype(leaf.dtype).itemsize
               for leaf in jax.tree.leaves(inputs))


def _ref_param_specs(params) -> dict:
    return {tuple(k.key for k in path): tuple(leaf.sharding.spec)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def test_the_same_archs_shapes_and_policies():
    assert ARCH_IDS == JARCH_IDS and len(PAIRS) == 39
    assert list(steps.SHAPES) == list(jsteps.SHAPES)
    assert dryrun.POLICIES == JPOLICIES
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_per_device_bytes_and_param_specs_match_reference(arch, shape):
    for multi_pod, (sizes, names) in MESHES.items():
        jmesh = AbstractMesh(sizes, names)
        pmesh = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert pmesh.shape == dict(jmesh.shape)
        for policy in ("default", "dp"):
            _, jin, _ = jsteps.build(jget_config(arch), shape, jmesh,
                                     policy=JPOLICIES[policy])
            _, tin, cfg = steps.build(get_config(arch), shape, pmesh,
                                      policy=dryrun.POLICIES[policy])
            assert shd.per_device_bytes(tin) == _ref_bytes(jin), \
                (multi_pod, policy)
            model, ref = tin[0], _ref_param_specs(jin[0])
            index = _leaf_index(model)
            for name, p in model.named_parameters():
                assert p.device.type == "meta"
                path, idx = index[name]
                want = ref[path]
                assert want[:len(idx)] == (None,) * len(idx), name
                assert tuple(p.sharding.spec) == want[len(idx):], \
                    (name, multi_pod, policy)


def test_sharding_policy_rules():
    """The reference's test_system.py cases (its copy needs 4 devices and
    skips here), as literals on an abstract (2, 2) mesh, and the same
    calls of the reference's spec_for_axes on a jax AbstractMesh."""
    m = tmesh.LMMesh(("data", "model"), (2, 2))
    jm = AbstractMesh((2, 2), ("data", "model"))
    P = shd.P
    cases = [((("embed", "heads", "head_dim"), (64, 4, 16)), {},
              P("data", "model", None)),
             ((("embed", "heads", "head_dim"), (64, 3, 16)), {},
              P("data", None, None)),
             ((("vocab", "embed"), (49155, 64)), {}, P(None, "data")),
             ((("batch", "kv_seq", "kv_heads", "head_dim"), (1, 1024, 2, 16)),
              {"shard_kv_seq": True}, P(None, ("data", "model"), None, None)),
             ((("batch", "kv_seq", "kv_heads", "head_dim"), (8, 1024, 2, 16)),
              {"shard_kv_seq": True}, P("data", "model", None, None)),
             ((("batch", "kv_seq", "kv_heads", "head_dim"), (8, 1024, 2, 16)),
              {"shard_kv_seq": False}, P("data", None, "model", None))]
    for args, kw, want in cases:
        got = shd.spec_for_axes(m, *args, **kw)
        assert got == want and tuple(jshd.spec_for_axes(jm, *args, **kw)) \
            == want, (args, got)
    assert shd.NamedSharding(m, P(None, ("data", "model"))) \
        .shard_shape((1, 1024)) == (1, 256)
    with pytest.raises(ValueError, match="does not divide"):
        shd.NamedSharding(m, P("data")).shard_shape((3,))


def test_meshes():
    prod = tmesh.make_production_mesh(multi_pod=True)
    assert prod.devices == () and prod.size == 512
    assert tmesh.data_axes(prod) == ("pod", "data")
    assert tmesh.data_axes(tmesh.make_production_mesh()) == ("data",)
    test = tmesh.make_test_mesh(2, 1, devices=("cpu",) * 3)
    assert test.shape == {"data": 2, "model": 1} and len(test.devices) == 2
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmesh.make_test_mesh(2, 2, devices=("cpu",))


def test_make_test_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        tmesh.make_test_mesh(1, 1)


def test_constrain_is_the_identity_and_checks_under_a_mesh():
    x = torch.randn(4, 8, 16)
    assert act_sharding.constrain(x, ("batch", None, None)) is x
    m = tmesh.make_test_mesh(1, 1, devices=("cpu",))
    with act_sharding.use_mesh(m):
        assert act_sharding.constrain(x, ("batch", None, None)) is x
    with act_sharding.use_mesh(tmesh.make_production_mesh()):
        meta = torch.empty(32, 8, device="meta")
        assert act_sharding.constrain(meta, ("batch", None)) is meta
        with pytest.raises(ValueError, match="meta tensors"):
            act_sharding.constrain(x, ("batch", None, None))
    assert act_sharding._CTX.get() is None


def test_placed_prefill_equals_the_unplaced_one():
    """internlm2 reduced on a (1, 1) CPU mesh: parameters placed by their
    specs, a prefill under use_mesh with constrain live, bit for bit the
    prefill without a mesh."""
    cfg = get_config("internlm2-1.8b").reduced()
    from repro_torch.models import build_model
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    prefill = steps.make_prefill_step(cfg, 25)
    want, _ = prefill(model, toks)
    m = tmesh.make_test_mesh(1, 1, devices=("cpu",))
    shd.place(model, m, steps.model_param_specs(model, m))
    calls = []
    real = act_sharding.constrain

    def counted(x, axes):
        calls.append(axes)
        return real(x, axes)
    from repro_torch.models import lm as tlm
    tlm.constrain = counted
    try:
        with act_sharding.use_mesh(m):
            got, _ = prefill(model, toks)
    finally:
        tlm.constrain = real
    assert torch.equal(got, want) and len(calls) == cfg.num_layers
    assert all(p.sharding.mesh is m for p in model.parameters())


@pytest.mark.parametrize("arch,shape", [
    ("internlm2-1.8b", "train_4k"), ("dbrx-132b", "train_4k"),
    ("jamba-v0.1-52b", "decode_32k"), ("internvl2-76b", "prefill_32k"),
    ("whisper-small", "train_4k"), ("xlstm-350m", "decode_32k")])
def test_dryrun_reduced_family_reads_ok(arch, shape, tmp_path):
    """The meta step of one reduced config per family, and its record."""
    rec = dryrun.run_one(arch, shape, True, str(tmp_path), reduced=True,
                         policy="dp")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["cost"]["flops"] > 0 and \
        rec["memory"]["argument_size_in_bytes"] > 0
    assert len(list(tmp_path.iterdir())) == 1


def test_dryrun_full_width_xlstm_record(tmp_path, capsys):
    """One full-width xlstm-350m record through main."""
    dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "xlstm-350m" in out and "ALL OK" in out
    assert len(list(tmp_path.iterdir())) == 1


def test_meta_paths_count_the_loops_flops():
    """The shape-only paths on meta keep the loops' FLOPs: the sLSTM
    traced at once against its step loop (forward and backward), and the
    mamba scan as one chunk against the CPU's 16-token chunks; and
    MetaCache changes no count or shape."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import build_model, xlstm

    def flops(fn):
        with FlopCounterMode(display=False) as fc:
            out = fn()
        return fc.get_total_flops(), out
    cfg = get_config("xlstm-350m").reduced()
    cell = xlstm.SLSTM(cfg, device="meta")
    counts = []
    for run in (xlstm._slstm_steps, xlstm._slstm_traced):
        x = torch.empty(2, 5, cfg.d_model, device="meta", requires_grad=True)
        keep = xlstm._slstm_traced
        xlstm._slstm_traced = run
        try:
            def fwd_bwd():
                out, st = xlstm.slstm_layer(cell, x, cfg)
                (out.sum() + st["c"].sum()).backward()
                return out, st
            n, (out, st) = flops(fwd_bwd)
        finally:
            xlstm._slstm_traced = keep
        counts.append(n)
        assert out.shape == (2, 5, cfg.d_model) and st["m"].shape == \
            (2, cfg.num_heads, cfg.resolved_head_dim)
    assert counts[0] == counts[1] > 0
    jcfg = get_config("jamba-v0.1-52b").reduced(layers=4)
    toks = torch.randint(0, jcfg.vocab_size, (2, 48))
    cpu = build_model(jcfg, device="cpu")
    meta = build_model(jcfg, device="meta", init=False)
    with torch.no_grad():
        n_cpu, out_cpu = flops(lambda: cpu(toks)[0])
        n_meta, out_meta = flops(lambda: meta(toks.to("meta"))[0])
        with dryrun.MetaCache():
            n_cached, out_cached = flops(lambda: meta(toks.to("meta"))[0])
    assert n_cpu == n_meta == n_cached > 0
    assert out_cpu.shape == out_meta.shape == out_cached.shape
