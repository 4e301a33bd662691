"""The rbf_matvec kernel's launch geometry (repro_torch.kernels.rbf_matvec
`geometry`) and chip_smoke.py's bound for it, on the CPU.

One launch covers the fleet: grid (splits, query tiles, M), clusters of
`splits` blocks along the first axis. Block (rank, t, m) takes query tile
t and agent m's points [rank per_split, (rank + 1) per_split) in stages;
inside it, point lane l walks the 4-point chunks l, l + LANES, ... of
each stage. The tests check that the blocks and their lanes' strands
cover every (query, agent, point) exactly once, that the card fills at
the paths' shapes, and run the kernel's fixed summation order in float32
(each lane's strand, the __shfl_xor_sync butterfly, the cluster's ranks
in order), which must agree with the float64 plain version within the
tolerance the card is held to.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rbf_matvec as K

# chip_smoke.py as a module: its top level imports the standard library only
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

torch.set_num_threads(2)

SERVE, SPARSE, LARGEST = (256, 4, 8100, 2), (256, 4, 512, 2), \
    (256, 40, 810, 2)
EDGES = [(1, 4, 8100, 2), (256, 4, 1, 2), (1, 1, 1, 1), (64, 2, 300, 11),
         (17, 3, 65, 11), (4096, 4, 8100, 2), (256, 1, 63, 2),
         (33, 2, 129, 3)]
CASES = sorted(set(chip_smoke.RBF_MATVEC_SHAPES) | {SERVE, SPARSE, LARGEST}
               | set(EDGES))


def strands(g, Ni, rank):
    """Agent points of block `rank`, per point lane in the lane's order of
    accumulation, as csrc/rbf_matvec.cu walks them: stage by stage, chunk
    c = lane, lane + LANES, ... of 4 points, points past the stage's end
    padded (weight 0, left out here)."""
    j0 = min(Ni, rank * g.per_split)
    n_block = min(Ni, j0 + g.per_split) - j0
    lanes = [[] for _ in range(K.LANES)]
    for s0 in range(0, n_block, g.stage):
        n = min(g.stage, n_block - s0)
        for c in range(-(-n // K.CHUNK) * K.CHUNK // 4):
            lanes[c % K.LANES] += [j0 + s0 + p for p in range(4 * c, 4 * c + 4)
                                   if p < n]
    return lanes


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("Nt,M,Ni,D", CASES)
def test_geometry_covers_every_pair_once(Nt, M, Ni, D, sms):
    """Query tiles partition the queries and the (rank, lane) strands
    partition each agent's points, so the blocks (rank, tile, agent)
    cover every (query, agent, point) exactly once; every split holds
    points, a split beyond the first at least one chunk row of them."""
    g = K.geometry(Nt, M, Ni, D, sms)
    assert 1 <= g.splits <= K.MAX_SPLITS
    assert g.blocks == g.splits * g.query_tiles * M
    assert g.stage > 0 and g.stage % K.CHUNK == 0
    queries = np.zeros(Nt, int)
    for t in range(g.query_tiles):
        lo = t * K.QUERIES_PER_BLOCK
        assert lo < Nt                          # no tile without a query
        queries[lo:lo + K.QUERIES_PER_BLOCK] += 1
    assert (queries == 1).all()
    points = np.zeros(Ni, int)
    for rank in range(g.splits):
        mine = [j for lane in strands(g, Ni, rank) for j in lane]
        assert mine or Ni == 0
        assert g.splits == 1 or len(mine) >= K.CHUNK
        np.add.at(points, mine, 1)
    assert (points == 1).all()


@pytest.mark.parametrize("shape", [SERVE, SPARSE, LARGEST])
def test_geometry_fills_the_card(shape):
    """At least one block per SM of an H100 SXM (132) at the serving tile,
    the sparse serving tile and the paper's largest fleet (the two-pass
    kernel this one replaced gave the sparse tile 16 blocks)."""
    assert K.geometry(*shape, 132).blocks >= 132


def test_geometry_at_the_paths_shapes():
    assert K.geometry(*SERVE, 132) == K.Geometry(8, 16, 1013, 1024, 512)
    assert K.geometry(*SPARSE, 132) == K.Geometry(8, 16, 64, 1024, 512)
    assert K.geometry(*LARGEST, 132) == K.Geometry(1, 16, 810, 1024, 640)


def test_wrapper_constants_match_the_source():
    """The wrapper's geometry mirrors the compile-time constants of
    csrc/rbf_matvec.cu (the loaded library is checked again on the card)."""
    src = (_build.CSRC / "rbf_matvec.cu").read_text()

    def const(pattern):
        return int(re.search(pattern, src).group(1))
    assert const(r"kLanes = (\d+);") == K.LANES
    assert const(r"kQ = (\d+);") == K.QUERIES_PER_THREAD
    assert const(r"kStageMax = (\d+);") == K.STAGE
    assert const(r"kThreads = (\d+);") == K.THREADS
    assert const(r"kMaxSplits = (\d+);") == K.MAX_SPLITS
    assert const(r"kBuffers = (\d+);") == 3
    assert "atomic" not in src.replace("no atomics", "")   # a fixed order
    assert "cudaLaunchKernelEx" in src and "map_shared_rank" in src


def test_stage_fits_shared_memory():
    for D in range(1, 65):
        P = K.stage_points(D)
        if P:
            assert P % K.CHUNK == 0
            # with the static slots and scales (at most 1 KB): 48 KB
            assert 4 * (3 * (D + 1) * P + K.QUERIES_PER_BLOCK * D) <= 47 * 1024
    assert K.stage_points(2) == 1024 and K.stage_points(11) == 320
    assert K.stage_points(8) == 384
    assert K.stage_points(0) == K.stage_points(64) == 0


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32)


def emulate(a, b, v, ls, sf2, sms=132):
    """The kernel's arithmetic in float32, in its order: scaled queries
    a'_d = c_d a_d with c_d = sqrt(log2 e) / l_d rounded once, each
    difference one fused multiply-add a'_d - c_d b_d, 2^-d2 (flushed to 0
    below 2^-126), each lane's strand accumulated by fused multiply-adds,
    the lanes' butterfly (offsets 1, 2, 4, 8), the cluster's partials in
    rank order, times sf2. Fused operations are taken in float64 and
    rounded once to float32."""
    Nt, D = a.shape
    M, Ni = v.shape
    g = K.geometry(Nt, M, Ni, D, sms)
    c = _f32(np.sqrt(np.log2(np.e)) / ls.astype(np.float64))
    qa = a * c                                              # float32
    lanes = np.arange(K.LANES)
    out = np.zeros((M, Nt), np.float32)
    for m in range(M):
        total = np.zeros(Nt, np.float32)
        for rank in range(g.splits):
            st = strands(g, Ni, rank)
            acc = np.zeros((Nt, K.LANES), np.float32)
            for step in range(max(len(s) for s in st)):
                j = np.array([s[step] if step < len(s) else 0 for s in st])
                w = np.where([step < len(s) for s in st], v[m, j], 0)
                nd2 = np.zeros((Nt, K.LANES), np.float64)
                for d in range(D):
                    diff = _f32(qa[:, None, d].astype(np.float64)
                                - np.float64(c[d]) * b[m, j, d])
                    nd2 = _f32(nd2 - diff.astype(np.float64) ** 2)
                e = _f32(np.exp2(nd2.astype(np.float64)))
                e[e < 2.0 ** -126] = 0
                acc = _f32(w.astype(np.float64) * e + acc)
            for off in (1, 2, 4, 8)[:int(np.log2(K.LANES))]:
                acc = acc + acc[:, lanes ^ off]                 # float32
            total = total + acc[:, 0]
        out[m] = total * np.float32(sf2)
    return out


@pytest.mark.parametrize("Nt,M,Ni,D", [SERVE, SPARSE, (131, 4, 8099, 2),
                                       (97, 3, 777, 3), (64, 2, 300, 11),
                                       (1, 1, 1, 1), (33, 40, 810, 2)])
def test_summation_order_holds_the_tolerance(Nt, M, Ni, D):
    """The emulated kernel within chip_smoke.REL_TOL of the float64 plain
    version, relative to the summed |terms|, on float32 inputs."""
    rng = np.random.default_rng(Nt + Ni + D)
    a = _f32(2 * rng.random((Nt, D)))
    b = _f32(2 * rng.random((M, Ni, D)))
    v = _f32(rng.normal(size=(M, Ni)))
    ls = _f32(np.full(D, 0.5) if D != 2 else [1.2, 0.3])
    sf2 = np.float32(1.69)
    got = emulate(a, b, v, ls, sf2)
    args = [torch.from_numpy(x.astype(np.float64)) for x in (a, b, v, ls)]
    sf = torch.tensor(float(sf2), dtype=torch.float64)
    want = K.rbf_matvec_plain(*args, sf).numpy()
    scale = K.rbf_matvec_plain(args[0], args[1], args[2].abs(), args[3],
                               sf).numpy()
    err = np.abs(got.astype(np.float64) - want) / scale
    assert err.max() <= chip_smoke.REL_TOL, err.max()


@pytest.mark.parametrize("shape,want", [(SERVE, 0.0019834710743801653),
                                        (SPARSE, 0.00012537496174)])
def test_bound_is_the_sfu_exp_rate(shape, want):
    """8,294,400 and 524,288 exps at 16 a clock an SM, 132 SMs, 1.98 GHz:
    0.00198 ms and 0.000125 ms, far above the bytes' 0.12 us and 0.009 us."""
    bound, by = chip_smoke.rbf_matvec_bound_ms(*shape, 132)
    assert by == "operations"
    assert bound == pytest.approx(want, rel=1e-10)
    Nt, M, Ni, D = shape
    assert bound == pytest.approx(1e3 * Nt * M * Ni / (16 * 132 * 1.98e9),
                                  rel=1e-12)
