"""The cholupdate kernel's schedule (repro_torch.kernels.cholupdate
`schedule`) and chip_smoke.py's bound for it, on the CPU.

The kernel is a wavefront over 32-row strips: strip q of an agent applies
the rotations of panels 0 .. q-1 that earlier strips published, then
computes and publishes panel q's. The tests check the work list's
invariants (every producer has a lower ticket than its consumers, one
scratch record per (agent, panel), every output row written by exactly
one strip), and
run the same schedule strip by strip in ticket order in float32 with the
kernel's per-element operations, which must give the plain version's
result bit for bit: the schedule changes the order of the work, never the
arithmetic of an element.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import cholupdate as C

# chip_smoke.py as a module: its top level imports the standard library only
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

torch.set_num_threads(2)


def strip_of(sched, ticket):
    """(kind, agent, index) of a ticket, as csrc/cholupdate.cu decodes it:
    "update" strips in row order, agents interleaved, then "stale"."""
    upd = ticket < sched.M * sched.panels
    u = ticket if upd else ticket - sched.M * sched.panels
    return ("update" if upd else "stale"), u % sched.M, u // sched.M


def producer(sched, agent, panel):
    """Ticket of the strip that publishes `panel` of `agent`."""
    return panel * sched.M + agent

EDGE_N = [1, 31, 32, 33, 63, 64, 65, 777, 8100]


def _edge_cases():
    for n in EDGE_N:
        for shift in sorted({0, 1, n - 1, n}):
            for M in (1, 4):
                yield M, n, shift


def test_bound_counts_the_out_of_place_bytes():
    """Lower triangle of the updated block and the stale rows read once,
    the whole (n, n) output written once, x read: 0.470 ms for the
    paper's four 8,100-point windows at 3.35 TB/s (the bound that left out
    the zeros and the stale rows gave 0.313 ms)."""
    M, n, s = 4, 8100, 1
    m = n - s
    floats = M * (m * (m + 1) // 2 + (n * (n + 1) // 2 - m * (m + 1) // 2)
                  + n * n + m)
    assert floats == 4 * (32_800_950 + 8_100 + 65_610_000 + 8_099)
    bound, by, chain = chip_smoke.cholupdate_bound_ms(M, n, s, 132)
    assert by == "bytes"
    assert bound == pytest.approx(1e3 * 4 * floats / 3.35e12, rel=1e-12)
    assert bound == pytest.approx(0.4701, abs=1e-4)
    assert chain == pytest.approx(1e3 * m * 40 / 1.98e9)


@pytest.mark.parametrize("M,n,shift", list(_edge_cases()))
def test_schedule_invariants(M, n, shift):
    sched = C.schedule(M, n, shift)
    m = n - shift
    assert sched.panels == -(-m // 32) and sched.stale == -(-shift // 32)
    assert sched.tickets == M * (sched.panels + sched.stale)
    assert sched.records == M * sched.panels        # one per (agent, panel)
    assert sched.scratch_words == sched.records * 128 + 2
    rows = np.zeros((M, n), dtype=int)
    produced = {}
    for t in range(sched.tickets):
        kind, a, idx = strip_of(sched, t)
        if kind == "update":
            r0, r1 = 32 * idx, min(m, 32 * idx + 32)
            # strip idx produces panel idx and consumes panels 0 .. idx-1,
            # each produced by a strip with a lower ticket
            assert producer(sched, a, idx) == t
            produced[a, idx] = t
            for p in range(idx):
                assert producer(sched, a, p) < t
                assert produced[a, p] == producer(sched, a, p)
        else:
            assert kind == "stale"
            r0, r1 = m + 32 * idx, min(n, m + 32 * idx + 32)
        assert 0 <= r0 < r1 <= n
        rows[a, r0:r1] += 1
    assert (rows == 1).all()                         # each row exactly once
    assert sorted(produced) == [(a, p) for a in range(M)
                                for p in range(sched.panels)]


def _wavefront(L, x, downdate, shift, active):
    """The kernel's schedule on the CPU: strips in ticket order, each lane
    (row) with its x in a float32 scalar, the rotations of a panel kept as
    the kernel publishes them (c, s / c, sign s, on)."""
    M, n, _ = L.shape
    m, sign = n - shift, (-1.0 if downdate else 1.0)
    tiny = torch.finfo(torch.float32).tiny
    sched = C.schedule(M, n, shift)
    out = torch.full_like(L, float("nan"))          # every element written
    published = {}
    for t in range(sched.tickets):
        kind, a, idx = strip_of(sched, t)
        r0 = 32 * idx if kind == "update" else m + 32 * idx
        r1 = min(m if kind == "update" else n, r0 + 32)
        if active is not None and not bool(active[a]):
            out[a, r0:r1] = L[a, r0:r1]
            continue
        if kind == "stale":
            for r in range(r0, r1):
                out[a, r, :r + 1] = L[a, r, :r + 1]
                out[a, r, r + 1:] = 0
            continue
        src = L[a, shift:, shift:]
        xi = x[a, shift + r0:shift + r1].clone()
        for p in range(idx):
            tile = src[r0:r1, 32 * p:32 * p + 32].clone()
            for k, (c, s_c, sgn_s, on) in enumerate(published[a, p]):
                if on:
                    u = tile[:, k] + sgn_s * xi
                    tile[:, k] = u / c
                    xi = c * xi - s_c * u
            out[a, r0:r1, 32 * p:32 * p + 32] = tile
        tile = src[r0:r1, r0:r1].clone()
        rots, diag = [], {}
        for k in range(r1 - r0):
            Lkk, xk = tile[k, k], xi[k]
            on = bool(xk != 0)
            r, c, s = Lkk, torch.ones_like(Lkk), torch.zeros_like(Lkk)
            if on:
                r = torch.sqrt(torch.clamp(Lkk * Lkk + sign * xk * xk,
                                           min=tiny))
                c, s = r / Lkk, xk / Lkk
            sgn_s, s_c = sign * s, s / c
            if on:
                u = tile[k + 1:, k] + sgn_s * xi[k + 1:]
                tile[k + 1:, k] = u / c
                xi[k + 1:] = c * xi[k + 1:] - s_c * u
                diag[k] = (r * c) / c
            rots.append((c, s_c, sgn_s, on))
        for k, d in diag.items():
            tile[k, k] = d
        published[a, idx] = rots
        out[a, r0:r1, r0:r1] = torch.tril(tile)
        for i in range(r0, r1):
            out[a, i, r1:] = 0
    return out


def _factors(M, n, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 2, (M, n, 2))
    d2 = ((X[:, :, None] - X[:, None]) ** 2 / np.array([1.2, 0.3]) ** 2
          ).sum(-1)
    K = 1.69 * np.exp(-0.5 * d2) + 0.01 * np.eye(n)
    return torch.tensor(np.linalg.cholesky(K), dtype=torch.float32), rng


@pytest.mark.parametrize("M,n,shift,downdate,mask", [
    (2, 70, 1, False, None), (2, 70, 0, False, None), (3, 64, 0, True, None),
    (2, 97, 33, False, None), (3, 33, 32, False, None),
    (4, 65, 1, False, (True, False, True, False)),
    (2, 40, 1, False, (False, False)), (1, 1, 0, False, None),
    (1, 5, 5, False, None)])
def test_wavefront_schedule_is_bitwise_the_plain_version(M, n, shift,
                                                         downdate, mask):
    L, rng = _factors(M, n, n + shift)
    if shift:
        x = L[:, :, 0]
    else:
        x = torch.tensor(0.3 * rng.standard_normal((M, n)),
                         dtype=torch.float32)
        if downdate:           # keep L L^T - x x^T positive definite
            L = C.cholupdate_plain(L, x)
    active = None if mask is None else torch.tensor(mask)
    got = _wavefront(L, x, downdate, shift, active)
    want = C.cholupdate_plain(L, x, downdate, shift, active)
    assert torch.equal(got, want)


def test_wavefront_skips_zero_columns_of_a_partial_window():
    """x zero beyond a window's count (its sentinel rows): those columns
    are skipped, and a zero x leaves the factor bitwise unchanged."""
    L, _ = _factors(2, 75, 7)
    x = L[:, :, 0].clone()
    x[:, 40:] = 0
    assert torch.equal(_wavefront(L, x, False, 1, None),
                       C.cholupdate_plain(L, x, shift=1))
    zero = torch.zeros(2, 75)
    assert torch.equal(_wavefront(L, zero, False, 0, None), L)
