"""Decentralized ADMM factorized GP training (paper §4), counterpart of
`repro.core.training.admm_decentralized` in its simulated mode.

Edge-formulation consensus ADMM (P4) on a strongly connected graph:
  DEC-c-GP   (eq. 30): nested local optimization per round.
  DEC-apx-GP (eq. 34): closed-form local update (Theorem 1).
  DEC-gapx-GP (Alg. 4): DEC-apx-GP on augmented datasets.

Agents live on a leading axis and neighbour sums are adjacency matmuls —
the reference's semantics for any strongly connected graph. The reference's
`lax.scan` is a Python loop here: the carry stays on the device, and the
per-iteration series (residuals, diagnostics) are stacked on the device at
the end, so a run never waits on the host inside the loop.

Every loop takes the `grad_fn` hook of core.training.cache for the local
NLL gradient (default: the cached-geometry fused path, one nll_grad kernel
launch per gradient evaluation for the whole fleet).

Sharded mode (`train_dec_apx_gp_sharded`): one agent per member of an
agent mesh (`launch.mesh.AgentMesh`), the cycle graph of the members, the
neighbour thetas exchanged by ring hops (`consensus.dac._hop`); each
member builds its own TrainingCache once, so its gradient is one nll_grad
launch an iteration on its own device.

Theorem 1 requires kappa_i > L_i^2/m_i^2 - rho*lambda_min(D+A); the paper
uses kappa_i = 5000, rho = 500 in all experiments and so do we by default.
"""
from __future__ import annotations

import torch

from ...obs.tracing import span
from ..consensus.dac import _hop, ring_allmax, ring_allsum
from .cache import local_nll, make_local_grad


def _graph_terms(A, dtype, device):
    """(A cast for matmul, degree vector), computed once before the loop."""
    Af = torch.as_tensor(A).to(device=device, dtype=dtype)
    return Af, Af.sum(1)


def _init(log_theta0, Xp):
    """Every agent starts at log_theta0: thetas (M, K) and zero duals."""
    lt0 = torch.as_tensor(log_theta0, device=Xp.device).to(Xp.dtype)
    thetas = lt0.expand(Xp.shape[0], lt0.shape[0]).clone()
    return thetas, torch.zeros_like(thetas)


def _disagreement(thetas):
    return (thetas - thetas.mean(0)).abs().max()


def _dec_diag(thetas_next, thetas_prev, Af, rho, aux):
    """Per-iteration diagnostics of the decentralized loops (diag=True):
    primal = worst edge disagreement max_{(i,j) in E} |theta_i - theta_j|,
    dual = rho * max |theta^{s+1} - theta^s|, per-agent NLL and the theta
    trajectory."""
    diffs = (thetas_next[:, None, :] - thetas_next[None, :, :]).abs()
    return {
        "residuals": _disagreement(thetas_next),
        "primal_residuals": (diffs * Af[:, :, None]).max(),
        "dual_residuals": rho * (thetas_next - thetas_prev).abs().max(),
        "nll": local_nll(thetas_next, aux),
        "theta_trajectory": thetas_next,
    }


def _stack(ys):
    """Per-iteration records -> series with a leading iteration axis."""
    if isinstance(ys[0], dict):
        return {k: torch.stack([y[k] for y in ys]) for k in ys[0]}
    return torch.stack(ys)


def _dec_info(ys):
    """diag=True info dict: `residuals` stays the top-level key, the
    extended per-iteration series ride info['diagnostics']."""
    return {"residuals": ys["residuals"], "diagnostics": dict(ys)}


def _dec_record(thetas_next, thetas, Af, rho, aux, diag):
    if diag:
        return _dec_diag(thetas_next, thetas, Af, rho, aux)
    return _disagreement(thetas_next)


def _dec_result(thetas, ys, diag):
    ys = _stack(ys)
    return thetas, (_dec_info(ys) if diag else {"residuals": ys})


def train_dec_c_gp(log_theta0, Xp, yp, A, rho: float = 500.0,
                   iters: int = 100, nested_iters: int = 10,
                   nested_lr: float = 1e-5, grad_fn=None,
                   diag: bool = False):
    """DEC-c-GP (Alg. 2, eq. 30). The nested problem is solved by GD with
    the gradient of Appendix A.2: the local NLL gradient through the
    grad_fn hook, the quadratic and linear terms analytic.

    Returns (thetas (M, K), info); `diag=True` adds per-iteration primal
    and dual residuals, per-agent NLL and the theta trajectory under
    info["diagnostics"]."""
    thetas, p = _init(log_theta0, Xp)
    prepare, lgrad = make_local_grad(grad_fn)
    aux = prepare(Xp, yp)
    Af, deg = _graph_terms(A, thetas.dtype, thetas.device)
    degc = deg[:, None]
    ys = []
    for _ in range(iters):
        nbr_sum = Af @ thetas
        p = p + rho * (degc * thetas - nbr_sum)                     # (30a)
        # obj = L_i(th) + th^T p_i + rho sum_j ||th - (th_i^s + th_j^s)/2||^2
        th = thetas
        for _ in range(nested_iters):                               # (30b)
            g = lgrad(th, aux) + p + rho * (2.0 * degc * th
                                            - (degc * thetas + nbr_sum))
            th = th - nested_lr * g
        ys.append(_dec_record(th, thetas, Af, rho, aux, diag))
        thetas = th
    return _dec_result(thetas, ys, diag)


def dec_apx_update(thetas, p, grads, nbr_sum, deg, rho, kappa):
    """One DEC-apx-GP sweep (34a)-(34b).

    thetas (M, K), p (M, K), grads = grad L_i(theta_i) (M, K),
    nbr_sum = sum_{j in N_i} theta_j (M, K), deg (M,).
    """
    degc = deg[:, None]
    p_next = p + rho * (degc * thetas - nbr_sum)                    # (34a)
    thetas_next = (rho * nbr_sum - grads
                   + (kappa + degc * rho) * thetas - p_next) \
        / (kappa + 2.0 * degc * rho)                                # (34b)
    return thetas_next, p_next


def train_dec_apx_gp(log_theta0, Xp, yp, A, rho: float = 500.0,
                     kappa: float = 5000.0, iters: int = 100, grad_fn=None,
                     diag: bool = False):
    """DEC-apx-GP (Alg. 3 / Theorem 1): closed-form decentralized ADMM.

    Per iteration: the fleet's local gradients through the grad_fn hook
    (by default one nll_grad launch for all agents), one adjacency matmul
    and the closed-form sweep of eq. (34). Returns (thetas (M, K), info)
    with info["residuals"] (iters,), the per-iteration max consensus
    disagreement; `diag=True` adds info["diagnostics"] (see
    train_dec_c_gp)."""
    thetas, p = _init(log_theta0, Xp)
    prepare, lgrad = make_local_grad(grad_fn)
    aux = prepare(Xp, yp)                       # once per fit, NOT per iter
    Af, deg = _graph_terms(A, thetas.dtype, thetas.device)
    ys = []
    for _ in range(iters):
        with span("train.iter"):
            nbr_sum = Af @ thetas
            grads = lgrad(thetas, aux)
            thetas_next, p = dec_apx_update(thetas, p, grads, nbr_sum, deg,
                                            rho, kappa)
            ys.append(_dec_record(thetas_next, thetas, Af, rho, aux, diag))
            thetas = thetas_next
    return _dec_result(thetas, ys, diag)


def train_dec_gapx_gp(log_theta0, Xp_aug, yp_aug, A, rho: float = 500.0,
                      kappa: float = 5000.0, iters: int = 100, grad_fn=None,
                      diag: bool = False):
    """DEC-gapx-GP (Alg. 4): DEC-apx-GP on the augmented datasets D_{+i},
    which the caller builds (sample -> flood -> augment)."""
    return train_dec_apx_gp(log_theta0, Xp_aug, yp_aug, A, rho=rho,
                            kappa=kappa, iters=iters, grad_fn=grad_fn,
                            diag=diag)


# ---------------------------------------------------------------------------
# Sharded mode: one agent per mesh member, ring (cycle) graph, neighbour
# exchange by ring hops
# ---------------------------------------------------------------------------

def dec_apx_gp_sharded_step(thetas, ps, local_grads, rho: float = 500.0,
                            kappa: float = 5000.0):
    """One DEC-apx-GP round on the ring: thetas and ps hold one (K,) tensor
    per member, `local_grads` one callable theta -> (K,) per member (closed
    over that agent's cached geometry). Returns the new (thetas, ps)."""
    M = len(thetas)
    left, right = _hop(thetas, 1), _hop(thetas, -1)
    out_t, out_p = [], []
    for i in range(M):
        th = thetas[i]
        if M == 1:
            nbr_sum = torch.zeros_like(th)      # self-permute: no neighbours
        elif M == 2:
            nbr_sum = left[i]                   # fwd == bwd: ONE neighbour
        else:
            nbr_sum = left[i] + right[i]
        deg = torch.full((1,), float(min(M - 1, 2)), dtype=th.dtype,
                         device=th.device)
        g = local_grads[i](th)
        t2, p2 = dec_apx_update(th[None], ps[i][None], g[None],
                                nbr_sum[None], deg, rho, kappa)
        out_t.append(t2[0])
        out_p.append(p2[0])
    return out_t, out_p


def train_dec_apx_gp_sharded(mesh, axis_name, log_theta0, Xp, yp,
                             rho: float = 500.0, kappa: float = 5000.0,
                             iters: int = 100, grad_fn=None):
    """DEC-apx-GP with agent i on mesh member i (cycle graph over the
    members). Xp (M, Ni, D), yp (M, Ni) with M the mesh size; each
    member's data, cache and iterates live on its device, and the grad_fn
    hook resolves per member (one TrainingCache each, built once).

    Returns (thetas (M, K), info) on member 0's device, with the simulated
    loops' info["residuals"] series — per iteration the worst deviation
    from the members' mean theta, both closed by exact ring reductions —
    and info["p"], the final duals (M, K).
    """
    devices = mesh.devices
    if mesh.shape[axis_name] != Xp.shape[0]:
        raise ValueError(f"{Xp.shape[0]} agents on a mesh of "
                         f"{mesh.shape[axis_name]} members: the sharded "
                         f"loop runs one agent per member")
    prepare, lgrad = make_local_grad(grad_fn)
    thetas, ps, grads = [], [], []
    for i, dev in enumerate(devices):
        Xl = torch.as_tensor(Xp[i:i + 1]).to(dev)
        yl = torch.as_tensor(yp[i:i + 1]).to(dev)
        th, p = _init(torch.as_tensor(log_theta0).to(dev), Xl)
        thetas.append(th[0])
        ps.append(p[0])
        aux = prepare(Xl, yl)
        grads.append(lambda t, aux=aux: lgrad(t[None], aux)[0])
    M = len(devices)
    resids = []
    for _ in range(iters):
        thetas, ps = dec_apx_gp_sharded_step(thetas, ps, grads, rho=rho,
                                             kappa=kappa)
        mean = [s / M for s in ring_allsum(thetas)]
        dev_max = ring_allmax([(t - m).abs().amax()
                               for t, m in zip(thetas, mean)])
        resids.append(dev_max[0])
    d0 = devices[0]
    info = {"residuals": (torch.stack(resids) if resids
                          else Xp.new_zeros(0)),
            "p": torch.stack([p.to(d0) for p in ps])}
    return torch.stack([t.to(d0) for t in thetas]), info
