"""Plain reference of the decentralized GP fleet (arXiv:2203.02865): the SE
covariance (eq. 2), local GP moments (eq. 10-11), rBCM aggregation (eq.
14-15) through discrete-time average consensus (eq. 35) on the fleet's
graph, DEC-apx-GP training (eq. 34) with the trace-identity NLL gradient
(eq. 4), and sliding-window factors.

Written from the paper's equations in plain PyTorch: it imports nothing of
the program and takes nothing it made. Every product goes through `mm`, and
the Cholesky factorization and triangular solves are blocked so that their
bulk is `mm` too. `prec` is "float64" (the reference) or "tf32": float32
data whose every product takes operands rounded to TF32 (10 mantissa bits)
and accumulates in float32, as a TF32 tensor-core product does; that is the
control, the reference one precision below the configuration's float32.
"""
from __future__ import annotations

import math

import torch



def block(n: int) -> int:
    """Block size of the factorization and solves: 512, or an eighth of a
    small matrix, so that most of the work is the blocked products."""
    return max(16, min(512, -(-n // 8)))


def dtype_of(prec: str) -> torch.dtype:
    return torch.float64 if prec == "float64" else torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TF32 value (ties away from 0)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "tf32":
        return tf32(a) @ tf32(b)
    return a @ b


def sq_dist(X1, X2, ls):
    """sum_d (x1_d - x2_d)^2 / l_d^2 from exact differences, (N1, N2)."""
    d2 = torch.zeros(X1.shape[0], X2.shape[0], dtype=X1.dtype,
                     device=X1.device)
    for d in range(X1.shape[1]):
        d2 += ((X1[:, None, d] - X2[None, :, d]) / ls[d]) ** 2
    return d2


def se(X1, X2, theta):
    """k(x, x') = sigma_f^2 exp(-sum_d (x_d - x'_d)^2 / l_d^2) (eq. 2;
    theta linear: l_1..l_D, sigma_f, sigma_eps)."""
    D = X1.shape[1]
    return theta[D] ** 2 * torch.exp(-sq_dist(X1, X2, theta[:D]))


def cholesky(C, prec):
    """Lower factor of C (n, n) by right-looking blocked Cholesky; the
    trailing updates are `mm`. A factorization that fails gives NaN."""
    A = C.clone()
    n = A.shape[0]
    b = block(n)
    for k in range(0, n, b):
        e = min(k + b, n)
        Lkk, info = torch.linalg.cholesky_ex(A[k:e, k:e])
        if int(info):
            return torch.full_like(A, math.nan)
        A[k:e, k:e] = Lkk
        if e < n:
            P = torch.linalg.solve_triangular(Lkk, A[e:, k:e].T,
                                              upper=False).T
            A[e:, k:e] = P
            A[e:, e:] -= mm(P, P.T, prec)
    return A.tril()


def solve_lower(L, B, prec):
    """L X = B for lower L (n, n), B (n, k): blocked forward substitution."""
    X = B.clone()
    n = L.shape[0]
    b = block(n)
    for k in range(0, n, b):
        e = min(k + b, n)
        X[k:e] = torch.linalg.solve_triangular(L[k:e, k:e], X[k:e],
                                               upper=False)
        if e < n:
            X[e:] -= mm(L[e:, k:e], X[k:e], prec)
    return X


def solve_upper_t(L, B, prec):
    """L^T X = B for lower L: blocked back substitution."""
    X = B.clone()
    n = L.shape[0]
    b = block(n)
    for k in reversed(range(0, n, b)):
        e = min(k + b, n)
        X[k:e] = torch.linalg.solve_triangular(L[k:e, k:e].T, X[k:e],
                                               upper=True)
        if k:
            X[:k] -= mm(L[k:e, :k].T, X[k:e], prec)
    return X


def factor(X, y, theta, jitter, prec):
    """(L, alpha) of C = K(X, X) + (sigma_eps^2 + jitter) I, alpha = C^-1 y."""
    C = se(X, X, theta)
    C.diagonal().add_(theta[-1] ** 2 + jitter)
    L = cholesky(C, prec)
    del C
    alpha = solve_upper_t(L, solve_lower(L, y[:, None], prec), prec)[:, 0]
    return L, alpha


def local_moments(X, L, alpha, theta, Xs, prec):
    """One agent's posterior mean and variance at Xs (eq. 10-11)."""
    ks = se(X, Xs, theta)
    mean = mm(ks.T, alpha[:, None], prec)[:, 0]
    v = solve_lower(L, ks, prec)
    var = torch.clamp(theta[X.shape[1]] ** 2 - (v * v).sum(0), min=1e-12)
    return mean, var


def perron(A: torch.Tensor) -> torch.Tensor:
    """P = I - eps (D - A) with eps = 1 / (max degree + 1) (Lemma 1)."""
    deg = A.sum(1)
    eps = 1.0 / (float(deg.max()) + 1.0)
    return torch.eye(A.shape[0], dtype=A.dtype) - eps * (torch.diag(deg) - A)


def dac(w0, A, sweeps, prec):
    """The agents' estimates (M, K) after `sweeps` DAC sweeps (eq. 35) from
    their payloads w0 (M, K)."""
    P = perron(A.to(torch.float64)).to(device=w0.device, dtype=w0.dtype)
    w = w0
    for _ in range(sweeps):
        w = mm(P, w, prec)
    return w


def maximin(w) -> float:
    """The consensus residual of estimates w (M, K): the widest spread
    max_i w_ik - min_i w_ik over the K consensuses."""
    return float((w.amax(0) - w.amin(0)).max())


def rbcm(mus, vars_, prior_var, A, sweeps, prec):
    """DEC-rBCM (eq. 14-15): beta_i = (log prior_var - log var_i) / 2,
    the payloads [beta mu / var, beta / var, beta] summed by DAC; the sums
    are M times the agents' mean estimate. Returns (mean, var, the
    consensus residual after the sweeps)."""
    beta = 0.5 * (math.log(prior_var) - torch.log(vars_))
    w0 = torch.stack([beta * mus / vars_, beta / vars_, beta], -1)
    M, Nt = mus.shape
    w0 = w0.reshape(M, -1)
    w = dac(w0, A, sweeps, prec)
    s = (M * w.mean(0)).reshape(Nt, 3)
    prec_ = s[:, 1] + (1.0 - s[:, 2]) / prior_var
    return s[:, 0] / prec_, 1.0 / prec_, maximin(w)


class Fleet:
    """The reference's fitted fleet: per agent (X, L, alpha) at theta."""

    def __init__(self, Xp, yp, theta, jitter, prec):
        self.prec = prec
        self.theta = theta
        self.parts = [(X, *factor(X, y, theta, jitter, prec))
                      for X, y in zip(Xp, yp)]

    def predict(self, Xs, A, sweeps, rows: int = 2048):
        """rBCM answers (mean, var) at Xs, in blocks of `rows` queries, and
        the consensus residual: the widest spread between the agents' DAC
        estimates after the sweeps, over every query."""
        D = Xs.shape[1]
        Xs = Xs.to(self.theta.dtype)
        out_m, out_v = [], []
        res = 0.0
        for s in range(0, Xs.shape[0], rows):
            Xb = Xs[s:s + rows]
            mv = [local_moments(X, L, a, self.theta, Xb, self.prec)
                  for X, L, a in self.parts]
            m, v, r = rbcm(torch.stack([p[0] for p in mv]),
                           torch.stack([p[1] for p in mv]),
                           float(self.theta[D]) ** 2, A, sweeps, self.prec)
            out_m.append(m)
            out_v.append(v)
            res = max(res, r)
        return torch.cat(out_m), torch.cat(out_v), res


# -- training: DEC-apx-GP (eq. 34) ------------------------------------------

def nll_grad(X, y, log_theta, jitter_rel, prec):
    """d NLL / d log theta (eq. 4, trace identity) of one agent:
    0.5 tr((C^-1 - alpha alpha^T) dC/dlog theta_j). The factorization
    jitter (relative to sigma_f^2 + sigma_eps^2) is a constant, not part
    of the model, so it has no derivative."""
    D = X.shape[1]
    theta = torch.exp(log_theta)
    K = se(X, X, theta)
    C = K.clone()
    C.diagonal().add_(theta[D + 1] ** 2
                      + jitter_rel * float(theta[D] ** 2 + theta[D + 1] ** 2))
    L = cholesky(C, prec)
    del C
    eye = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
    Linv = solve_lower(L, eye, prec)
    del L
    Cinv = mm(Linv.T, Linv, prec)
    del Linv
    alpha = mm(Cinv, y[:, None], prec)[:, 0]
    inner = Cinv
    inner -= alpha[:, None] * alpha[None, :]
    W = inner * K
    del K
    g = torch.empty(D + 2, dtype=X.dtype, device=X.device)
    for d in range(D):
        d2 = (X[:, None, d] - X[None, :, d]) ** 2
        g[d] = (W * d2).sum() / theta[d] ** 2
    g[D] = W.sum()
    g[D + 1] = theta[D + 1] ** 2 * inner.diagonal().sum()
    return g


def dec_apx(Xp, yp, log_theta0, A, rho, kappa, iters, jitter_rel, prec):
    """DEC-apx-GP from log_theta0 at every agent, zero duals:
    p <- p + rho (deg theta - sum_j theta_j)                      (34a)
    theta <- (rho sum_j theta_j - grad + (kappa + deg rho) theta - p)
             / (kappa + 2 deg rho)                                (34b)
    Returns (thetas (M, K) in log space, residuals (iters,): per iteration
    the largest |theta_i - mean theta| over agents and components)."""
    M = Xp.shape[0]
    dt, dev = Xp.dtype, Xp.device
    A = A.to(device=dev, dtype=dt)
    deg = A.sum(1)[:, None]
    thetas = log_theta0.to(dt).expand(M, -1).clone()
    p = torch.zeros_like(thetas)
    res = []
    for _ in range(iters):
        nbr = A @ thetas
        g = torch.stack([nll_grad(Xp[i], yp[i], thetas[i], jitter_rel, prec)
                         for i in range(M)])
        p = p + rho * (deg * thetas - nbr)
        thetas = (rho * nbr - g + (kappa + deg * rho) * thetas - p) \
            / (kappa + 2.0 * deg * rho)
        res.append((thetas - thetas.mean(0)).abs().max())
    return thetas, torch.stack(res)


# -- sliding windows ---------------------------------------------------------

def window(X0, y0, xs, ys, W):
    """An agent's window after the stream: its first points X0 (oldest
    first) followed by the streamed xs, the newest W kept."""
    X = torch.cat([X0, xs])[-W:]
    return X, torch.cat([y0, ys])[-W:]
