"""The trainers and prediction methods the port knows.

Counterpart of `repro.fleet.registry`, with every trainer and method the
reference registers.

  TRAINERS — the training loops (SPARSE_TRAINERS among them fit sparse
  pseudo-representation experts), each behind a uniform adapter
  `spec.run(cfg, log_theta0, Xp, yp, A, mesh=None, grad_fn=None,
  diag=False) -> (log_theta (K,), thetas (M, K), info)`
  that forwards the FleetConfig's ADMM parameters to the loop unchanged,
  as the reference's adapters do. `diag=True` threads the loops'
  per-iteration diagnostics (primal/dual residuals, per-agent NLL, theta
  trajectories) into info["diagnostics"]; FACT's NLL history is already
  its diagnostic. `needs_augmented_data` trainers (gapx,
  dec-gapx) expect (Xp, yp) to already be the augmented datasets D_{+i};
  the `needs_mesh` trainer (dec-apx-sharded) runs one agent per member of
  an agent mesh (`launch.mesh`).

  METHODS — the 13 decentralized prediction methods of §5 and the low-rank
  `npae_sparse`, with the reference's capability flags: `shardable`
  (servable by the ShardedEngine: the DAC family and npae_sparse),
  `routable` (CBNN query routing: the nn_* DAC methods), `online_safe`
  (the grbcm variants need augmented/communication experts the streaming
  path does not maintain), `needs_augmented_data` (the grBCM
  communication dataset, paper eq. 16-17) and `sparse` (servable from
  sparse pseudo-representation experts; the dense NPAE trio is not);
  `max_slot`, the largest query batch a serving scheduler packs for the
  method (the NPAE family's per-query (M, M) solves cap it at 256); and
  `legacy`, the per-call `dec_*` function that refactorizes every call,
  with `legacy_call(cfg, log_theta, Xp, yp, Xs, A, Xc, yc, Xa, ya)`, a
  uniform adapter over its signature (what `serve_gp --compare-uncached`
  times).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from ..core.prediction import decentralized as dec
from ..core.sparse import (dec_npae_sparse, make_sparse_grad,
                           select_inducing, train_fact_sparse)
from ..launch.mesh import mesh_for
from ..core.training import (train_apx_gp, train_c_gp, train_dec_apx_gp,
                             train_dec_apx_gp_sharded, train_dec_c_gp,
                             train_dec_gapx_gp, train_fact_gp, train_gapx_gp)


class TrainerSpec(NamedTuple):
    """One registered training loop (`run`: see the module docstring)."""
    name: str
    run: Callable
    paper: str
    needs_augmented_data: bool = False
    needs_mesh: bool = False


def _run_fact(cfg, lt0, Xp, yp, A, mesh=None, grad_fn=None, diag=False):
    lt, vals = train_fact_gp(lt0, Xp, yp, steps=cfg.fact_steps,
                             lr=cfg.fact_lr)
    return lt, lt.expand(Xp.shape[0], lt.shape[0]), {"nll": vals}


def _run_c(cfg, lt0, Xp, yp, A, mesh=None, grad_fn=None,
           diag=False):
    return train_c_gp(lt0, Xp, yp, rho=cfg.rho, iters=cfg.admm_iters,
                      nested_iters=cfg.nested_iters, nested_lr=cfg.nested_lr,
                      grad_fn=grad_fn, diag=diag)


def _run_apx(cfg, lt0, Xp, yp, A, mesh=None, grad_fn=None,
             diag=False):
    return train_apx_gp(lt0, Xp, yp, rho=cfg.rho, L=cfg.lipschitz,
                        iters=cfg.admm_iters, grad_fn=grad_fn, diag=diag)


def _run_gapx(cfg, lt0, Xp, yp, A, mesh=None, grad_fn=None,
              diag=False):
    return train_gapx_gp(lt0, Xp, yp, rho=cfg.rho, L=cfg.lipschitz,
                         iters=cfg.admm_iters, grad_fn=grad_fn, diag=diag)


def _run_dec_c(cfg, lt0, Xp, yp, A, mesh=None, grad_fn=None,
               diag=False):
    thetas, info = train_dec_c_gp(lt0, Xp, yp, A, rho=cfg.rho,
                                  iters=cfg.admm_iters,
                                  nested_iters=cfg.nested_iters,
                                  nested_lr=cfg.nested_lr, grad_fn=grad_fn,
                                  diag=diag)
    return thetas.mean(0), thetas, info


def _run_dec_apx(cfg, lt0, Xp, yp, A, mesh=None, grad_fn=None,
                 diag=False):
    thetas, info = train_dec_apx_gp(lt0, Xp, yp, A, rho=cfg.rho,
                                    kappa=cfg.kappa, iters=cfg.admm_iters,
                                    grad_fn=grad_fn, diag=diag)
    return thetas.mean(0), thetas, info


def _run_dec_gapx(cfg, lt0, Xp, yp, A, mesh=None, grad_fn=None,
                  diag=False):
    thetas, info = train_dec_gapx_gp(lt0, Xp, yp, A, rho=cfg.rho,
                                     kappa=cfg.kappa, iters=cfg.admm_iters,
                                     grad_fn=grad_fn, diag=diag)
    return thetas.mean(0), thetas, info


def _run_fact_sparse(cfg, lt0, Xp, yp, A, mesh=None, grad_fn=None,
                     diag=False):
    # collapsed-bound FACT counterpart: joint Adam over (theta, Z); the
    # optimized inducing sets ride info["Z"], so GPFleet caches the sparse
    # factors from the Z the bound was tightened over
    Z0 = select_inducing(Xp, cfg.sparse_m, cfg.inducing_init)
    lt, Z, vals = train_fact_sparse(lt0, Xp, yp, Z0, steps=cfg.fact_steps,
                                    lr=cfg.fact_lr, jitter=cfg.jitter)
    return lt, lt.expand(Xp.shape[0], lt.shape[0]), {"nll": vals, "Z": Z}


def _run_dec_apx_sparse(cfg, lt0, Xp, yp, A, mesh=None, grad_fn=None,
                        diag=False):
    # eq. 34 ADMM with the O(Ni m^2) collapsed-bound local gradient swapped
    # in through the grad_fn hook
    if grad_fn is None:
        grad_fn = make_sparse_grad(cfg.sparse_m, jitter=cfg.jitter)
    return _run_dec_apx(cfg, lt0, Xp, yp, A, grad_fn=grad_fn, diag=diag)


def _run_dec_apx_sharded(cfg, lt0, Xp, yp, A, mesh=None, grad_fn=None,
                         diag=False):
    # the sharded loop has no separate diag mode: its residuals series is
    # always captured (one ring sum and one ring max a round)
    M = Xp.shape[0]
    if mesh is None:
        mesh = mesh_for(M, Xp.device, max_devices=cfg.max_shard_devices)
    ndev = int(mesh.shape["agents"])
    if ndev != M:
        raise ValueError(
            f"trainer 'dec-apx-sharded' runs ONE agent per mesh member "
            f"(cycle graph over the device ring) but the mesh has {ndev} "
            f"device(s) for {M} agents; use trainer 'dec-apx' (simulated "
            f"mode, any device count) or provide an {M}-device mesh")
    thetas, info = train_dec_apx_gp_sharded(mesh, "agents", lt0, Xp, yp,
                                            rho=cfg.rho, kappa=cfg.kappa,
                                            iters=cfg.admm_iters,
                                            grad_fn=grad_fn)
    return thetas.mean(0), thetas, info


TRAINERS: dict[str, TrainerSpec] = {s.name: s for s in (
    TrainerSpec("fact", _run_fact, "§2.3.1 (FACT-GP baseline)"),
    TrainerSpec("c", _run_c, "eq. 24"),
    TrainerSpec("apx", _run_apx, "eq. 26"),
    TrainerSpec("gapx", _run_gapx, "Alg. 1", needs_augmented_data=True),
    TrainerSpec("dec-c", _run_dec_c, "eq. 30"),
    TrainerSpec("dec-apx", _run_dec_apx, "eq. 34 (Thm. 1)"),
    TrainerSpec("dec-gapx", _run_dec_gapx, "Alg. 4",
                needs_augmented_data=True),
    TrainerSpec("dec-apx-sharded", _run_dec_apx_sharded,
                "eq. 34 on an agent mesh (ring of members)",
                needs_mesh=True),
    TrainerSpec("fact-sparse", _run_fact_sparse,
                "§2.3.1 x Titsias 2009 (collapsed ELBO, joint theta + Z)"),
    TrainerSpec("dec-apx-sparse", _run_dec_apx_sparse,
                "eq. 34 with the collapsed-ELBO O(Ni m^2) local gradient"),
)}

SPARSE_TRAINERS = ("fact-sparse", "dec-apx-sparse")


def trainer_names() -> tuple[str, ...]:
    return tuple(TRAINERS)


def get_trainer(name: str) -> TrainerSpec:
    """The registered trainer `name`; an unknown one raises KeyError."""
    spec = TRAINERS.get(name)
    if spec is None:
        raise KeyError(f"unknown trainer {name!r}; registered trainers: "
                       f"{sorted(TRAINERS)}")
    return spec


class MethodSpec(NamedTuple):
    """One registered prediction method (flags: see the module
    docstring). `family` is "dac", "npae" or "sparse" (served from sparse
    pseudo-representation experts only)."""
    name: str
    paper: str
    family: str = "dac"
    shardable: bool = False
    routable: bool = False
    online_safe: bool = True
    needs_augmented_data: bool = False
    sparse: bool = True
    legacy: Callable | None = None
    legacy_call: Callable | None = None
    # largest query-batch slot a serving scheduler packs for this method:
    # the NPAE family's per-query (M, M) solves make big batches memory-
    # heavy, the DAC family tiles flat in the batch size
    max_slot: int = 1024


def _call_dac(fn):
    def call(cfg, lt, Xp, yp, Xs, A, Xc=None, yc=None, Xa=None, ya=None):
        return fn(lt, Xp, yp, Xs, A, iters=cfg.dac_iters)
    return call


def _call_grbcm(cfg, lt, Xp, yp, Xs, A, Xc=None, yc=None, Xa=None, ya=None):
    return dec.dec_grbcm(lt, Xa, ya, Xc, yc, Xs, A, iters=cfg.dac_iters)


def _call_npae(cfg, lt, Xp, yp, Xs, A, Xc=None, yc=None, Xa=None, ya=None):
    return dec.dec_npae(lt, Xp, yp, Xs, A, jor_iters=cfg.jor_iters,
                        dac_iters=cfg.dac_iters, jitter=cfg.npae_jitter)


def _call_npae_star(cfg, lt, Xp, yp, Xs, A, Xc=None, yc=None, Xa=None,
                    ya=None):
    return dec.dec_npae_star(lt, Xp, yp, Xs, A, jor_iters=cfg.jor_iters,
                             dac_iters=cfg.dac_iters, pm_iters=cfg.pm_iters,
                             jitter=cfg.npae_jitter)


def _call_nn(fn):
    def call(cfg, lt, Xp, yp, Xs, A, Xc=None, yc=None, Xa=None, ya=None):
        return fn(lt, Xp, yp, Xs, A, cfg.eta_nn, iters=cfg.dac_iters)
    return call


def _call_nn_grbcm(cfg, lt, Xp, yp, Xs, A, Xc=None, yc=None, Xa=None,
                   ya=None):
    return dec.dec_nn_grbcm(lt, Xa, ya, Xc, yc, Xs, A, cfg.eta_nn,
                            iters=cfg.dac_iters, Xp=Xp)


def _call_nn_npae(cfg, lt, Xp, yp, Xs, A, Xc=None, yc=None, Xa=None,
                  ya=None):
    return dec.dec_nn_npae(lt, Xp, yp, Xs, A, cfg.eta_nn,
                           dale_iters=cfg.dale_iters,
                           jitter=cfg.npae_jitter)


def _call_npae_sparse(cfg, lt, Xp, yp, Xs, A, Xc=None, yc=None, Xa=None,
                      ya=None):
    return dec_npae_sparse(lt, Xp, yp, Xs, cfg.sparse_m,
                           inducing_init=cfg.inducing_init,
                           jitter=cfg.jitter, npae_jitter=cfg.npae_jitter)


def _dac(fn, call=None, **flags):
    """legacy + legacy_call keywords of a DAC-family entry (every one is
    shardable)."""
    return dict(legacy=fn, legacy_call=call or _call_dac(fn),
                shardable=True, **flags)


METHODS: dict[str, MethodSpec] = {s.name: s for s in (
    MethodSpec("poe", "Alg. 5, eq. 12-13", **_dac(dec.dec_poe)),
    MethodSpec("gpoe", "Alg. 6, eq. 12-13", **_dac(dec.dec_gpoe)),
    MethodSpec("bcm", "Alg. 7, eq. 14-15", **_dac(dec.dec_bcm)),
    MethodSpec("rbcm", "Alg. 8, eq. 14-15", **_dac(dec.dec_rbcm)),
    MethodSpec("grbcm", "Alg. 9, eq. 16-17", online_safe=False,
               needs_augmented_data=True,
               **_dac(dec.dec_grbcm, _call_grbcm)),
    MethodSpec("npae", "Alg. 10, eq. 18-21", "npae", sparse=False,
               legacy=dec.dec_npae, legacy_call=_call_npae, max_slot=256),
    MethodSpec("npae_star", "Alg. 11-12 (PM omega*)", "npae",
               sparse=False, legacy=dec.dec_npae_star,
               legacy_call=_call_npae_star, max_slot=256),
    MethodSpec("nn_poe", "Alg. 13, eq. 39", routable=True,
               **_dac(dec.dec_nn_poe, _call_nn(dec.dec_nn_poe))),
    MethodSpec("nn_gpoe", "Alg. 14, eq. 39", routable=True,
               **_dac(dec.dec_nn_gpoe, _call_nn(dec.dec_nn_gpoe))),
    MethodSpec("nn_bcm", "Alg. 15, eq. 39", routable=True,
               **_dac(dec.dec_nn_bcm, _call_nn(dec.dec_nn_bcm))),
    MethodSpec("nn_rbcm", "Alg. 16, eq. 39", routable=True,
               **_dac(dec.dec_nn_rbcm, _call_nn(dec.dec_nn_rbcm))),
    MethodSpec("nn_grbcm", "Alg. 17, eq. 39", routable=True,
               online_safe=False, needs_augmented_data=True,
               **_dac(dec.dec_nn_grbcm, _call_nn_grbcm)),
    MethodSpec("nn_npae", "Alg. 18, eq. 39", "npae", sparse=False,
               legacy=dec.dec_nn_npae, legacy_call=_call_nn_npae,
               max_slot=256),
    MethodSpec("npae_sparse", "Alg. 10 from Titsias low-rank factors "
               "(core.sparse.lowrank)", "sparse", shardable=True,
               online_safe=False,
               legacy=dec_npae_sparse, legacy_call=_call_npae_sparse,
               max_slot=256),
)}

# the reference's sparse=False methods: the dense NPAE family needs the
# cross-Gram blocks of raw training points
_DENSE_ONLY = tuple(n for n, s in METHODS.items() if not s.sparse)


def method_names() -> tuple[str, ...]:
    return tuple(METHODS)


def get_method(name: str) -> MethodSpec:
    """The registered method `name` (hyphens accepted); an unknown one
    raises KeyError."""
    spec = METHODS.get(name.replace("-", "_"))
    if spec is not None:
        return spec
    raise KeyError(f"unknown prediction method {name!r}; registered "
                   f"methods: {sorted(METHODS)}")


def validate_config(cfg) -> None:
    """Reject a FleetConfig that names an unknown trainer or method or
    breaks one of the reference's rules: routed serving needs the sharded
    fleet and a routable method; a sharded fleet serves shardable methods
    only and caches no cross-Gram; a method that is not online-safe on a
    streaming fleet; the sparse trainers and npae_sparse need sparse_m; a
    sparse_m fleet serves no dense-only method, streams no windows and
    caches no cross-Gram."""
    get_trainer(cfg.trainer)
    spec = get_method(cfg.method)
    if cfg.routed and not cfg.sharded:
        raise ValueError("routed serving runs on the sharded fleet; set "
                         "sharded=True (or drop routed)")
    if cfg.sharded and not spec.shardable:
        shardable = sorted(n for n, s in METHODS.items() if s.shardable)
        raise ValueError(
            f"method {cfg.method!r} ({spec.family} family) is not servable "
            f"on the agent-sharded engine — the dense NPAE family needs "
            f"strongly-complete exchange and stays replicated; its low-rank "
            f"counterpart 'npae_sparse' (FleetConfig(sparse_m=...)) does "
            f"shard. Shardable methods: {shardable}")
    if cfg.routed and not spec.routable:
        routable = sorted(n for n, s in METHODS.items() if s.routable)
        raise ValueError(
            f"method {cfg.method!r} is not servable by CBNN query routing; "
            f"routable methods: {routable}")
    if cfg.online and not spec.online_safe:
        raise ValueError(
            f"method {cfg.method!r} is not online-safe: the streaming path "
            f"maintains base experts only, and grbcm variants need "
            f"separately refit augmented/communication experts")
    if cfg.sharded and cfg.cache_cross:
        raise ValueError("the NPAE cross-Gram cache (cache_cross=True) has "
                         "no agent-sharded layout; drop one of the two")
    if cfg.trainer in SPARSE_TRAINERS and cfg.sparse_m is None:
        raise ValueError(
            f"trainer {cfg.trainer!r} fits sparse pseudo-representation "
            f"experts and needs the per-agent inducing count: set "
            f"FleetConfig(sparse_m=...)")
    if spec.family == "sparse" and cfg.sparse_m is None:
        raise ValueError(
            f"method {cfg.method!r} serves from sparse pseudo-"
            f"representation experts; set FleetConfig(sparse_m=...)")
    if cfg.sparse_m is not None:
        if not spec.sparse:
            ok = sorted(n for n, s in METHODS.items() if s.sparse)
            raise ValueError(
                f"method {cfg.method!r} needs the dense O(Ni) per-agent "
                f"factors and cannot serve from sparse pseudo-"
                f"representation experts (sparse_m={cfg.sparse_m}); "
                f"sparse-capable methods: {ok}")
        if cfg.online:
            raise ValueError(
                "sparse_m and online are mutually exclusive: the sliding-"
                "window path maintains dense rank-1 Cholesky updates, not "
                "inducing-point statistics")
        if cfg.cache_cross:
            raise ValueError(
                "cache_cross caches the dense NPAE cross-Gram; sparse "
                "fleets never need it — npae_sparse assembles the cross-"
                "covariance from low-rank factors (docs/sparse_experts.md)")
