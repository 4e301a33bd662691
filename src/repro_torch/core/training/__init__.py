"""GP hyperparameter training (paper §4): the ADMM family and FACT-GP.

Counterpart of `repro.core.training`. The config-driven entry point is
`repro_torch.fleet.GPFleet.fit`, which dispatches to these loops through
the `repro_torch.fleet.TRAINERS` registry; `train_dec_apx_gp_sharded`
runs one agent per member of an agent mesh.
"""
from .admm_centralized import train_apx_gp, train_c_gp, train_gapx_gp
from .admm_decentralized import (dec_apx_gp_sharded_step, dec_apx_update,
                                 train_dec_apx_gp, train_dec_apx_gp_sharded,
                                 train_dec_c_gp, train_dec_gapx_gp)
from .cache import (TrainingCache, build_training_cache, cov_from_cache,
                    make_local_grad, nll_from_cache, nll_grad_cached)
from .factorized import factorized_nll, local_nlls, train_fact_gp

__all__ = [
    "local_nlls", "factorized_nll", "train_fact_gp",
    "train_c_gp", "train_apx_gp", "train_gapx_gp",
    "train_dec_c_gp", "train_dec_apx_gp", "train_dec_gapx_gp",
    "dec_apx_update", "dec_apx_gp_sharded_step",
    "train_dec_apx_gp_sharded",
    "TrainingCache", "build_training_cache", "cov_from_cache",
    "nll_from_cache", "nll_grad_cached", "make_local_grad",
]
