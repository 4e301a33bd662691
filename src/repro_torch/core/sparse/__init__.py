"""Sparse pseudo-representation experts: O(Ni m^2) agents, collapsed-bound
training, and the low-rank NPAE factors (counterpart of
`repro.core.sparse`).

Import order matters: experts and trainer import nothing of
core.prediction; lowrank defers its aggregation import (prediction.engine
imports this package).
"""
from .experts import (SparseExperts, select_inducing, fit_sparse_experts,
                      sparse_moments_cached, sparse_scores)
from .trainer import (sparse_nll, sparse_nlls, train_fact_sparse,
                      make_sparse_grad)
from .lowrank import (sparse_npae_factors, cross_lowrank,
                      npae_terms_lowrank, dec_npae_sparse)

__all__ = [
    "SparseExperts", "select_inducing", "fit_sparse_experts",
    "sparse_moments_cached", "sparse_scores",
    "sparse_nll", "sparse_nlls", "train_fact_sparse", "make_sparse_grad",
    "sparse_npae_factors", "cross_lowrank", "npae_terms_lowrank",
    "dec_npae_sparse",
]
