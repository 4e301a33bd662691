"""Decentralized GP prediction (paper §5): the 13 methods at three layers.

  per-call wrappers   dec_* / local_moments / npae_terms / cbnn_mask —
                      raw-data signatures that refactorize every call
                      (reference semantics)
  `*_cached`          consume precomputed Cholesky factors (FittedExperts)
  `*_from_moments` / `*_from_terms`
                      consensus + aggregation on precomputed local
                      quantities

Serving front-ends: PredictionEngine (every agent on one device) and
ShardedEngine (the agent axis over an agent mesh). The lifecycle API over
them is `repro_torch.fleet`.
"""
from .aggregation import bcm, gpoe, grbcm, npae, poe, rbcm
from .cbnn import (cbnn_mask, cbnn_mask_cached, cbnn_scores,
                   cbnn_scores_cached)
from .decentralized import (dec_bcm, dec_bcm_from_moments, dec_gpoe,
                            dec_gpoe_from_moments, dec_grbcm,
                            dec_grbcm_from_moments, dec_nn_bcm, dec_nn_gpoe,
                            dec_nn_grbcm, dec_nn_npae,
                            dec_nn_npae_from_terms, dec_nn_poe, dec_nn_rbcm,
                            dec_npae, dec_npae_from_terms, dec_npae_star,
                            dec_npae_star_from_terms, dec_poe,
                            dec_poe_from_moments, dec_rbcm,
                            dec_rbcm_from_moments)
from .engine import (FittedExperts, PredictionEngine, fit_experts,
                     map_query_tiles)
from .sharded import (ShardedEngine, expert_specs, replicated_specs,
                      shard_experts)
from .local import (chol_factors, cross_gram, local_moments,
                    local_moments_cached, npae_terms, npae_terms_cached,
                    stream_means)

__all__ = [
    "chol_factors", "local_moments", "local_moments_cached", "stream_means",
    "cross_gram", "npae_terms", "npae_terms_cached",
    "cbnn_scores", "cbnn_mask", "cbnn_scores_cached", "cbnn_mask_cached",
    "poe", "gpoe", "bcm", "rbcm", "grbcm", "npae",
    "dec_poe", "dec_gpoe", "dec_bcm", "dec_rbcm", "dec_grbcm",
    "dec_npae", "dec_npae_star", "dec_nn_poe", "dec_nn_gpoe", "dec_nn_bcm",
    "dec_nn_rbcm", "dec_nn_grbcm", "dec_nn_npae",
    "dec_poe_from_moments", "dec_gpoe_from_moments", "dec_bcm_from_moments",
    "dec_rbcm_from_moments", "dec_grbcm_from_moments",
    "dec_npae_from_terms", "dec_npae_star_from_terms",
    "dec_nn_npae_from_terms",
    "FittedExperts", "fit_experts", "map_query_tiles", "PredictionEngine",
    "ShardedEngine", "expert_specs", "replicated_specs", "shard_experts",
]
