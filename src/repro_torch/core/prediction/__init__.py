"""Decentralized GP prediction (paper §5), DAC family, at three layers.

  per-call wrappers   dec_rbcm / local_moments — raw-data signatures
                      that refactorize every call (reference semantics)
  `*_cached`          consume precomputed Cholesky factors (FittedExperts)
  `*_from_moments`    consensus + aggregation on precomputed moments

Serving front-end: PredictionEngine. The lifecycle API over it is
`repro_torch.fleet`.
"""
from .aggregation import bcm, gpoe, poe, rbcm
from .decentralized import (dec_bcm_from_moments, dec_gpoe_from_moments,
                            dec_poe_from_moments, dec_rbcm,
                            dec_rbcm_from_moments)
from .engine import (FittedExperts, PredictionEngine, fit_experts,
                     map_query_tiles)
from .local import (chol_factors, local_moments, local_moments_cached,
                    stream_means)

__all__ = [
    "chol_factors", "local_moments", "local_moments_cached", "stream_means",
    "poe", "gpoe", "bcm", "rbcm",
    "dec_rbcm",
    "dec_poe_from_moments", "dec_gpoe_from_moments", "dec_bcm_from_moments",
    "dec_rbcm_from_moments",
    "FittedExperts", "fit_experts", "map_query_tiles", "PredictionEngine",
]
