from .kernel import cov_matrix, pack, se_kernel, sq_dists, unpack
from .partition import stripe_partition

__all__ = ["se_kernel", "cov_matrix", "pack", "unpack", "sq_dists",
           "stripe_partition"]
