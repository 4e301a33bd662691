from .kernel import (cov_grads, cov_matrix, diff2_stack, pack, se_kernel,
                     sq_dists, unpack)
from .nll import (cho_solve, effective_jitter, inner_from_cov, nll,
                  nll_from_cov, nll_grad_analytic)
from .partition import augment, communication_dataset, stripe_partition

__all__ = ["se_kernel", "cov_matrix", "pack", "unpack", "sq_dists",
           "diff2_stack", "cov_grads", "cho_solve", "effective_jitter", "nll_from_cov",
           "inner_from_cov", "nll", "nll_grad_analytic",
           "stripe_partition", "communication_dataset", "augment"]
