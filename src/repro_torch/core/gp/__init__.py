from .kernel import (cov_grads, cov_matrix, diff2_stack, pack, se_kernel,
                     sq_dists, unpack)
from .nll import (cho_solve, effective_jitter, inner_from_cov, nll,
                  nll_from_cov, nll_grad_analytic, nll_value_and_grad)
from .exact import predict_full, train_full_gp
from .partition import augment, communication_dataset, stripe_partition

__all__ = ["se_kernel", "cov_matrix", "pack", "unpack", "sq_dists",
           "diff2_stack", "cov_grads", "cho_solve", "effective_jitter", "nll_from_cov",
           "inner_from_cov", "nll", "nll_value_and_grad", "nll_grad_analytic",
           "train_full_gp", "predict_full",
           "stripe_partition", "communication_dataset", "augment"]
