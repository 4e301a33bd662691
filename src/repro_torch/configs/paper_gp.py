"""The paper's own experiment configuration (§6): synthetic 2-D GP fields and
the SST-like prediction dataset, fleets M in {4, 10, 20, 40}, path graph.

A copy of `repro.configs.paper_gp` (the port imports nothing of the JAX
package); `FleetConfig`'s defaults equal it (tests/test_torch_fullgp.py)."""
from dataclasses import dataclass


@dataclass(frozen=True)
class GPExperimentConfig:
    n_train: int = 8_100                # paper also uses 32_400
    n_test: int = 100
    input_dim: int = 2
    true_theta: tuple = (1.2, 0.3, 1.3, 0.1)   # (l1, l2, sigma_f, sigma_eps)
    theta0: tuple = (2.0, 0.5, 1.0, 1.0)
    fleets: tuple = (4, 10, 20, 40)
    graph: str = "path"                 # path | random | complete
    rho: float = 500.0
    kappa: float = 5_000.0
    lipschitz: float = 5_000.0
    admm_iters: int = 100               # paper: s_end = 100
    nested_lr: float = 1e-5
    replications: int = 10
    eta_nn: float = 0.1                 # CBNN threshold
    noise_sst: float = 0.5              # N(0, 0.25) iid


CONFIG = GPExperimentConfig()
