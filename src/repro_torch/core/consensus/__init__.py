from .dac import (dac, dac_residual, dac_sharded, dac_sharded_residual,
                  dac_time_varying, dac_until, ring_allgather,
                  ring_allmax, ring_allreduce, ring_allsum)
from .dale import dale, dale_sharded
from .degraded import (ConsensusDiverged, dac_masked, dac_masked_sums,
                       masked_perrons, perron_sums, ring_allsum_masked)
from .flooding import flood, flood_sharded
from .graph import (attach_agent, complete_graph, connected_components,
                    cycle_graph, degree_matrix, diameter, is_connected,
                    laplacian, max_degree, path_graph, perron,
                    random_connected_graph, remove_agent)
from .jor import jor, jor_sharded
from .power_method import extreme_eigs, optimal_omega, power_method

__all__ = ["path_graph", "cycle_graph", "complete_graph",
           "random_connected_graph", "degree_matrix", "laplacian",
           "max_degree", "perron", "diameter", "is_connected",
           "connected_components", "attach_agent", "remove_agent",
           "dac", "dac_residual", "dac_until", "dac_time_varying",
           "dac_sharded", "dac_sharded_residual", "ring_allreduce",
           "ring_allgather", "ring_allsum", "ring_allmax",
           "jor", "jor_sharded", "power_method", "extreme_eigs",
           "optimal_omega", "dale", "dale_sharded", "flood",
           "flood_sharded", "ConsensusDiverged", "masked_perrons",
           "dac_masked", "perron_sums", "dac_masked_sums",
           "ring_allsum_masked"]
