from .dac import dac, dac_residual, dac_until
from .graph import (attach_agent, complete_graph, connected_components,
                    cycle_graph, degree_matrix, is_connected, laplacian,
                    max_degree, path_graph, perron, random_connected_graph,
                    remove_agent)

__all__ = ["path_graph", "cycle_graph", "complete_graph",
           "random_connected_graph", "degree_matrix", "laplacian",
           "max_degree", "perron", "is_connected", "connected_components",
           "attach_agent", "remove_agent",
           "dac", "dac_residual", "dac_until"]
