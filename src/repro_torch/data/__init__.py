from .lm_data import MarkovLMData
from .synthetic import (gp_sample_field, grid_inputs, random_inputs,
                        rff_field, sst_like_field)

__all__ = ["MarkovLMData", "gp_sample_field", "grid_inputs",
           "random_inputs", "rff_field", "sst_like_field"]
