from .synthetic import gp_sample_field, grid_inputs, random_inputs

__all__ = ["gp_sample_field", "grid_inputs", "random_inputs"]
