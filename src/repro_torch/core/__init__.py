"""GP core of the port: kernels, partitioning, consensus, prediction."""
