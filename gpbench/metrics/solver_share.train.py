"""Device time of the library linear algebra of a fit (the kernels
launched by aten::linalg_cholesky_ex, aten::linalg_solve_triangular and
aten::matmul: the Cholesky, the inverse from the factor and its product)
over all device time of the traced slice, in %."""
from gpbench.readings import device_total, percent

OPS = ("aten::linalg_cholesky_ex", "aten::linalg_solve_triangular",
       "aten::matmul")


def read(run):
    if "trace" not in run.layer:
        return None
    ops = run.layer["trace"]["op_device_s"]
    return percent(sum(ops[o] for o in OPS), device_total(run))
