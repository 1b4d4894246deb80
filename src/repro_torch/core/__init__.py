"""PS-DSF core of the port: problem containers, gamma, instances, the
dense solve (``psdsf_torch``), the engine entry (``engine.solve``, with
``ensure_converged``), the host lexmm flow router (``flowrouter``) and the
Eq. 16 telemetry (``dynamic.min_vds_guarded``)."""
from .types import Allocation, AllocationProblem
from .gamma import gamma_matrix, gamma_matrix_torch
from .solveinfo import SolveInfo, stranded_fraction
from .engine import ConvergenceError, ensure_converged

__all__ = ["Allocation", "AllocationProblem", "ConvergenceError",
           "SolveInfo", "ensure_converged", "gamma_matrix",
           "gamma_matrix_torch", "stranded_fraction"]
