"""PS-DSF core of the port: problem containers, gamma, instances, the
dense solve (``psdsf_torch``), the engine entry (``engine.solve``, with
``ensure_converged``), the host lexmm flow router (``flowrouter``), the
Eq. 16 telemetry (``dynamic.min_vds_guarded``), the sharing-property
checkers (``properties``) and Section IV's gamma-direct solve
(``extensions``)."""
from .types import Allocation, AllocationProblem
from .gamma import gamma_matrix, gamma_matrix_torch
from .solveinfo import SolveInfo, stranded_fraction
from .engine import ConvergenceError, ensure_converged
from . import extensions, properties
from .extensions import GammaProblem, solve_psdsf_gamma_tdm_torch
from .properties import ALLOCATOR_GUARANTEES_TORCH, Verdict

__all__ = ["ALLOCATOR_GUARANTEES_TORCH", "Allocation", "AllocationProblem",
           "ConvergenceError", "GammaProblem", "SolveInfo", "Verdict",
           "ensure_converged", "extensions", "gamma_matrix",
           "gamma_matrix_torch", "properties", "solve_psdsf_gamma_tdm_torch",
           "stranded_fraction"]
