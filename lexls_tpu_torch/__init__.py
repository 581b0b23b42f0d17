"""lexls_tpu_torch — the PyTorch / CUDA port of lexls_tpu for NVIDIA Hopper.

The batched, warm-started sequence solve through the whole-solve tier,
with the level-panel factorization (kernel B1) and the whole active-set
loop (kernel B2) as hand-written CUDA kernels, over them the
carried-factorization tracker (``tracked=True``), and beside them the
natively batched exact tier, which factorizes through B1 in every
iteration and runs every regularization type (the tracker TIKHONOV and
TIKHONOV_CG).  It
imports torch and NumPy only; ``lexls_tpu`` (JAX) is the reference that
the tests hold it against.
"""

__version__ = "0.1.0"

from .types import (
    CtrType,
    InequalityHierarchy,
    LexLSError,
    OperationType,
    ParametersLexLSE,
    ParametersLexLSI,
    RegularizationType,
    TerminationStatus,
    build_general_hierarchy,
)
from .lexlsi import (
    LexLSIState,
    Structure,
    initial_activation,
    solve_core_batched,
    solve_core_fused,
)
from .parallel import batched_initial_arrays, solve_batched
from .sequence import solve_sequence_batched_fused, solve_sequence_batched_native
from .tracker import Carried, bootstrap_carried, solve_core_cold_tracked, solve_core_tracked

__all__ = [
    "Carried",
    "CtrType",
    "InequalityHierarchy",
    "LexLSError",
    "LexLSIState",
    "OperationType",
    "ParametersLexLSE",
    "ParametersLexLSI",
    "RegularizationType",
    "Structure",
    "TerminationStatus",
    "batched_initial_arrays",
    "bootstrap_carried",
    "build_general_hierarchy",
    "initial_activation",
    "solve_core_batched",
    "solve_core_cold_tracked",
    "solve_core_fused",
    "solve_batched",
    "solve_core_tracked",
    "solve_sequence_batched_fused",
    "solve_sequence_batched_native",
]
