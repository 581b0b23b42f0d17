"""lexls_tpu_torch — the PyTorch / CUDA port of lexls_tpu for NVIDIA Hopper.

The batched, warm-started sequence solve through the whole-solve tier,
with the level-panel factorization (kernel B1) and the whole active-set
loop (kernel B2) as hand-written CUDA kernels, over them the
carried-factorization tracker (``tracked=True``), and beside them the
natively batched exact tier, which factorizes through B1 in every
iteration and runs every regularization type (the tracker TIKHONOV and
TIKHONOV_CG).  Over the exact tier, the host API of one hierarchy:
``solve``, ``solve_lambda``, ``solve_collect_wrong_sign``, the working-set
replay (``wset``) and the ``.dat`` corpus I/O (``io``); beside them the
equality façade ``LexLSE`` and ``solve_equality_batched``, one l-QR
through B1 and the basic, least-norm or general-norm solve.  The sequence
entry points (``solve_sequence``, ``solve_sequence_batched`` and the fused and
native batched ones) warm-start each step from the last, and the sharded
factories (``make_sharded_solver``, ``make_sharded_solver_2d``,
``make_sharded_sequence_solver``, ``make_host_mesh``) split a batch over
the ranks of a ``torch.distributed`` device mesh.  Their
``device`` is the card unless the caller passes ``device="cpu"``.  It
imports torch and NumPy only; ``lexls_tpu`` (JAX) is the reference that
the tests hold it against.
"""

__version__ = "0.1.0"

from .types import (
    CtrType,
    EqualityHierarchy,
    InequalityHierarchy,
    LexLSError,
    ObjectiveType,
    OperationType,
    ParametersLexLSE,
    ParametersLexLSI,
    RegularizationType,
    TerminationStatus,
    build_general_hierarchy,
    build_hierarchy_with_bounds,
)
from .lexlsi import (
    LexLSIResult,
    LexLSIState,
    Structure,
    initial_activation,
    solve,
    solve_collect_wrong_sign,
    solve_core,
    solve_core_batched,
    solve_core_fused,
    solve_lambda,
)
from . import io
from .api import LexLSE, LexLSEResult, solve_equality_batched
from .parallel import (batched_initial_arrays, make_host_mesh, make_sharded_solver,
                       make_sharded_solver_2d, solve_batched)
from .sequence import (make_sharded_sequence_solver, solve_sequence, solve_sequence_batched,
                       solve_sequence_batched_fused, solve_sequence_batched_native)
from .tracker import Carried, bootstrap_carried, solve_core_cold_tracked, solve_core_tracked

__all__ = [
    "Carried",
    "CtrType",
    "EqualityHierarchy",
    "InequalityHierarchy",
    "LexLSE",
    "LexLSEResult",
    "LexLSError",
    "LexLSIResult",
    "LexLSIState",
    "ObjectiveType",
    "OperationType",
    "ParametersLexLSE",
    "ParametersLexLSI",
    "RegularizationType",
    "Structure",
    "TerminationStatus",
    "batched_initial_arrays",
    "bootstrap_carried",
    "build_general_hierarchy",
    "build_hierarchy_with_bounds",
    "initial_activation",
    "io",
    "make_host_mesh",
    "make_sharded_sequence_solver",
    "make_sharded_solver",
    "make_sharded_solver_2d",
    "solve",
    "solve_collect_wrong_sign",
    "solve_core",
    "solve_core_batched",
    "solve_core_cold_tracked",
    "solve_core_fused",
    "solve_batched",
    "solve_core_tracked",
    "solve_equality_batched",
    "solve_lambda",
    "solve_sequence",
    "solve_sequence_batched",
    "solve_sequence_batched_fused",
    "solve_sequence_batched_native",
]
