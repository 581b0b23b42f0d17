"""The ``.dat`` hierarchy corpus format (reference ``tools.h:263-270``).

Header tags (any order): ``#HierType`` (100 equalities / 200
inequalities / 210 inequalities + active-set guess), ``#nVar``,
``#nObj``, ``#nCtr`` (one count per level), ``#ObjType`` (100 simple
bounds / 200 general, per level).  Then ``#OBJECTIVE k`` blocks in
ascending order: one constraint per line — a simple-bounds level stores
``var_index(1-based) [b | lb ub]``, a general level ``a_1..a_n [b | lb
ub]``; with HierType 210 an optional trailing activation-type code (0-3)
per row.  Optional ``#SolGuess`` / ``#Solution`` vectors follow.

The port's copy of ``lexls_tpu/io/dat.py``: the same parser, writer and
conversions, building this package's problem containers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..types import (
    EqualityHierarchy,
    InequalityHierarchy,
    LexLSError,
    build_general_hierarchy,
    build_hierarchy_with_bounds,
)

HIER_EQUALITIES = 100
HIER_INEQUALITIES = 200
HIER_INEQUALITIES_WITH_AS = 210
OBJ_SIMPLE = 100
OBJ_GENERAL = 200


@dataclasses.dataclass
class DatHierarchy:
    """Parsed contents of a .dat corpus file."""

    hier_type: int
    n_var: int
    objectives: List[np.ndarray]  # per level, rows x (vars-or-index + bounds)
    obj_type: np.ndarray          # per level, OBJ_SIMPLE / OBJ_GENERAL
    active_set_guess: Optional[List[Optional[np.ndarray]]] = None
    solution_guess: Optional[np.ndarray] = None
    solution: Optional[np.ndarray] = None

    @property
    def n_obj(self) -> int:
        return len(self.objectives)

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple(o.shape[0] for o in self.objectives)

    def active_guess_stacked(self) -> Optional[np.ndarray]:
        if self.active_set_guess is None:
            return None
        parts = [
            g if g is not None else np.zeros(o.shape[0], dtype=np.int64)
            for g, o in zip(self.active_set_guess, self.objectives)
        ]
        return np.concatenate(parts)


def _parse_python(text: str):
    lines = text.split("\n")
    i = 0
    hier_type = n_var = n_obj = None
    n_ctr = obj_type = None

    def strip(s):
        return "".join(s.split())

    # header
    while i < len(lines):
        t = strip(lines[i])
        if t == "#nVar":
            i += 1
            n_var = int(lines[i].split()[0])
        elif t == "#nObj":
            i += 1
            n_obj = int(lines[i].split()[0])
        elif t == "#HierType":
            i += 1
            hier_type = int(lines[i].split()[0])
        elif t == "#nCtr":
            i += 1
            n_ctr = np.array([int(v) for v in lines[i].split()], dtype=np.int32)
        elif t == "#ObjType":
            i += 1
            obj_type = np.array([int(v) for v in lines[i].split()], dtype=np.int32)
        elif t.startswith("#OBJECTIVE"):
            break
        i += 1
        if all(v is not None for v in (hier_type, n_var, n_obj, n_ctr, obj_type)):
            break

    if any(v is None for v in (hier_type, n_var, n_obj, n_ctr, obj_type)):
        raise LexLSError("missing required header field")
    if hier_type not in (HIER_EQUALITIES, HIER_INEQUALITIES, HIER_INEQUALITIES_WITH_AS):
        raise LexLSError("unsupported hierarchy type")
    if len(n_ctr) != n_obj or len(obj_type) != n_obj:
        raise LexLSError("wrong number of objectives in #nCtr/#ObjType")

    n_bounds = 1 if hier_type == HIER_EQUALITIES else 2
    with_as = hier_type == HIER_INEQUALITIES_WITH_AS

    objectives: List[np.ndarray] = []
    as_guess: List[Optional[np.ndarray]] = []
    k = 0
    while k < n_obj and i < len(lines):
        if not strip(lines[i]).startswith("#OBJECTIVE"):
            i += 1
            continue
        i += 1
        if obj_type[k] == OBJ_SIMPLE:
            if k != 0:
                raise LexLSError("simple constraints are supported only in the first objective")
            cols = 1 + n_bounds
        elif obj_type[k] == OBJ_GENERAL:
            cols = n_var + n_bounds
        else:
            raise LexLSError("unsupported objective type")
        rows = int(n_ctr[k])
        data = np.zeros((rows, cols))
        guess = np.zeros(rows, dtype=np.int64) if with_as else None
        for r in range(rows):
            vals = lines[i].split()
            if len(vals) < cols:
                raise LexLSError("not enough data in objective block")
            data[r] = [float(v) for v in vals[:cols]]
            if with_as and len(vals) > cols:
                t = int(vals[cols])
                if t not in (0, 1, 2, 3):
                    raise LexLSError("unsupported constraint activation type")
                guess[r] = t
            i += 1
        objectives.append(data)
        as_guess.append(guess)
        k += 1
    if k != n_obj:
        raise LexLSError("fewer objectives than declared")

    sol_guess = solution = None
    while i < len(lines):
        t = strip(lines[i])
        if t in ("#SolGuess", "#Solution"):
            vals: List[float] = []
            i += 1
            while i < len(lines) and len(vals) < n_var:
                vals.extend(float(v) for v in lines[i].split())
                i += 1
            if len(vals) < n_var:
                raise LexLSError("could not read a solution vector")
            if t == "#SolGuess":
                sol_guess = np.array(vals[:n_var])
            else:
                solution = np.array(vals[:n_var])
        else:
            i += 1

    if not with_as:
        as_guess_out = None
    else:
        as_guess_out = as_guess
    return (hier_type, n_var, n_obj, n_ctr, obj_type, objectives, as_guess_out,
            sol_guess, solution)


def _to_dat(parsed) -> DatHierarchy:
    (hier_type, n_var, n_obj, n_ctr, obj_type, objectives, as_guess,
     sol_guess, solution) = parsed
    return DatHierarchy(
        hier_type=int(hier_type), n_var=int(n_var),
        objectives=[np.asarray(o) for o in objectives],
        obj_type=np.asarray(obj_type),
        active_set_guess=(None if as_guess is None
                          else [None if g is None else np.asarray(g) for g in as_guess]),
        solution_guess=sol_guess, solution=solution,
    )


def load_dat_python(path: str) -> DatHierarchy:
    with open(path) as f:
        return _to_dat(_parse_python(f.read()))


def load_dat(path: str) -> DatHierarchy:
    """Load a .dat hierarchy, preferring the native C++ loader."""
    from .native import native_available, parse_file_native

    if native_available():
        try:
            return _to_dat(parse_file_native(path))
        except RuntimeError as e:
            raise LexLSError(str(e)) from e
    return load_dat_python(path)


# ---------------------------------------------------------------------------
# Conversion to solver problem containers
# ---------------------------------------------------------------------------


def to_inequality(d: DatHierarchy) -> InequalityHierarchy:
    """Build an :class:`InequalityHierarchy` from a parsed inequality file.

    Simple-bounds level-0 variable indexes in the file are 1-based (the
    MEX layer subtracts 1, reference ``lexlsi.cpp:412``)."""
    if d.hier_type == HIER_EQUALITIES:
        raise LexLSError("equality corpus: use to_equality()")
    general = []
    first = 0
    if d.obj_type[0] == OBJ_SIMPLE:
        o0 = d.objectives[0]
        var_idx = o0[:, 0].astype(np.int64) - 1
        first = 1
        for o in d.objectives[1:]:
            general.append((o[:, : d.n_var], o[:, d.n_var], o[:, d.n_var + 1]))
        return build_hierarchy_with_bounds(var_idx, o0[:, 1], o0[:, 2], general,
                                           n_var=d.n_var)
    for o in d.objectives:
        general.append((o[:, : d.n_var], o[:, d.n_var], o[:, d.n_var + 1]))
    return build_general_hierarchy(general)


def to_equality(d: DatHierarchy) -> EqualityHierarchy:
    """Build an :class:`EqualityHierarchy`; a simple-bounds first level
    becomes fixed variables (``lexlse.cpp`` objective-0 convention)."""
    if d.hier_type != HIER_EQUALITIES:
        raise LexLSError("inequality corpus: use to_inequality()")
    fixed_idx = fixed_val = None
    objs = d.objectives
    if d.obj_type[0] == OBJ_SIMPLE:
        fixed_idx = objs[0][:, 0].astype(np.int64) - 1
        fixed_val = objs[0][:, 1]
        objs = objs[1:]
    A = np.concatenate([o[:, : d.n_var] for o in objs], axis=0)
    b = np.concatenate([o[:, d.n_var] for o in objs])
    dims = tuple(o.shape[0] for o in objs)
    return EqualityHierarchy(A=A, b=b, dims=dims, fixed_idx=fixed_idx,
                             fixed_val=fixed_val)


# ---------------------------------------------------------------------------
# Writer (counterpart of the reference's export_hierarchy.m)
# ---------------------------------------------------------------------------


def save_dat(
    path: str,
    d: DatHierarchy,
) -> None:
    """Write a hierarchy in the .dat format readable by both this module
    and the reference's ``HierarchyFileProcessor``."""
    with_as = d.active_set_guess is not None
    hier_type = d.hier_type
    if with_as and hier_type == HIER_INEQUALITIES:
        hier_type = HIER_INEQUALITIES_WITH_AS
    lines = []
    lines.append("# Exported by lexls_tpu_torch")
    lines.append("")
    lines.append("#HierType")
    lines.append(str(hier_type))
    lines.append("")
    lines.append("#nVar")
    lines.append(str(d.n_var))
    lines.append("")
    lines.append("#nObj")
    lines.append(str(d.n_obj))
    lines.append("")
    lines.append("#nCtr")
    lines.append(" ".join(str(o.shape[0]) for o in d.objectives))
    lines.append("")
    lines.append("#ObjType")
    lines.append(" ".join(str(int(t)) for t in d.obj_type))
    lines.append("")
    for k, o in enumerate(d.objectives):
        lines.append(f"#OBJECTIVE {k}")
        guess = d.active_set_guess[k] if with_as else None
        for r in range(o.shape[0]):
            row = " ".join(repr(float(v)) for v in o[r])
            if guess is not None:
                row += f" {int(guess[r])}"
            lines.append(row)
        lines.append("")
    if d.solution_guess is not None:
        lines.append("#SolGuess")
        lines.extend(repr(float(v)) for v in d.solution_guess)
        lines.append("")
    if d.solution is not None:
        lines.append("#Solution")
        lines.extend(repr(float(v)) for v in d.solution)
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def from_inequality(
    prob: InequalityHierarchy,
    active_set_guess: Optional[np.ndarray] = None,
    solution_guess: Optional[np.ndarray] = None,
    solution: Optional[np.ndarray] = None,
) -> DatHierarchy:
    """Build a writable :class:`DatHierarchy` from a problem container
    (stacked guess arrays are split per level)."""
    objectives = []
    obj_type = []
    guesses: Optional[List[Optional[np.ndarray]]] = (
        [] if active_set_guess is not None else None)
    ofs = 0
    for k, dim in enumerate(prob.dims):
        sl = slice(ofs, ofs + dim)
        if k == 0 and prob.simple_bounds:
            data = np.column_stack([
                prob.var_idx.astype(float) + 1, prob.lb[sl], prob.ub[sl]])
            obj_type.append(OBJ_SIMPLE)
        else:
            data = np.column_stack([prob.A[sl], prob.lb[sl], prob.ub[sl]])
            obj_type.append(OBJ_GENERAL)
        objectives.append(data)
        if guesses is not None:
            guesses.append(np.asarray(active_set_guess[sl], dtype=np.int64))
        ofs += dim
    return DatHierarchy(
        hier_type=HIER_INEQUALITIES, n_var=prob.n_var, objectives=objectives,
        obj_type=np.asarray(obj_type, dtype=np.int32),
        active_set_guess=guesses, solution_guess=solution_guess,
        solution=solution,
    )
