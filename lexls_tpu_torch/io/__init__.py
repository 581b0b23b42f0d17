"""Hierarchy corpus I/O (reference layer L7, ``include/lexls/tools.h``).

A copy of ``lexls_tpu/io`` (which imports no JAX, but belongs to the JAX
package), so that the port reads the corpus on a machine without JAX.
``load_dat`` reads the text ``.dat`` hierarchy format via the native C++
loader (``native/src/hierarchy_io.cpp``) when available, falling back to
the pure-Python parser.  ``save_dat`` writes it (counterpart of the
reference's MATLAB ``export_hierarchy.m``).
"""

from .dat import (
    DatHierarchy,
    from_inequality,
    load_dat,
    load_dat_python,
    save_dat,
    to_equality,
    to_inequality,
)
from .native import native_available

__all__ = [
    "DatHierarchy",
    "from_inequality",
    "load_dat",
    "load_dat_python",
    "save_dat",
    "to_equality",
    "to_inequality",
    "native_available",
]
