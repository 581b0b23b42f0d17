"""Marks ``slow`` the heaviest cases of the frozen JAX test file
``tests/test_tracker.py``, which tier-1 (``-m 'not slow'``) then leaves out.

That file tests only the JAX reference ``lexls_tpu.tracker``, and nearly every
case compiles XLA programs of its own on the CPU; it ran 1,414 s on one worker
of a 1,439-s tier-1 run.  Every test function of it keeps at least one case in
tier-1, and the port's tracker tests drive the same JAX paths against the
port.  Run the marked cases with ``pytest -m slow tests/test_tracker.py``.
"""

import pytest

# Heaviest first: the case's seconds in a tier-1 run (junit, 6 workers on an
# 8-core CPU) and the port test that drives the same lexls_tpu.tracker path.
# A case reuses the XLA programs that the cases before it compiled for the
# same shape (one shape per `_drive` trial, one for `test_reg_tracked_cold`),
# so a case is marked together with the later cases that would otherwise pay
# its compilation: the 0.1-0.4-s cases below a heavy one, and one `_drive`
# trial across neighbouring groups (trial 1 in every group; trials 0 and 2
# from `loop_cap_handover` to `pyramid_shrink`; trial 3 stays wherever it is).
TRACKER_SLOW = (
    # 97.7 s; TIKHONOV_CG: test_torch_tracker_reg_cg.py::test_reg_tracked_cold_matches_jax
    "tests/test_tracker.py::test_reg_tracked_cold[0-2]",
    "tests/test_tracker.py::test_reg_tracked_cold[1-2]",
    # 67.2 s; test_torch_tracker_slab.py::test_shrink_matches_jax
    "tests/test_tracker.py::test_tracked_pyramid_shrink[1-shrink1]",
    # 65.7 s; test_torch_tracker.py::test_tracked_matches_jax_tracker[2-kicks2-2-False]
    "tests/test_tracker.py::test_tracked_loop_cap_handover[1-2]",
    # 58.1 s; test_torch_tracker_slab.py::test_shrink_matches_jax[with_loop_cap]
    "tests/test_tracker.py::test_tracked_pyramid_with_loop_cap[1-shrink0-3]",
    # 53.7 s; test_torch_tracker.py::test_tracked_matches_jax_tracker[0-kicks0-0-False]
    "tests/test_tracker.py::test_tracked_small_drift[1]",
    "tests/test_tracker.py::test_tracked_kicks_and_fallback[1]",
    # 53.3 s; test_torch_tracker_slab.py::test_shrink_matches_jax
    "tests/test_tracker.py::test_tracked_pyramid_shrink[0-shrink0]",
    # 49.2, 45.2 s; test_torch_tracker_slab.py::test_debug_fall_matches_jax[2-8]
    "tests/test_tracker.py::test_tracked_handover_slab[1-4-4]",
    "tests/test_tracker.py::test_tracked_handover_slab[2-2-2]",
    # 40.7 s; TIKHONOV: test_torch_tracker_reg.py::test_reg_tracked_cold_matches_jax
    "tests/test_tracker.py::test_reg_tracked_cold[2-1]",
    # 38.2, 37.5 s; test_torch_tracker.py::test_tracked_matches_jax_tracker[1-kicks1-1-False]
    "tests/test_tracker.py::test_tracked_loop_cap_handover[0-1]",
    "tests/test_tracker.py::test_tracked_loop_cap_handover[2-1]",
    # 36.8 s; test_torch_tracker_slab.py::test_shrink_matches_jax
    "tests/test_tracker.py::test_tracked_pyramid_shrink[2-shrink2]",
    # 35.8, 33.1 s; test_torch_tracker.py::test_cold_tracked_matches_jax_tracker
    "tests/test_tracker.py::test_cold_tracked_matches_xla[2]",
    "tests/test_tracker.py::test_cold_tracked_matches_xla[0]",
    # 27.3 s; test_torch_tracker.py::test_tracked_matches_jax_tracker[3-kicks3-1-True]
    "tests/test_tracker.py::test_tracked_trip1_noext[1]",
    # 24.2 s; test_torch_tracker_slab.py::test_debug_fall_matches_jax[2-8]
    "tests/test_tracker.py::test_tracked_handover_slab[0-4-2]",
    # 19.1, 18.3 s; test_torch_tracker.py::test_tracked_matches_jax_tracker[3-kicks3-1-True]
    "tests/test_tracker.py::test_tracked_trip1_noext[0]",
    "tests/test_tracker.py::test_tracked_trip1_noext[2]",
)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in TRACKER_SLOW:
            item.add_marker(pytest.mark.slow)
