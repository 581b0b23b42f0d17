"""Where kernels B1 and B2 keep an instance's state: the layout functions
of the wrappers (``ops/fused.py::fused_layout``,
``ops/panel_lqr.py::panel_layout``) against the limits of an H100 SM, and
against the enums of the CUDA sources that index the same arrays.

No JAX and no GPU needed: the layouts are plain Python, and the CUDA
sources are read as text.
"""

import re
from pathlib import Path

import pytest
import torch

from lexls_tpu_torch.ops import fused as fused_mod
from lexls_tpu_torch.ops import panel_lqr as panel_mod
from lexls_tpu_torch.ops import phase1 as phase1_mod
from lexls_tpu_torch.ops.fused import fused_layout
from lexls_tpu_torch.ops.panel_lqr import (SMEM_BLOCK_LIMIT, SMEM_BLOCK_RESERVED,
                                           SMEM_SM_BYTES, odd_stride, pack_regions,
                                           panel_layout)

CSRC = Path(fused_mod.__file__).resolve().parents[1] / "csrc"
DTYPES = [torch.float32, torch.float64]
IDS = ["f32", "f64"]

# (m, n, p, d0, dmax): the bench shape, the test_01 shape (60 bound rows,
# general levels of 33, 3, 2 and 97 rows), and shapes whose state exceeds a
# block's shared memory in float64, and in both types
FUSED_SHAPES = {
    "bench": (120, 100, 4, 0, 30),
    "test_01": (195, 88, 4, 60, 97),
    "n160_m200": (200, 160, 4, 0, 50),
    "n200_m400": (400, 200, 4, 0, 100),
}
PANEL_SHAPES = {"bench": (30, 100), "test_01": (97, 88), "large": (200, 180),
                "larger": (400, 300)}


def _es(dtype):
    return torch.empty(0, dtype=dtype).element_size()


def _up8(nbytes):
    return -(-nbytes // 8) * 8


def _check_regions(lay, names, es):
    """Offsets aligned to the element size (and to 8 bytes), regions in
    order without overlap, all inside the bytes the block asks for."""
    assert len(lay.offsets) == len(lay.sizes) == len(names)
    end = 0
    for name, off, size in zip(names, lay.offsets, lay.sizes):
        assert off % es == 0 and off % 8 == 0, name
        assert off >= end, f"{name} overlaps the region before it"
        end = off + size
    assert end <= lay.nbytes <= end + 8
    assert lay.nbytes <= SMEM_BLOCK_LIMIT


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("shape", list(FUSED_SHAPES))
def test_fused_layout_regions(shape, dtype):
    m, n, p, d0, dmax = FUSED_SHAPES[shape]
    lay = fused_layout(m, n, p, d0, dmax, dtype)
    es = _es(dtype)
    _check_regions(lay, fused_mod.FUSED_REGIONS, es)
    size = dict(zip(fused_mod.FUSED_REGIONS, lay.sizes))
    assert lay.ld == odd_stride(n) and lay.ld % 2 == 1 and lay.ld >= n + 1
    assert size["lod"] == ((m - d0) * lay.ld * es if lay.in_shared else 0)
    assert size["lam"] == p * m * es and size["rhs_all"] == (p - 1) * n * es
    assert size["u"] == dmax * es and size["hh"] == (m - d0) * es
    assert size["fval"] == (n * es if d0 else 0) and size["fmask"] == (n * 4 if d0 else 0)
    assert size["pos"] == size["col_at"] == n * 4 and size["ct"] == m * 4
    for k in ("v", "Ax", "dv", "Adx"):
        assert size[k] == m * es
    assert size["x"] == size["xdx"] == size["cn"] == n * es
    # the step's scratch as StepScratch<T> of this dtype; the bounds, the
    # stamps and the CORRECT_SIGN marks (carried by ct) take no shared memory
    assert size["step"] == 2 * (fused_mod._THREADS // 32) * (4 * es + 2 * 4)
    assert not {"lb", "ub", "st", "sense"} & set(fused_mod.FUSED_REGIONS)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("shape", list(FUSED_SHAPES))
def test_fused_layout_rule_follows_the_bytes(shape, dtype):
    """The LOD lives in shared memory exactly where all of the state fits
    what a thread block may use; forcing a layout changes only the LOD."""
    m, n, p, d0, dmax = FUSED_SHAPES[shape]
    lay = fused_layout(m, n, p, d0, dmax, dtype)
    assert lay.in_shared == (lay.nbytes_all_shared <= SMEM_BLOCK_LIMIT)
    assert lay.in_shared == {("n160_m200", torch.float64): False,
                             ("n200_m400", torch.float32): False,
                             ("n200_m400", torch.float64): False}.get((shape, dtype), True)
    off = fused_layout(m, n, p, d0, dmax, dtype, False)
    on = fused_layout(m, n, p, d0, dmax, dtype, True)
    assert not off.in_shared and on.in_shared
    assert on.nbytes == lay.nbytes_all_shared == off.nbytes_all_shared
    assert on.nbytes - off.nbytes == _up8((m - d0) * lay.ld * _es(dtype))
    assert (lay.nbytes, lay.offsets) == ((on if lay.in_shared else off).nbytes,
                                         (on if lay.in_shared else off).offsets)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_fused_layout_rule_flips_at_the_limit(dtype):
    """Growing the row count one by one, the layout changes at the first m
    whose bytes exceed the limit, and never back."""
    flips = []
    for m in range(100, 700):
        lay = fused_layout(m, 100, 4, 0, 30, dtype)
        assert lay.in_shared == (lay.nbytes_all_shared <= SMEM_BLOCK_LIMIT)
        flips.append(lay.in_shared)
    first = flips.index(False)
    assert 0 < first and all(flips[:first]) and not any(flips[first:])
    before = fused_layout(100 + first - 1, 100, 4, 0, 30, dtype)
    after = fused_layout(100 + first, 100, 4, 0, 30, dtype)
    assert before.nbytes_all_shared <= SMEM_BLOCK_LIMIT < after.nbytes_all_shared
    assert after.nbytes < 32 * 1024  # the small vectors alone


def test_bench_shape_blocks_per_sm():
    """All 384 instances of the bench batch are resident at once in
    float32 (4 blocks on each of 132 SMs, 528 at a time); float64 fits two."""
    f32 = fused_layout(120, 100, 4, 0, 30, torch.float32)
    f64 = fused_layout(120, 100, 4, 0, 30, torch.float64)
    assert f32.in_shared and f32.blocks_per_sm == 4 and 4 * 132 == 528 >= 384
    assert f64.in_shared and f64.blocks_per_sm == 2
    assert fused_layout(120, 100, 4, 0, 30, torch.float64, False).blocks_per_sm >= 3
    assert panel_layout(30, 100, torch.float32).blocks_per_sm >= 3


def test_bench_shape_fits_four_blocks_an_sm_in_float32():
    """Kernel B2's float32 launch bound asks for four resident blocks (at
    most 128 registers a thread): the bench shape's layout leaves room for
    them, 57,344 B a block with the 1 KB each reserves."""
    lay = fused_layout(120, 100, 4, 0, 30, torch.float32)
    assert lay.nbytes <= SMEM_SM_BYTES // 4 - SMEM_BLOCK_RESERVED == 57_344
    src = (CSRC / "fused.cu").read_text()
    assert re.search(r"__launch_bounds__\(kFusedThreads, sizeof\(T\) == 8 \? 2 : 4\)", src)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("shape", list(PANEL_SHAPES))
def test_panel_layout_regions_and_rule(shape, dtype):
    dim, n = PANEL_SHAPES[shape]
    lay = panel_layout(dim, n, dtype)
    es = _es(dtype)
    _check_regions(lay, panel_mod.PANEL_REGIONS, es)
    assert lay.in_shared == (lay.nbytes_all_shared <= SMEM_BLOCK_LIMIT)
    assert lay.in_shared == {("large", torch.float64): False, ("larger", torch.float32): False,
                             ("larger", torch.float64): False}.get((shape, dtype), True)
    size = dict(zip(panel_mod.PANEL_REGIONS, lay.sizes))
    assert size["blk"] == (dim * odd_stride(n) * es if lay.in_shared else 0)
    assert size["den"] == size["hh"] == dim * es and size["cn"] == n * es
    assert size["pos"] == size["col_at"] == size["rank_row"] == n * 4
    forced = panel_layout(dim, n, dtype, False)
    assert not forced.in_shared and forced.nbytes == lay.nbytes_all_shared - _up8(dim * lay.ld * es)


@pytest.mark.parametrize("n", [1, 2, 87, 88, 100, 101])
def test_odd_stride(n):
    ld = odd_stride(n)
    assert ld % 2 == 1 and n + 1 <= ld <= n + 2


def test_pack_regions_aligns_and_drops_the_big_region():
    shared, offsets, sizes, nbytes, all_shared = pack_regions((12, 4, 20), 0, None)
    assert shared and offsets == (0, 16, 24) and sizes == (12, 4, 20) and nbytes == 48
    assert all_shared == 48
    shared, offsets, sizes, nbytes, all_shared = pack_regions((SMEM_BLOCK_LIMIT, 4, 20), 0, None)
    assert not shared and offsets == (0, 0, 8) and sizes == (0, 4, 20) and nbytes == 32
    assert all_shared == SMEM_BLOCK_LIMIT + 32


def _enum(source, name):
    """The enumerators of ``enum name { ... }`` in a CUDA source, without
    the closing count, lower-cased with the prefix and underscores gone."""
    body = re.search(r"enum\s+" + name + r"\s*\{(.*?)\}", source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    items = [w.strip() for w in body.split(",") if w.strip()]
    return items[:-1], items[-1]


def _norm(s):
    return s.replace("_", "").lower()


@pytest.mark.parametrize("enum, prefix, names", [
    ("FusedInput", "kIn", fused_mod.FUSED_INPUTS),
    ("FusedOutput", "kOut", fused_mod.FUSED_OUTPUTS),
    ("FusedInt", "kInt", fused_mod.FUSED_INTS),
    ("FusedReal", "kReal", fused_mod.FUSED_REALS),
    ("FusedRegion", "kReg", fused_mod.FUSED_REGIONS),
])
def test_fused_kernel_indexes_its_arguments_as_the_wrapper_orders_them(enum, prefix, names):
    items, count = _enum((CSRC / "fused.cu").read_text(), enum)
    assert count.startswith("kFused")
    assert [_norm(i[len(prefix):]) for i in items] == [_norm(k) for k in names]


@pytest.mark.parametrize("enum, prefix, count, names", [
    ("ActivationInput", "kActIn", "kActInputs", phase1_mod.ACTIVATION_INPUTS),
    ("ActivationOutput", "kActOut", "kActOutputs", phase1_mod.ACTIVATION_OUTPUTS),
    ("ActivationInt", "kActInt", "kActInts", phase1_mod.ACTIVATION_INTS),
    ("WarmInput", "kWarmIn", "kWarmInputs", phase1_mod.WARM_INPUTS),
    ("WarmOutput", "kWarmOut", "kWarmOutputs", phase1_mod.WARM_OUTPUTS),
    ("WarmInt", "kWarmInt", "kWarmInts", phase1_mod.WARM_INTS),
])
def test_phase1_kernels_index_their_arguments_as_the_wrapper_orders_them(enum, prefix, count,
                                                                         names):
    items, last = _enum((CSRC / "phase1.cu").read_text(), enum)
    assert last == count
    assert [_norm(i[len(prefix):]) for i in items] == [_norm(k) for k in names]


def test_panel_kernel_indexes_its_regions_as_the_wrapper_orders_them():
    items, count = _enum((CSRC / "panel_lqr.cu").read_text(), "PanelRegion")
    assert count == "kPanRegions"
    assert [_norm(i[len("kPan"):]) for i in items] == [_norm(k) for k in panel_mod.PANEL_REGIONS]


def test_kernel_constants_match_the_wrappers():
    """The thread count behind the reduction scratch, the size of the
    step's scalars, and that neither kernel keeps an L buffer or static
    shared memory beside the dynamic allocation the layout sizes."""
    fused = (CSRC / "fused.cu").read_text()
    step = (CSRC / "panel_step.cuh").read_text()
    reduce_ = (CSRC / "block_reduce.cuh").read_text()
    assert re.search(r"kFusedThreads = kStepWarps \* kWarp;", fused)
    assert re.search(r"kWarp\s*=\s*(\d+)", reduce_).group(1) == "32"
    assert "Lbuf" not in fused
    for src in (fused, step, reduce_, (CSRC / "panel_lqr.cu").read_text()):
        assert not re.search(r"^\s*__shared__", src, re.M)
    # StepScratch: two buffers of four candidates, each four reals and two ints
    assert re.search(r"struct StepScratch \{\s*Candidate<T> best\[2\]\[kStepWarps\];\s*\};", step)
    assert re.search(r"kStepWarps\s*=\s*(\d+)", step).group(1) == str(fused_mod._THREADS // 32)
    for es in (4, 8):
        assert panel_mod._step_bytes(es) == 2 * (fused_mod._THREADS // 32) * (4 * es + 2 * 4)
    # at most three block-wide barriers in a pivot step
    body = step[step.index("__device__ bool panel_step"):]
    body = body[:body.index("// After the level's last step")]
    assert 1 <= body.count("__syncthreads()") <= 3
