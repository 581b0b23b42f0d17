"""The benchmark's configuration ``test01_f64`` (``lexbench/configs/``):
lexls's own test_01 hierarchy in float64, a simple-bounds level under four
general levels, the largest wider than the number of variables.

On the CPU, at a scaled-down copy of its shape, the port's warm fused
path (phase 1's plain versions, then ``solve_core_fused``) solves one cold
step and three warm steps of a drift ring as the benchmark's traffic
draws them, and each answer's level residuals agree with the benchmark's
plain float64 reference (``lexbench/reference/lexls_ref.py``).  At the
full shape, kernel B2's shared memory a block and its resident blocks per
SM, which are plain Python, and the arithmetic of the gauge ``b2.waves``.

This file imports no JAX.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import lexls_tpu_torch as lt
from lexbench.harness import check, traffic
from lexls_tpu_torch.active_set import active_set_kwargs
from lexls_tpu_torch.ops.fused import fused_layout, waves
from lexls_tpu_torch.sequence import _device_initial_activation

torch.set_num_threads(1)

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "lexbench" / "configs"
                     / "test01_f64.json").read_text())
# test_01's shape cut by some 3.5: the bound level, then a wide first
# general level, two small ones and a last one wider than n
SMALL = dict(CONFIG, n_var=24, dims=[20, 9, 3, 2, 26])
B, WARM_STEPS = 4, 3


@pytest.fixture(scope="module")
def run():
    """The steps' instances and answers, and the reference's answers to
    the same instances (one reference solve of each, for the module)."""
    tr = {"batch": B, "ring": {"length": 8, "step": 0.001, "seed": 3}}
    inp = traffic.make_inputs(SMALL, tr, 2 ** 31 + 101, torch.float64, "cpu")
    raw = inp.raw
    struct = lt.Structure(dims=raw.dims, n_var=raw.A.shape[1], simple_bounds=True,
                          var_idx=tuple(int(i) for i in raw.var_idx))
    params = lt.ParametersLexLSI(**SMALL["params"])
    m, n = raw.A.shape
    lbs, ubs = inp.lb.expand(B, m).contiguous(), inp.ub.expand(B, m).contiguous()
    x, v0 = torch.zeros(B, n, dtype=torch.float64), torch.zeros(B, m, dtype=torch.float64)
    ct = torch.zeros(B, m, dtype=torch.int32)
    steps = []
    for k in range(1 + WARM_STEPS):
        t = inp.phase + k
        c, s, ns = _device_initial_activation(inp.A(t), lbs, ubs, ct, struct)
        st = lt.solve_core_fused(inp.A(t), lbs, ubs, c, s, ns, x, v0, None, struct=struct,
                                 params=params, x_guess_specified=k > 0, v0_specified=False)
        steps.append((t, st))
        x, ct = st.x, st.ctr_type
    lb, ub = inp.lb.numpy(), inp.ub.numpy()
    problems = [(inp.instance(t, b), lb, ub) for t, _ in steps for b in range(B)]
    answers = [st.x[b].numpy() for _, st in steps for b in range(B)]
    refs = check.solve_all(problems, SMALL, workers=1)
    return steps, problems, answers, refs


def test_every_step_is_solved_and_warm_steps_start_hot(run):
    steps, _, _, refs = run
    for _, st in steps:
        assert (st.status == int(lt.TerminationStatus.PROBLEM_SOLVED)).all()
        assert torch.isfinite(st.x).all()
    assert all(status == 0 for _, status, _ in refs)
    cold, warm = steps[0][1].it, torch.stack([st.it for _, st in steps[1:]])
    assert warm.max() < cold.min()  # a 1e-3 drift from the last answer costs few iterations


@pytest.mark.parametrize("step", range(1 + WARM_STEPS))
def test_level_residuals_match_the_float64_reference(run, step):
    _, problems, answers, refs = run
    for i in range(step * B, (step + 1) * B):
        A, lb, ub = problems[i]
        gap = check.gap(A, lb, ub, SMALL["dims"], answers[i], refs[i][0])
        assert gap <= 1e-8, (step, i - step * B, gap)


@pytest.mark.parametrize("dtype,nbytes,per_sm", [(torch.float64, 118_592, 1),
                                                  (torch.float32, 60_336, 3)],
                         ids=["f64", "f32"])
def test_b2_layout_at_the_full_shape(dtype, nbytes, per_sm):
    """B2's layout as its wrapper asks for it at test_01's shape: four
    general levels (the bound level is ``d0``), the largest of 97 rows.
    In float64 one block fits an SM: two would need 115,712 B at most."""
    raw = traffic.hierarchy(CONFIG)
    struct = lt.Structure(dims=raw.dims, n_var=CONFIG["n_var"], simple_bounds=True,
                          var_idx=tuple(int(i) for i in raw.var_idx))
    kw = active_set_kwargs(struct, lt.ParametersLexLSI(**CONFIG["params"]), "cpu")
    m, n, p = raw.A.shape + (len(kw["dims"]),)
    lay = fused_layout(m, n, p, kw["d0"], max(kw["dims"]), dtype)
    assert (m, n, p, kw["d0"]) == (209, 88, 4, 74)
    assert lay.in_shared and lay.nbytes == nbytes and lay.blocks_per_sm == per_sm
    if dtype == torch.float64:
        assert lay.nbytes > 233_472 // 2 - 1_024


@pytest.mark.parametrize("batch,per_sm,sms,want", [(384, 1, 132, 3), (384, 3, 132, 1),
                                                    (396, 3, 132, 1), (397, 3, 132, 2)])
def test_waves_round_the_batch_up_to_whole_rounds_of_blocks(batch, per_sm, sms, want):
    assert waves(batch, per_sm, sms) == want
