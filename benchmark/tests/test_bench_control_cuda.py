"""The comparison's control on the card (marker `cuda`; skips without one):
each cell at its published widths with a few rows, once as configured
(correct) and once with its control (not correct): for the transcribe
cells the program's int8 path and the reference's float8 front-end,
positional conv and norms in place; for the fine-tune cell the reference
with float8 operands in the program's place, and the fault of a step fed
half its batch.  Run on the card with

    python -m pytest -m cuda benchmark/tests/test_bench_control_cuda.py
"""
import os
import time

import pytest

from conftest import add_small_cell

import harness

SMALL = {"d768-transcribe-20s": {"rows": 4, "pool_batches": 3, "check_among": 2,
                                  "check_batches": 1, "check_rows": 2, "trace_calls": 2},
         "d768-finetune-20s": {"rows": 8, "trace_steps": 1}}
SMALL["d1024x12-transcribe-short"] = SMALL["d768-transcribe-20s"]
CONTROLS = {"d768-transcribe-20s": ["int8"], "d1024x12-transcribe-short": ["int8"],
            "d768-finetune-20s": ["fp8", "half_batch"]}


@pytest.mark.cuda
@pytest.mark.parametrize("base", sorted(SMALL))
@pytest.mark.parametrize("seed", [11, 2**35 + 1, 4000000007])
def test_control_fails_and_the_program_passes(bench_copy, base, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench, manifest = bench_copy
    add_small_cell(bench, manifest, base, "small", SMALL[base])
    cell = harness.Cell(manifest, "small", bench)
    workdir = os.path.dirname(bench)
    sound, _ = harness.run_cell(cell, seed, 1.0, False, "cuda", workdir, time.perf_counter())
    assert sound["correct"], sound["checks"]
    for variant in CONTROLS[base]:
        control, _ = harness.run_cell(cell, seed, 1.0, False, "cuda", workdir,
                                      time.perf_counter(), variant=variant)
        assert not control["correct"], (variant, control["checks"])
