"""Test configuration: run everything on a virtual 8-device CPU mesh.

Run the suite on the CPU with ``JAX_PLATFORMS=cpu PYTHONPATH=. python -m
pytest tests/``; without the variable this file sets it. The tests marked
``chip`` need a GPU and skip without one; on a machine with a card run them
with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m chip tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

# ── fast/slow split ──
# The full suite takes ~22 min on this 1-core host; `pytest -m "not
# slow"` keeps the quick loop under ~10 min. Membership is by measured
# duration (>= ~14 s per test on the 2026-08-20 full run, pytest
# --durations) and maintained here centrally so test files stay clean.
_SLOW_TESTS = {
    "test_gondzio_correctors_cut_iterations",
    "test_batched_sdp_fasteig_certifies",
    "test_kktsolver_schur_tp_general_specs",  # all params
    "test_solve_batch_eliminated_sharded_and_warm",
    "test_lastmile_finishes_without_ladder",
    "test_proactive_lastmile_restores_f64_iteration_counts",
    "test_batched_sdp_fasteig_rescue_tier_certifies",
    "test_kktsolver_schur_tp_cone_sharded_scaling",
    "test_distributed_factor_kernel_exact",
    "test_solve_batch_eliminated_matches_single",
    "test_solve_batch_eliminated_inconsistent_instance",
    "test_solve_batch_sdp_backstop_skips_futile_tier",
    "test_solve_batch_full_rank_G_degenerate",
    "test_example_runs",  # all params
    "test_warm_start_with_equalities",
    "test_miles_2_infeasible",  # all params
    "test_kktsolver_schur_tp_replicated_fallback",
    "test_warm_start_tuple_and_f32",
    "test_with_dense_equality_row",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Release compiled executables between test modules.

    The full suite compiles hundreds of distinct XLA:CPU programs in one
    process; with everything retained, the CPU compiler was observed to
    segfault (deterministically, ~120 programs in) while compiling the
    sharded-elimination program late in the run. Per-module cache clearing
    bounds the live-executable count; cross-module cache reuse is minimal
    anyway (each module compiles its own shapes)."""
    yield
    jax.clear_caches()
