"""Checkpoint/resume for long batched solves (new subsystem —
the reference has none, SURVEY.md §5)."""

import numpy as np
import pytest

import conicip_tpu.parallel.checkpoint as cp
from conicip_tpu.models import batched_box_qp
from conicip_tpu.parallel import (
    load_snapshot,
    solve_batch,
    solve_batch_resumable,
)


@pytest.fixture
def batch_problem():
    return batched_box_qp(batch=6, n=20)


def test_uninterrupted_matches_solve_batch(batch_problem, tmp_path):
    Q, c, A, b, cones = batch_problem
    store = str(tmp_path / "snap.npz")
    out = solve_batch_resumable(Q, c, A, b, cones, store=store,
                                chunk_iters=50, optTol=1e-7)
    assert out.statuses == ["Optimal"] * 6
    ref = solve_batch(Q, c, A, b, cones, optTol=1e-7)
    np.testing.assert_allclose(out.y, ref.y, atol=2e-3)
    info = load_snapshot(store)
    assert info is not None and info.done


def test_preemption_resumes_from_snapshot(batch_problem, tmp_path,
                                          monkeypatch):
    Q, c, A, b, cones = batch_problem
    store = str(tmp_path / "snap.npz")

    # simulate preemption: the second chunk's device call dies
    orig = cp.solve_batch
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt
        return orig(*a, **k)

    monkeypatch.setattr(cp, "solve_batch", flaky)
    with pytest.raises(KeyboardInterrupt):
        solve_batch_resumable(Q, c, A, b, cones, store=store,
                              chunk_iters=3, maxIters=60, optTol=1e-7)
    monkeypatch.setattr(cp, "solve_batch", orig)

    info = load_snapshot(store)
    assert info is not None
    assert info.iters_done == 3
    assert not info.done  # box QPs need ~7 iterations; 3 is mid-flight

    out = solve_batch_resumable(Q, c, A, b, cones, store=store,
                                chunk_iters=50, maxIters=60, optTol=1e-7)
    assert out.statuses == ["Optimal"] * 6
    assert np.maximum(out.prFeas,
                      np.maximum(out.duFeas, out.muFeas)).max() < 1e-7
    # cumulative iteration counts include the pre-preemption chunk
    assert out.Iter.min() > 3


def test_resume_rejects_different_data(batch_problem, tmp_path):
    Q, c, A, b, cones = batch_problem
    store = str(tmp_path / "snap.npz")
    solve_batch_resumable(Q, c, A, b, cones, store=store, chunk_iters=50)
    with pytest.raises(ValueError, match="different problem data"):
        solve_batch_resumable(Q, np.asarray(c) * 2.0, A, b, cones,
                              store=store, chunk_iters=50)


def test_iteration_exhaustion_is_abandoned(batch_problem, tmp_path):
    Q, c, A, b, cones = batch_problem
    store = str(tmp_path / "snap.npz")
    out = solve_batch_resumable(Q, c, A, b, cones, store=store,
                                chunk_iters=1, maxIters=2, optTol=1e-12)
    assert all(s in ("Abandoned", "Optimal") for s in out.statuses)
    assert "Abandoned" in out.statuses  # 1e-12 in 2 iters is not happening


def test_resumable_with_mesh(tmp_path):
    # durable snapshots compose with batch-axis mesh sharding
    from conicip_tpu.parallel import make_mesh

    mesh = make_mesh((8,), ("batch",))
    Q, c, A, b, cones = batched_box_qp(batch=8, n=16)
    store = str(tmp_path / "snap.npz")
    out = solve_batch_resumable(Q, c, A, b, cones, store=store,
                                chunk_iters=4, maxIters=40, mesh=mesh,
                                optTol=1e-7)
    assert out.statuses == ["Optimal"] * 8
    info = load_snapshot(store)
    assert info is not None and info.done
