"""Native C++ pivoted-QR kernel vs scipy reference."""

import numpy as np
import pytest
from scipy.linalg import qr as scipy_qr

from conicip_tpu import native


@pytest.fixture
def lib():
    # decided here, not at collection: the library is built on first use
    if not native.available():
        pytest.skip("native lib could not be built")


def test_library_builds_from_source():
    # the library is not committed; a checkout with a C++ toolchain must
    # be able to build it
    assert native.available()


def test_pivoted_qr_matches_scipy(lib, rng):
    for (m, n) in [(5, 8), (8, 5), (10, 10), (1, 7), (30, 12)]:
        A = rng.standard_normal((m, n))
        rdiag, piv = native.pivoted_qr_rank(A)
        _, Rm, piv_s = scipy_qr(A, mode="economic", pivoting=True)
        ref = np.abs(np.diag(Rm)[: min(m, n)])
        np.testing.assert_allclose(rdiag, ref, rtol=1e-10, atol=1e-12)
        # permutations may differ on ties; rank-revealing diag must agree


def test_pivoted_qr_rank_deficient(lib, rng):
    A = rng.standard_normal((4, 10))
    A2 = np.vstack([A, A[0] + A[1], 2 * A[2]])  # rank 4, 6 rows
    rdiag, piv = native.pivoted_qr_rank(A2.T)
    assert np.sum(rdiag > 1e-10) == 4


def test_pivoted_qr_zero_matrix(lib):
    rdiag, piv = native.pivoted_qr_rank(np.zeros((3, 5)))
    assert np.all(rdiag == 0)
    assert sorted(piv.tolist()) == list(range(5))


def test_imcols_uses_native_or_fallback(rng):
    # imcols must work whether or not the native lib is present
    from conicip_tpu.preprocess import imcols

    A = rng.standard_normal((5, 10))
    R, ok = imcols(A, rng.standard_normal(5))
    assert ok and len(R) == 5
