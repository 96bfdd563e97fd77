"""chip_smoke.py and conicip_tpu/runtime.py: the start-up proof's helpers,
and its phases at small sizes on the CPU.

The phase functions take the device to run on and a size, so the same
checks the script runs on the card run here on the CPU device. The tests
marked ``chip`` run the kernel checks at the card's real widths and skip
without a GPU; whether one is present is decided inside the test.
"""

import jax
import numpy as np
import pytest

import chip_smoke as cs
from conicip_tpu import runtime


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture
def gpu():
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run with -m chip on the card)")
    return devices[0]


def test_require_gpu_refuses_a_cpu_process():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu(jax.devices("cpu"))


def test_chip_smoke_exits_nonzero_without_a_gpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


@pytest.mark.parametrize("env", [{}, {"JAX_COMPILATION_CACHE_DIR": "/x/c"}])
def test_compile_cache_dir(env):
    got = runtime.compile_cache_dir(env)
    if env:
        assert got == "/x/c"
    else:
        assert got == runtime.REPO_ROOT + "/.jax_cache"


def test_certificate_rejects_a_perturbed_solution(cpu):
    import conicip_tpu as ct

    p = cs.family_problem("box_qp_dense", small=True)
    sol = ct.conic_ip(*p.args())
    good = cs.certificate(p.Q, p.c, p.A, p.b, p.cone_dims, p.G, p.d,
                          sol.y, sol.w, sol.v)
    assert good["ok"]
    bad = cs.certificate(p.Q, p.c, p.A, p.b, p.cone_dims, p.G, p.d,
                         sol.y + 1e-3, sol.w, sol.v)
    assert not bad["ok"] and bad["dual"] > cs.TOL


@pytest.mark.parametrize("name", cs.FAMILIES)
def test_family_phase_small(cpu, name):
    row = cs.check_family(name, cpu, cpu, small=True)
    assert row["resid"] < cs.TOL and row["cert"] < cs.TOL


@pytest.mark.parametrize("name", cs.BATCHED)
def test_batched_phase_small(cpu, name):
    row = cs.check_batched(name, cpu, batch=6, n_single=2, small=True)
    assert row["cert"] < cs.TOL


def test_kernel_checks_small(cpu):
    exact, acc = cs.check_precise(cpu, 64, 2100)
    assert exact <= 1.0 and acc <= 1.0
    assert max(cs.check_cholesky(cpu, 64).values()) <= 1e-13


def test_cards_phase_batch_mesh_small(cpu):
    devices = jax.devices("cpu")[:4]
    row = cs.check_batch_mesh("batched_box_qp", devices, 8, small=True)
    assert row["dy"] <= 1e-8


def test_cards_phase_tp_small(cpu):
    assert cs.check_tp(jax.devices("cpu")[:4], 64) >= 0.0


@pytest.mark.chip
@pytest.mark.parametrize("shape", [(2000, 1000), (8192, 4096)])
def test_precise_products_exact_on_card(gpu, shape):
    exact, acc = cs.check_precise(gpu, *shape)
    assert exact <= 1.0 and acc <= 1.0


@pytest.mark.chip
def test_cholesky_f64_on_card(gpu):
    assert max(cs.check_cholesky(gpu, 4096).values()) <= 1e-13
