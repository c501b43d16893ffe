"""chip_smoke.py's phase functions at tiny N on the CPU (jnp, and the
Pallas kernel in interpret mode), plus its refusal to run without a GPU."""

import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke as cs

BACKENDS = [("jnp", False), ("pallas", True)]


@pytest.mark.parametrize("n", [33, 300])
def test_phase_force(n):
    r = cs.phase_force(n, 16, ("jnp", "pallas"), interpret=True)
    assert r["ok"], r
    assert {"unit_jnp", "unit_pallas", "plummer_jnp",
            "plummer_pallas"} <= set(r)


@pytest.mark.parametrize("backend,interp", BACKENDS)
def test_phase_memory(backend, interp):
    r = cs.phase_memory(256, 4099, backend, interpret=interp)
    assert r["ok"], r
    assert r["ragged_jnp_step"]["temp_size_in_bytes"] < r["ragged_temp_bound"]


@pytest.mark.parametrize("backend,interp", BACKENDS)
def test_phase_euler(backend, interp):
    r = cs.phase_euler(128, 5, backend, interpret=interp)
    assert r["ok"] and r["trajectory_rel"] <= cs.FORCE_TOL, r


@pytest.mark.parametrize("backend,interp", BACKENDS)
def test_phase_drift(backend, interp):
    r = cs.phase_drift(96, 50, backend, interpret=interp)
    assert r["ok"] and r["drift"] <= cs.DRIFT_TOL, r


@pytest.mark.parametrize("backend,interp", BACKENDS)
def test_phase_timing(backend, interp):
    r = cs.phase_timing(64, 2, backend, interpret=interp, reps=1)
    assert r["ok"] and r["backend"] == backend and r["window_s"] > 0, r


@pytest.mark.parametrize("backend,interp", BACKENDS)
def test_phase_ensemble(backend, interp):
    r = cs.phase_ensemble(3, 40, 3, backend, interpret=interp)
    assert r["ok"], r


@pytest.mark.parametrize("backend,interp", BACKENDS)
def test_phase_gradient(backend, interp):
    r = cs.phase_gradient(32, 6, 48, backend, interpret=interp)
    assert r["ok"] and r["vjp_backend"] == backend, r


@pytest.mark.parametrize("backend,interp", BACKENDS)
def test_phase_sharded(backend, interp):
    import jax

    from mini_nbody_tpu.parallel import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices (the virtual CPU mesh)")
    r = cs.phase_sharded(128, 32, make_mesh(4), make_mesh((2, 2)),
                         backend=backend, interpret=interp)
    assert r["ok"], r
    assert {"all_gather", "ring", "ring_sym", "grid", "ring_grad"} <= set(r)


def test_report_counts_a_raising_phase_as_failed(capsys):
    results = {}

    def boom():
        raise RuntimeError("phase blew up")

    cs._report("x", boom, results)
    assert results["x"]["ok"] is False
    assert "FAIL" in capsys.readouterr().out


def test_refuses_without_gpu(tmp_path):
    # On the CPU it exits non-zero and prints no result line.
    repo = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, str(repo / "chip_smoke.py")],
                         cwd=repo, capture_output=True, text=True,
                         timeout=120,
                         env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
