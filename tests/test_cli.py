"""CLI surface smoke tests (in-process, jnp backend, CPU)."""

import json

import pytest

from mini_nbody_tpu import cli


def _run(capsys, argv):
    cli.main(argv)
    return capsys.readouterr().out.strip()


def test_run_save_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    out = _run(capsys, ["run", "--n", "128", "--steps", "3", "--backend", "jnp",
                        "--save", ck, "--energy"])
    rep = json.loads(out)
    assert rep["steps"] == 3 and rep["checkpoint"] == ck and "energy" in rep
    out = _run(capsys, ["run", "--n", "128", "--steps", "2", "--backend", "jnp",
                        "--resume", ck])
    assert json.loads(out)["n"] == 128


def test_check_gate_passes(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["check", "--n", "256", "--steps", "2", "--backend", "jnp"])
    assert e.value.code == 0
    rep = json.loads(capsys.readouterr().out.strip())
    assert rep["ok"] and rep["force_max_rel_err"] < 1e-4


def test_shmoo_jsonl(capsys):
    out = _run(capsys, ["shmoo", "--sizes", "128,256", "--backend", "jnp",
                        "--reps", "1", "--format", "jsonl"])
    rows = [json.loads(l) for l in out.splitlines()]
    assert [r["n"] for r in rows] == [128, 256]


def test_bench_reports(capsys):
    out = _run(capsys, ["bench", "--n", "256", "--backend", "jnp", "--reps", "1"])
    rep = json.loads(out)
    assert rep["backend"] == "jnp" and rep["ginteractions_per_s"] > 0
    # the row names its device; a CPU row carries no device-peak share
    assert rep["platform"] == "cpu" and "fp32_peak_frac" not in rep


def test_run_periodic_checkpointing(tmp_path, capsys):
    ck = str(tmp_path / "periodic.npz")
    out = _run(capsys, ["run", "--n", "64", "--steps", "6", "--backend", "jnp",
                        "--save", ck, "--save-every", "2"])
    rep = json.loads(out)
    assert rep["checkpoint"] == ck
    from mini_nbody_tpu.utils import checkpoint as ckpt

    _, step, _ = ckpt.load(ck)
    assert step == 6


@pytest.mark.parametrize("init", ["uniform", "plummer"])
def test_check_gate_reports_resolved_backend(init, capsys):
    # check runs the configured force against the fp64 oracle and reports
    # the backend it resolved ('auto' -> jnp on the CPU).
    with pytest.raises(SystemExit) as e:
        cli.main(["check", "--n", "128", "--steps", "2", "--softening",
                  "1e-2", "--init", init, "--integrator", "leapfrog"])
    assert e.value.code == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["ok"] is True and rep["backend"] == "jnp"
    assert rep["energy_drift"] < 1e-4


def test_pallas_backend_off_gpu_is_an_error():
    # an explicit --backend pallas on the CPU must not fall back to the
    # interpreter (or to jnp) silently
    with pytest.raises(ValueError, match="CUDA GPU"):
        cli.main(["run", "--n", "64", "--steps", "1", "--backend",
                  "pallas"])


def test_reference_envelope_example_quick():
    """The reference-envelope demo (examples/reference_envelope.py) runs
    end-to-end in --quick mode: config-1-scale Euler sweep + the drift
    assertion at the (shrunken) envelope edge."""
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "examples" / \
        "reference_envelope.py"
    out = subprocess.run(
        [sys.executable, str(script), "--quick", "--cpu"],
        capture_output=True, text=True, timeout=420)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "leapfrog drift" in out.stdout


def test_run_trajectory_dump(tmp_path):
    """run --trajectory writes stacked snapshots, single-chip and sharded."""
    import jax
    import numpy as np

    from mini_nbody_tpu.cli import main

    path = tmp_path / "traj.npz"
    main(["run", "--n", "64", "--steps", "6", "--dt", "1e-3",
          "--softening", "1e-2", "--backend", "jnp",
          "--trajectory", str(path), "--save-every", "2"])
    d = np.load(path)
    assert d["pos_history"].shape == (3, 64, 3)
    assert int(d["save_every"]) == 2
    assert np.isfinite(d["pos_history"]).all()

    if len(jax.devices()) >= 8:
        path2 = tmp_path / "traj8.npz"
        main(["run", "--n", "64", "--steps", "6", "--dt", "1e-3",
              "--softening", "1e-2", "--backend", "jnp", "--devices", "8",
              "--comm", "ring", "--trajectory", str(path2),
              "--save-every", "3"])
        d2 = np.load(path2)
        assert d2["pos_history"].shape == (2, 64, 3)


def test_run_ensemble(capsys):
    out = _run(capsys, ["run", "--n", "96", "--steps", "2", "--backend",
                        "jnp", "--ensemble", "3", "--init", "plummer"])
    rep = json.loads(out.strip().splitlines()[-1])
    assert rep["ensemble"] == 3 and rep["n"] == 96
    # per-system momentum is conserved by Newton's 3rd law (plummer init
    # starts near zero total momentum)
    assert rep["momentum_max_abs"] < 1e-3


def test_run_ensemble_trajectory_dump(tmp_path, capsys):
    import numpy as np

    path = tmp_path / "ens_traj.npz"
    out = _run(capsys, ["run", "--n", "96", "--steps", "4", "--backend",
                        "jnp", "--ensemble", "2", "--init", "plummer",
                        "--trajectory", str(path), "--save-every", "2"])
    rep = json.loads(out.strip().splitlines()[-1])
    assert rep["ensemble"] == 2
    d = np.load(path)
    assert d["pos_history"].shape == (2, 2, 96, 3)  # (S, B, N, 3)
    assert int(d["save_every"]) == 2
    assert np.isfinite(d["pos_history"]).all()


def test_run_ensemble_rejects_resume_and_save(tmp_path):
    with pytest.raises(SystemExit, match="resume"):
        cli.main(["run", "--n", "64", "--ensemble", "2",
                  "--resume", str(tmp_path / "x.npz")])
    with pytest.raises(SystemExit, match="save"):
        cli.main(["run", "--n", "64", "--ensemble", "2",
                  "--save", str(tmp_path / "y.npz")])
