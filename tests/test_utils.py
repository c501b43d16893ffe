"""Utils: config validation, checkpoint roundtrip, shmoo formatting, metrics."""

import jax
import numpy as np
import pytest

from mini_nbody_tpu import SimConfig
from mini_nbody_tpu.models import init
from mini_nbody_tpu.utils import checkpoint as ckpt
from mini_nbody_tpu.utils import shmoo
from mini_nbody_tpu.utils.config import ceil_log2, round_up
from mini_nbody_tpu.utils.harness import Throughput
from mini_nbody_tpu.utils.tracing import StepMetrics


def test_config_validation():
    with pytest.raises(ValueError):
        SimConfig(n=0)
    with pytest.raises(ValueError):
        SimConfig(n=16, backend="cuda")
    with pytest.raises(ValueError):
        SimConfig(n=16, tile_j=100)
    with pytest.raises(ValueError):
        SimConfig(n=16, backend="mxu")  # removed with its kernel
    with pytest.raises(ValueError):
        SimConfig(n=16, integrator="rk9")
    cfg = SimConfig(n=16)
    assert cfg.replace(steps=5).steps == 5
    assert hash(cfg) == hash(SimConfig(n=16))  # usable as jit static arg


def test_helpers():
    assert ceil_log2(1) == 0 and ceil_log2(16) == 4 and ceil_log2(17) == 5
    assert round_up(100, 128) == 128 and round_up(256, 128) == 256


def test_checkpoint_roundtrip(tmp_path):
    state = init.uniform_random(jax.random.key(0), 64)
    cfg = SimConfig(n=64, steps=7)
    path = tmp_path / "ck.npz"
    ckpt.save(path, state, step=42, cfg=cfg)
    s2, step, cfg_dict = ckpt.load(path)
    assert step == 42
    np.testing.assert_array_equal(np.asarray(s2.pos), np.asarray(state.pos))
    np.testing.assert_array_equal(np.asarray(s2.vel), np.asarray(state.vel))
    restored = ckpt.restore_config(cfg_dict)
    assert restored == cfg


def test_checkpoint_suffixless_path_roundtrip(tmp_path):
    # np.savez appends '.npz' when missing; save must report the real file
    # and load must find it from the same suffixless argument (--save ck ...
    # --resume ck used to FileNotFoundError, ADVICE.md round 1).
    state = init.uniform_random(jax.random.key(1), 16)
    path = tmp_path / "ck"
    written = ckpt.save(path, state, step=3)
    assert written.exists() and written.suffix == ".npz"
    s2, step, _ = ckpt.load(path)
    assert step == 3
    np.testing.assert_array_equal(np.asarray(s2.pos), np.asarray(state.pos))


def test_shmoo_rows_and_csv():
    cfg = SimConfig(n=256, backend="jnp")
    rows = shmoo.sweep(cfg, [256, 512], reps=1)
    assert [r["n"] for r in rows] == [256, 512]
    csv_text = shmoo.to_csv(rows)
    assert csv_text.splitlines()[0].startswith("n,backend,")
    assert len(csv_text.splitlines()) == 3
    assert all(r["ginteractions_per_s"] > 0 for r in rows)


def test_throughput_math():
    t = Throughput(n=1000, steps=2, seconds=1.0, n_devices=2)
    assert t.interactions == 2e6
    assert t.ginteractions_per_s_per_device == pytest.approx(1e-3)
    rep = t.report()
    assert set(["n", "seconds", "ginteractions_per_s"]) <= set(rep)
    # a CPU run reports no share of a device peak at all
    assert "fp32_peak_frac" not in rep


def test_throughput_report_tiny_rate_significant_figures():
    # n=64 in interpret mode can land below 5e-4 GInter/s; report() must
    # keep significant figures rather than rounding a real rate to 0.0.
    t = Throughput(n=64, steps=1, seconds=10.0)
    rep = t.report()
    assert rep["ginteractions_per_s"] == pytest.approx(4.096e-7)
    # Normal-magnitude rates keep their familiar precision.
    big = Throughput(n=1_000_000, steps=1, seconds=1e12 / 413.7e9)
    assert big.report()["ginteractions_per_s"] == pytest.approx(413.7, abs=1e-3)


def test_step_metrics():
    m = StepMetrics(n=1000).start()
    row = m.tick(10, energy=-1.0)
    assert row["step"] == 10 and row["energy"] == -1.0
    m.tick(5)
    assert "\n" in m.jsonl()


def test_multihost_noop_without_env(monkeypatch):
    from mini_nbody_tpu.parallel import multihost

    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert multihost.is_primary()
    assert multihost.global_mesh().devices.size >= 1


def test_check_finite_guard():
    import jax.numpy as jnp
    from mini_nbody_tpu.models.state import BodyState
    from mini_nbody_tpu.ops.diagnostics import assert_finite, check_finite

    s = init.uniform_random(jax.random.key(0), 16)
    assert all(bool(v) for v in check_finite(s).values())
    bad = BodyState(pos=s.pos.at[0, 0].set(jnp.nan), vel=s.vel, mass=s.mass)
    with pytest.raises(FloatingPointError):
        assert_finite(bad, "test")


def test_profile_trace_and_annotate(tmp_path):
    # Smoke: the wrappers must actually produce a trace dir and not break
    # the wrapped computation.
    import jax.numpy as jnp
    from mini_nbody_tpu.utils.tracing import annotate, profile_trace

    logdir = tmp_path / "trace"
    with profile_trace(str(logdir)):
        with annotate("force"):
            out = jnp.sum(jnp.arange(16.0) ** 2)
    assert float(out) == 1240.0
    produced = list(logdir.rglob("*"))
    assert produced, "profiler produced no trace files"


class TestMultihostInitialize:
    """Arg/env precedence of parallel.multihost.initialize with the actual
    jax.distributed.initialize monkeypatched out."""

    def _patch(self, monkeypatch):
        calls = []
        import jax as _jax

        monkeypatch.setattr(_jax.distributed, "initialize",
                            lambda **kw: calls.append(kw))
        return calls

    def test_noop_without_config(self, monkeypatch):
        from mini_nbody_tpu.parallel import multihost

        calls = self._patch(monkeypatch)
        for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                    "JAX_PROCESS_ID"):
            monkeypatch.delenv(var, raising=False)
        assert multihost.initialize() is False
        assert calls == []

    def test_env_vars_picked_up(self, monkeypatch):
        from mini_nbody_tpu.parallel import multihost

        calls = self._patch(monkeypatch)
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
        monkeypatch.setenv("JAX_PROCESS_ID", "2")
        assert multihost.initialize() is True
        assert calls == [dict(coordinator_address="10.0.0.1:1234",
                              num_processes=4, process_id=2)]

    def test_args_override_env(self, monkeypatch):
        from mini_nbody_tpu.parallel import multihost

        calls = self._patch(monkeypatch)
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
        monkeypatch.setenv("JAX_PROCESS_ID", "2")
        assert multihost.initialize("10.9.9.9:999", 8, 7) is True
        assert calls == [dict(coordinator_address="10.9.9.9:999",
                              num_processes=8, process_id=7)]

    def test_num_processes_alone_triggers_init(self, monkeypatch):
        from mini_nbody_tpu.parallel import multihost

        calls = self._patch(monkeypatch)
        for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                    "JAX_PROCESS_ID"):
            monkeypatch.delenv(var, raising=False)
        assert multihost.initialize(num_processes=2, process_id=0) is True
        assert calls == [dict(coordinator_address=None,
                              num_processes=2, process_id=0)]


def test_orbax_checkpoint_roundtrip(tmp_path):
    state = init.uniform_random(jax.random.key(7), 64)
    cfg = SimConfig(n=64, steps=3)
    path = ckpt.save_orbax(tmp_path / "ock", state, step=9, cfg=cfg)
    s2, step, cfg_dict = ckpt.load_orbax(path)
    assert step == 9
    np.testing.assert_array_equal(np.asarray(s2.pos), np.asarray(state.pos))
    np.testing.assert_array_equal(np.asarray(s2.vel), np.asarray(state.vel))
    assert ckpt.restore_config(cfg_dict) == cfg


def test_orbax_checkpoint_sharded_restore(tmp_path):
    # restore directly onto the mesh: no host gather (unlike npz)
    if len(jax.devices()) < 8:
        import pytest as _pytest
        _pytest.skip("needs 8 devices")
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mini_nbody_tpu.parallel import make_mesh

    mesh = make_mesh(8)
    state = init.uniform_random(jax.random.key(8), 128)
    path = ckpt.save_orbax(tmp_path / "ock2", state, step=1)
    shardings = {
        "pos": NamedSharding(mesh, P("i", None)),
        "vel": NamedSharding(mesh, P("i", None)),
        "mass": NamedSharding(mesh, P("i")),
    }
    s2, step, _ = ckpt.load_orbax(path, sharding=shardings)
    assert step == 1
    assert s2.pos.sharding.spec == P("i", None)
    np.testing.assert_array_equal(np.asarray(s2.pos), np.asarray(state.pos))


def test_chip_peaks_h100_row():
    from mini_nbody_tpu.utils.harness import CHIP_PEAKS, chip_peaks

    class Dev:
        device_kind = "NVIDIA H100 80GB HBM3"
        platform = "gpu"

    peaks = chip_peaks(Dev())
    assert peaks is CHIP_PEAKS["NVIDIA H100 80GB HBM3"]
    assert peaks["fp32"] == 67e12 and peaks["bf16_dense"] == 989e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12 and "data sheet" in peaks[
        "source"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H200"])
def test_chip_peaks_unknown_device_raises(kind):
    from mini_nbody_tpu.utils.harness import chip_peaks

    class Dev:
        device_kind = kind
        platform = "gpu"

    with pytest.raises(ValueError, match="no published peaks"):
        chip_peaks(Dev())


def test_roofline_fraction_against_h100_peak():
    class Dev:
        device_kind = "NVIDIA H100 80GB HBM3"
        platform = "gpu"

    # 1000 G interactions/s x 20 flops = 20 TFLOP/s of the 67 TFLOP/s peak
    t = Throughput(n=1_000_000, steps=1, seconds=1e12 / 1e12)
    assert t.roofline_fraction(Dev()) == pytest.approx(20e12 / 67e12)


def test_time_fn_waits_for_results():
    from mini_nbody_tpu.utils.harness import time_fn, time_step_fn
    import jax.numpy as jnp

    calls = []

    def fn(x):
        calls.append(1)
        return x * 2.0

    sec = time_fn(fn, jnp.ones(4), reps=3, warmup=2)
    assert sec >= 0 and len(calls) == 5
    s = init.uniform_random(jax.random.key(0), 16)
    from mini_nbody_tpu.sim import init_carry, make_step_fn

    cfg = SimConfig(n=16, backend="jnp")
    assert time_step_fn(make_step_fn(cfg), init_carry(cfg, s), reps=1,
                        inner=3) > 0


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    from mini_nbody_tpu.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.setup_compile_cache() == str(tmp_path)


def test_compile_cache_default_in_checkout(monkeypatch):
    from pathlib import Path

    from mini_nbody_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        got = cache.setup_compile_cache()
        repo = Path(__file__).resolve().parents[1]
        assert Path(got) == repo / ".jax_cache"
        assert jax.config.jax_compilation_cache_dir == got
        ignored = (repo / ".gitignore").read_text().split()
        assert ".jax_cache/" in ignored
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_restore_config_drops_removed_options():
    cfg = ckpt.restore_config({"n": 32, "steps": 3, "backend": "jnp",
                               "sym_tile": 512, "resident": None,
                               "mesh_shape": [8]})
    assert cfg == SimConfig(n=32, steps=3, backend="jnp", mesh_shape=(8,))


@pytest.mark.parametrize("field,value", [("tile_i", 48), ("tile_j", 0),
                                         ("comm", "torus"),
                                         ("mesh_shape", (2, 4))])
def test_config_rejects(field, value):
    with pytest.raises(ValueError):
        SimConfig(n=16, **{field: value})


@pytest.mark.parametrize("tiles", [(16, 16), (32, 64), (128, 32), (None, 64)])
def test_config_accepts_power_of_two_blocks(tiles):
    cfg = SimConfig(n=16, tile_i=tiles[0], tile_j=tiles[1])
    assert (cfg.tile_i, cfg.tile_j) == tiles
