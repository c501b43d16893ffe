"""Test configuration.

By default every test runs on the CPU, on a virtual 8-device mesh
(``--xla_force_host_platform_device_count=8``, SURVEY.md §4), with x64
enabled for the fp64 oracles (the ops cast to fp32 themselves); Pallas
kernels run there only in interpret mode, which the tests request
explicitly.

Tests marked ``gpu`` run the compiled kernels on a CUDA card. Run them on a
machine with one by passing ``--gpu``, which keeps JAX's default platform:

    python -m pytest tests/ -m gpu --gpu

Whether a card is present is decided inside the ``gpu`` fixture, never
while a module is imported, so every worker collects the same tests.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption("--gpu", action="store_true", default=False,
                     help="keep JAX's default platform so tests marked "
                          "'gpu' run on the card")


def pytest_configure(config):
    if not config.getoption("--gpu"):
        # Force the CPU regardless of the inherited env: jax is often
        # imported by plugins before this runs, so set the config var,
        # which wins as long as no backend has been initialized yet.
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a CUDA GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU: run `python -m pytest tests/ -m gpu "
                    "--gpu` on a machine with one")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def oracle_force(pos, mass=None, softening=1e-9):
    """fp64 NumPy all-pairs softened gravity — the golden model the reference
    never had (its testbenches are value-blind, sim/tb_dxy.vhd:899-923)."""
    return oracle_force_rect(pos, pos, mass, softening)


def oracle_force_rect(pos_i, pos_j, mass_j=None, softening=1e-9):
    pos_i = np.asarray(pos_i, np.float64)
    pos_j = np.asarray(pos_j, np.float64)
    mass_j = (
        np.ones(pos_j.shape[0]) if mass_j is None else np.asarray(mass_j, np.float64)
    )
    d = pos_j[None, :, :] - pos_i[:, None, :]
    r2 = (d * d).sum(-1) + softening
    w = r2 ** -1.5 * mass_j[None, :]
    return (d * w[:, :, None]).sum(1)


@pytest.fixture
def oracle():
    return oracle_force


@pytest.fixture
def oracle_rect():
    return oracle_force_rect
