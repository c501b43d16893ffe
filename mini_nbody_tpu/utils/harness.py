"""Timing + throughput harness.

Replacement for the reference's profiling system — a hardware kilocycle
counter published to the host in control-word bits 63:32 at completion
(``src/top_level.vhd:95-96,121-146,255-263``), from which the host derives
interactions/s. Here: wall-clock around work that ends in
``jax.block_until_ready``, GInteractions/s, and the share of the device's
published fp32 peak (BASELINE.json's metric) on a device in CHIP_PEAKS.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable

import jax
import numpy as np

#: Conventional flops-per-interaction accounting used by the CUDA nbody
#: samples (GPU Gems 3 ch. 31) and BASELINE.json: 20 flops per body-body
#: interaction.
FLOPS_PER_INTERACTION = 20.0

#: Published peaks, keyed by the exact ``device_kind`` JAX reports. Source:
#: NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates without
#: sparsity, at the full 700 W power limit. The force kernels use no tensor
#: cores, so "fp32" (outside the tensor cores) is the roofline of the force;
#: the others are kept for context.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32": 67e12,
        "bf16_dense": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet (SXM5)",
    },
}


def chip_peaks(device=None) -> dict:
    """Published peaks of ``device`` (default: the first JAX device).
    A device that is not in CHIP_PEAKS is an error, not a default."""
    device = device or jax.devices()[0]
    try:
        return CHIP_PEAKS[device.device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device.device_kind!r} "
            f"(platform {device.platform!r}); add a row to "
            "utils.harness.CHIP_PEAKS with its source") from None


def time_fn(fn: Callable, *args, reps: int = 3, warmup: int = 1) -> float:
    """Median wall-clock seconds per call of fn(*args), compile excluded.
    Every call is waited for with jax.block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def time_step_fn(step: Callable, carry, reps: int = 3,
                 inner: int = 1) -> float:
    """Seconds per step of `step((state, acc)) -> (state, acc)`, measured as
    a jitted lax.scan of `inner` steps per timed call."""

    @jax.jit
    def multi(c):
        return jax.lax.scan(lambda c2, _: (step(c2), None), c, None,
                            length=inner)[0]

    return time_fn(multi, carry, reps=reps, warmup=1) / inner


@dataclass
class Throughput:
    n: int
    steps: int
    seconds: float
    n_devices: int = 1

    @property
    def interactions(self) -> float:
        return float(self.n) ** 2 * self.steps

    @property
    def ginteractions_per_s(self) -> float:
        return self.interactions / self.seconds / 1e9

    @property
    def ginteractions_per_s_per_device(self) -> float:
        return self.ginteractions_per_s / self.n_devices

    @property
    def gflops(self) -> float:
        return self.interactions * FLOPS_PER_INTERACTION / self.seconds / 1e9

    def roofline_fraction(self, device=None) -> float:
        """Share of one device's published fp32 peak at 20 flops per
        interaction (the force is fp32 arithmetic with no matrix product)."""
        per_dev = self.gflops * 1e9 / self.n_devices
        return per_dev / chip_peaks(device)["fp32"]

    def report(self) -> dict:
        """Report row; the roofline share only where the device has
        published peaks (a CPU run reports none)."""
        row = {
            "n": self.n,
            "steps": self.steps,
            "seconds": self.seconds,
            "ginteractions_per_s": _sig(self.ginteractions_per_s),
            "per_device": _sig(self.ginteractions_per_s_per_device),
            "gflops_20c": _sig(self.gflops),
        }
        if jax.devices()[0].platform != "cpu":
            row["fp32_peak_frac"] = _sig(self.roofline_fraction())
        return row


def _sig(x: float, figs: int = 6) -> float:
    """Round to significant figures, not fixed decimals: a tiny-but-real
    rate (interpret mode at n=64) must not report as exactly 0.0."""
    if x == 0 or not math.isfinite(x):
        return x
    return round(x, max(0, figs - 1 - math.floor(math.log10(abs(x)))))
