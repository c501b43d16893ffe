"""Time integrators.

The reference hardware computes forces only; integration lives on the ARM host
(SURVEY.md §0 — "the host owns state, integration, iteration"). Upstream
mini-nbody's integrator is semi-implicit Euler:

    v += dt * F(x);  x += dt * v        (velocity first, then position)

We provide that (reference fidelity) plus leapfrog/KDK (symplectic, the right
choice for the energy-drift gate in BASELINE.json). Both are pure functions
``(state, acc) -> (state, acc)`` carrying the acceleration so leapfrog costs
one force evaluation per step.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax.numpy as jnp

from mini_nbody_tpu.models.state import BodyState

ForceFn = Callable[..., jnp.ndarray]  # (pos_i, pos_j, mass_j) -> (Ni, 3)


def euler_step(state: BodyState, acc, force_fn: ForceFn, dt: float):
    """Semi-implicit Euler, mini-nbody semantics (v then x). `acc` is ignored
    on input (recomputed each step) but returned for a uniform interface."""
    f = force_fn(state.pos, state.pos, state.mass)
    vel = state.vel + dt * f
    pos = state.pos + dt * vel
    return BodyState(pos=pos, vel=vel, mass=state.mass), f


def leapfrog_step(state: BodyState, acc, force_fn: ForceFn, dt: float):
    """Kick-drift-kick leapfrog; `acc` must be F(state.pos) from the previous
    step (or an initial evaluation). One force evaluation per step."""
    half = 0.5 * dt
    vel_h = state.vel + half * acc
    pos = state.pos + dt * vel_h
    acc_new = force_fn(pos, pos, state.mass)
    vel = vel_h + half * acc_new
    return BodyState(pos=pos, vel=vel, mass=state.mass), acc_new


def rk4_step(state: BodyState, acc, force_fn: ForceFn, dt: float):
    """Classic 4th-order Runge-Kutta on the (x, v) system — four force
    evaluations per step for O(dt^4) local accuracy. Not symplectic (its
    energy error drifts secularly over very long runs, where leapfrog's
    oscillates boundedly), but far more accurate per step at moderate
    horizons — the high-accuracy family the reference host could never
    afford (its hardware budget was one force pass per step). `acc` is
    ignored on input and returned as F(x0) for a uniform interface."""

    def a(x):
        return force_fn(x, x, state.mass)

    x0, v0 = state.pos, state.vel
    k1v = a(x0)
    k1x = v0
    k2v = a(x0 + (0.5 * dt) * k1x)
    k2x = v0 + (0.5 * dt) * k1v
    k3v = a(x0 + (0.5 * dt) * k2x)
    k3x = v0 + (0.5 * dt) * k2v
    k4v = a(x0 + dt * k3x)
    k4x = v0 + dt * k3v
    sixth = dt / 6.0
    pos = x0 + sixth * (k1x + 2.0 * k2x + 2.0 * k3x + k4x)
    vel = v0 + sixth * (k1v + 2.0 * k2v + 2.0 * k3v + k4v)
    return BodyState(pos=pos, vel=vel, mass=state.mass), k1v


#: Yoshida (1990) 4th-order symplectic composition coefficients: three
#: leapfrog substeps scaled by (w1, w0, w1) with w1 = 1/(2 - 2^(1/3)),
#: w0 = 1 - 2*w1 (= -2^(1/3) * w1). The negative middle substep is what
#: buys O(dt^4) while staying symplectic.
_Y4_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_Y4_W0 = 1.0 - 2.0 * _Y4_W1


def yoshida4_step(state: BodyState, acc, force_fn: ForceFn, dt: float):
    """4th-order SYMPLECTIC integrator (Yoshida composition of three
    leapfrog substeps, H. Yoshida, Phys. Lett. A 150, 1990). Three force
    evaluations per step; like leapfrog its energy error oscillates
    boundedly instead of drifting secularly (rk4_step docstring), but at
    O(dt^4) — the long-horizon high-accuracy choice. `acc` must be
    F(state.pos) from the previous step (same carry contract as
    leapfrog_step: the composition's first half-kick reuses it, and the
    returned acc is F(pos_final) for the next step)."""
    s, a = state, acc
    for w in (_Y4_W1, _Y4_W0, _Y4_W1):
        s, a = leapfrog_step(s, a, force_fn, w * dt)
    return s, a


INTEGRATORS = {"euler": euler_step, "leapfrog": leapfrog_step,
               "rk4": rk4_step, "yoshida4": yoshida4_step}

#: Integrators whose acc carry is the previous step's final force.
CARRIES_ACC = ("leapfrog", "yoshida4")


def initial_acc(state: BodyState, force_fn: ForceFn, integrator: str):
    """Acceleration carry needed before the first step (leapfrog-family
    integrators reuse the previous step's final force)."""
    if integrator in CARRIES_ACC:
        return force_fn(state.pos, state.pos, state.mass)
    return jnp.zeros_like(state.pos)
