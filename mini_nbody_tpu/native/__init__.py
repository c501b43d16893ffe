from mini_nbody_tpu.native.oracle import (
    available,
    body_force_oracle,
    euler_steps_oracle,
    numpy_body_force,
    numpy_euler_steps,
    potential_energy_oracle,
)

__all__ = [
    "available",
    "body_force_oracle",
    "euler_steps_oracle",
    "numpy_body_force",
    "numpy_euler_steps",
    "potential_energy_oracle",
]
