// fp64 reference oracle for the softened all-pairs bodyForce, in C++/OpenMP.
//
// Role: the golden model the reference hardware never had (its testbenches
// are value-blind — sim/tb_dxy.vhd:899-923). The device kernels are validated
// against this at sizes where a NumPy fp64 oracle is impractically slow
// (O(N^2) in Python-managed memory).
//
// Physics exactly mirrors the reference datapath (and the device kernels):
//   d = p_j - p_i;  r2 = |d|^2 + softening;  w = r2^-1.5 * m_j;  F_i += d*w
// Self-interaction computed, not skipped (d = 0 => contribution 0), matching
// src/fxyz.vhd:120-127 / SURVEY.md §0.
//
// Build: make native   (g++ -O3 -fopenmp -shared; loaded via ctypes).

#include <cmath>
#include <cstdint>

extern "C" {

// Forces on pos_i (ni x 3, row-major float32) from sources pos_j (nj x 3)
// with masses mass_j (nj, may be null => unit masses). Accumulation and
// output in float64.
void body_force_f64(const float* pos_i, const float* pos_j,
                    const float* mass_j, double softening,
                    int64_t ni, int64_t nj, double* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < ni; ++i) {
    const double xi = pos_i[3 * i + 0];
    const double yi = pos_i[3 * i + 1];
    const double zi = pos_i[3 * i + 2];
    double fx = 0.0, fy = 0.0, fz = 0.0;
    for (int64_t j = 0; j < nj; ++j) {
      const double dx = pos_j[3 * j + 0] - xi;
      const double dy = pos_j[3 * j + 1] - yi;
      const double dz = pos_j[3 * j + 2] - zi;
      const double r2 = dx * dx + dy * dy + dz * dz + softening;
      const double inv = 1.0 / std::sqrt(r2);
      double w = inv * inv * inv;
      if (mass_j != nullptr) w *= mass_j[j];
      fx += dx * w;
      fy += dy * w;
      fz += dz * w;
    }
    out[3 * i + 0] = fx;
    out[3 * i + 1] = fy;
    out[3 * i + 2] = fz;
  }
}

// Total softened potential energy: U = -sum_{i<j} m_i m_j / sqrt(r2 + eps).
double potential_energy_f64(const float* pos, const float* mass,
                            double softening, int64_t n) {
  double total = 0.0;
#pragma omp parallel for reduction(+ : total) schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double xi = pos[3 * i + 0];
    const double yi = pos[3 * i + 1];
    const double zi = pos[3 * i + 2];
    const double mi = mass ? mass[i] : 1.0;
    double acc = 0.0;
    for (int64_t j = i + 1; j < n; ++j) {
      const double dx = pos[3 * j + 0] - xi;
      const double dy = pos[3 * j + 1] - yi;
      const double dz = pos[3 * j + 2] - zi;
      const double r2 = dx * dx + dy * dy + dz * dz + softening;
      const double mj = mass ? mass[j] : 1.0;
      acc += mi * mj / std::sqrt(r2);
    }
    total += acc;
  }
  return -total;
}

// One semi-implicit Euler reference step in fp64 (upstream mini-nbody
// semantics: v += dt*F; x += dt*v), for trajectory-level validation.
void euler_steps_f64(float* pos, float* vel, const float* mass,
                     double softening, double dt, int64_t n, int64_t steps,
                     double* scratch_forces) {
  for (int64_t s = 0; s < steps; ++s) {
    body_force_f64(pos, pos, mass, softening, n, n, scratch_forces);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      vel[3 * i + 0] += static_cast<float>(dt * scratch_forces[3 * i + 0]);
      vel[3 * i + 1] += static_cast<float>(dt * scratch_forces[3 * i + 1]);
      vel[3 * i + 2] += static_cast<float>(dt * scratch_forces[3 * i + 2]);
      pos[3 * i + 0] += static_cast<float>(dt * vel[3 * i + 0]);
      pos[3 * i + 1] += static_cast<float>(dt * vel[3 * i + 1]);
      pos[3 * i + 2] += static_cast<float>(dt * vel[3 * i + 2]);
    }
  }
}

}  // extern "C"
