// Native CPU runtime for the Grad-Shafranov elliptic lane.
//
// This is the framework's C++ "host runtime" twin of the XLA SOR sweep:
// the reference ships a C++ OpenMP red-black SOR solver behind a C ABI
// (reference: src/scpn_fusion/hpc/solver.cpp:93-128, types.h, bridged by
// hpc/hpc_bridge.py:89-456).  We keep the same role — a host-side
// accelerator for environments without a GPU and a parity fixture for the
// device sweep — but the design is our own:
//
//  * an opaque arena-style handle owning all solver buffers (one malloc per
//    create, no per-step allocation),
//  * toroidal 1/R five-point stencil with per-column precomputed
//    coefficients,
//  * two-phase checkerboard (red/black) Gauss-Seidel with over-relaxation,
//    matching the semantics of the framework's NumPy twin
//    (scpn_fusion_tpu/utils/npref.py:sor_step_np) so convergence
//    trajectories are comparable,
//  * a converged-run entry with a chunked mean-|dpsi| stopping rule and a
//    divergence cap, and
//  * an L2 GS-residual diagnostic.
//
// C ABI only — bound from Python via ctypes (scpn_fusion_tpu/native/runtime.py).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct GsArena {
    int64_t nz = 0;
    int64_t nr = 0;
    double d_r = 0.0;
    double d_z = 0.0;
    // Flat buffers, row-major (z, r).
    double* psi = nullptr;
    double* source = nullptr;
    double* scratch = nullptr;  // previous-psi copy for delta diagnostics
    // Per-column stencil coefficients (interior columns 1..nr-2 are used;
    // arrays are full-width for simple indexing).
    double* a_e = nullptr;
    double* a_w = nullptr;
    double inv_dz2 = 0.0;
    double a_c = 0.0;
    double* block = nullptr;    // single allocation backing all buffers
};

inline double clamp_mag(double v, double cap) {
    if (v > cap) return cap;
    if (v < -cap) return -cap;
    if (std::isnan(v)) return 0.0;
    return v;
}

// Magnitude cap mirroring the framework's numeric sanitizer policy
// (reference clips sweep outputs to a large finite cap,
// fusion_kernel_iterative_solver.py:90-94).
constexpr double kPsiCap = 1e12;

}  // namespace

extern "C" {

// Create a solver arena. r_1d has nr entries (major-radius of each column).
// Returns nullptr on bad sizes or allocation failure.
void* sfc_gs_create(int64_t nz, int64_t nr, const double* r_1d,
                    double d_r, double d_z) {
    if (nz < 3 || nr < 3 || r_1d == nullptr || d_r <= 0.0 || d_z <= 0.0) {
        return nullptr;
    }
    auto* a = new (std::nothrow) GsArena;
    if (a == nullptr) return nullptr;
    const int64_t n = nz * nr;
    // One block: psi, source, scratch (n each) + a_e, a_w (nr each).
    const int64_t total = 3 * n + 2 * nr;
    a->block = static_cast<double*>(std::calloc(total, sizeof(double)));
    if (a->block == nullptr) {
        delete a;
        return nullptr;
    }
    a->nz = nz;
    a->nr = nr;
    a->d_r = d_r;
    a->d_z = d_z;
    a->psi = a->block;
    a->source = a->block + n;
    a->scratch = a->block + 2 * n;
    a->a_e = a->block + 3 * n;
    a->a_w = a->block + 3 * n + nr;
    const double inv_dr2 = 1.0 / (d_r * d_r);
    a->inv_dz2 = 1.0 / (d_z * d_z);
    a->a_c = 2.0 * inv_dr2 + 2.0 * a->inv_dz2;
    for (int64_t j = 0; j < nr; ++j) {
        const double r = r_1d[j] > 1e-10 ? r_1d[j] : 1e-10;
        a->a_e[j] = inv_dr2 - 1.0 / (2.0 * r * d_r);
        a->a_w[j] = inv_dr2 + 1.0 / (2.0 * r * d_r);
    }
    return a;
}

void sfc_gs_destroy(void* handle) {
    if (handle == nullptr) return;
    auto* a = static_cast<GsArena*>(handle);
    std::free(a->block);
    delete a;
}

void sfc_gs_set_state(void* handle, const double* psi, const double* source) {
    auto* a = static_cast<GsArena*>(handle);
    const int64_t n = a->nz * a->nr;
    if (psi != nullptr) std::memcpy(a->psi, psi, n * sizeof(double));
    if (source != nullptr) std::memcpy(a->source, source, n * sizeof(double));
}

void sfc_gs_get_psi(const void* handle, double* out) {
    const auto* a = static_cast<const GsArena*>(handle);
    std::memcpy(out, a->psi, a->nz * a->nr * sizeof(double));
}

// Impose Dirichlet values on the four edges from a full-grid array (only the
// edge entries of `boundary` are read).
void sfc_gs_set_boundary(void* handle, const double* boundary) {
    auto* a = static_cast<GsArena*>(handle);
    const int64_t nz = a->nz, nr = a->nr;
    for (int64_t j = 0; j < nr; ++j) {
        a->psi[j] = boundary[j];
        a->psi[(nz - 1) * nr + j] = boundary[(nz - 1) * nr + j];
    }
    for (int64_t i = 0; i < nz; ++i) {
        a->psi[i * nr] = boundary[i * nr];
        a->psi[i * nr + nr - 1] = boundary[i * nr + nr - 1];
    }
}

// n_sweeps red-black SOR sweeps (each sweep = red phase then black phase,
// the black phase seeing updated red values).
void sfc_gs_sor_sweeps(void* handle, int64_t n_sweeps, double omega) {
    auto* a = static_cast<GsArena*>(handle);
    const int64_t nz = a->nz, nr = a->nr;
    const double inv_ac = 1.0 / a->a_c;
    const double one_m_w = 1.0 - omega;
    for (int64_t s = 0; s < n_sweeps; ++s) {
        for (int parity = 0; parity < 2; ++parity) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
            for (int64_t i = 1; i < nz - 1; ++i) {
                double* row = a->psi + i * nr;
                const double* up = row - nr;
                const double* dn = row + nr;
                const double* src = a->source + i * nr;
                // Columns of this parity on row i: (i + j) % 2 == parity.
                int64_t j0 = 1 + ((i + 1 + parity) & 1);
                for (int64_t j = j0; j < nr - 1; j += 2) {
                    const double gs =
                        (a->a_e[j] * row[j + 1] + a->a_w[j] * row[j - 1] +
                         a->inv_dz2 * (up[j] + dn[j]) - src[j]) * inv_ac;
                    row[j] = clamp_mag(one_m_w * row[j] + omega * gs, kPsiCap);
                }
            }
        }
    }
}

// RMS of the GS residual  L psi - source  over interior points.
double sfc_gs_residual_rms(const void* handle) {
    const auto* a = static_cast<const GsArena*>(handle);
    const int64_t nz = a->nz, nr = a->nr;
    double acc = 0.0;
#if defined(_OPENMP)
#pragma omp parallel for reduction(+ : acc) schedule(static)
#endif
    for (int64_t i = 1; i < nz - 1; ++i) {
        const double* row = a->psi + i * nr;
        const double* up = row - nr;
        const double* dn = row + nr;
        const double* src = a->source + i * nr;
        for (int64_t j = 1; j < nr - 1; ++j) {
            const double r = a->a_e[j] * row[j + 1] + a->a_w[j] * row[j - 1] +
                             a->inv_dz2 * (up[j] + dn[j]) - a->a_c * row[j] -
                             src[j];
            acc += r * r;
        }
    }
    const double cnt = static_cast<double>((nz - 2) * (nr - 2));
    return std::sqrt(acc / (cnt > 0.0 ? cnt : 1.0));
}

// Run sweeps in chunks until mean |dpsi per sweep| < tol or the budget is
// exhausted.  Returns sweeps executed (negative on divergence).
int64_t sfc_gs_run_converged(void* handle, int64_t max_sweeps, double tol,
                             double omega, int64_t chunk) {
    auto* a = static_cast<GsArena*>(handle);
    const int64_t n = a->nz * a->nr;
    if (chunk < 1) chunk = 10;
    int64_t done = 0;
    while (done < max_sweeps) {
        const int64_t todo =
            chunk < (max_sweeps - done) ? chunk : (max_sweeps - done);
        std::memcpy(a->scratch, a->psi, n * sizeof(double));
        sfc_gs_sor_sweeps(handle, todo, omega);
        done += todo;
        double acc = 0.0;
        bool finite = true;
        for (int64_t k = 0; k < n; ++k) {
            const double d = a->psi[k] - a->scratch[k];
            if (std::isnan(d)) finite = false;
            acc += std::fabs(d);
        }
        if (!finite) return -done;
        if (acc / (static_cast<double>(n) * static_cast<double>(todo)) < tol) {
            break;
        }
    }
    return done;
}

int sfc_gs_abi_version(void) { return 1; }

}  // extern "C"
