"""Charge-state-resolved impurity transport (ionisation ladder + radiation).

JAX-native equivalent of the reference's impurity stack
(``core/impurity_transport*.py``, ~2.5k LoC incl. the Aurora-parity lane):
the charge-state ladder

    dn_z/dt = S_{z-1} n_{z-1} - (S_z + R_z) n_z + R_{z+1} n_{z+1}
              + (1/r) d/dr (r D dn_z/dr)

with ionisation S_z(T_e) and recombination R_z(T_e) rate coefficients
(ADAS-shaped analytic fits), solved as one vectorised matrix exponential-free
implicit-in-rates / CN-in-space step — ALL charge states advance together as
a (Z+1, nr) tensor, replacing the reference's per-state loops.  The coronal
equilibrium (S_z n_z = R_{z+1} n_{z+1}) is available in closed form for
validation, and line radiation uses the cooling-rate closure.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.core.dtypes import canonical, default_float

from scpn_fusion_tpu.models.transport.solver import (
    build_cn_tridiag,
    explicit_diffusion_rhs,
)
from scpn_fusion_tpu.ops.tridiag import thomas_solve_batched


@dataclasses.dataclass(frozen=True)
class ImpuritySpecies:
    """Analytic ADAS-shaped rate model for one impurity element.

    S_z(T) = s0 (z+1) sqrt(T) exp(-chi_z / T),  chi_z = chi0 (z+1)^2
    R_z(T) = r0 z^2 / sqrt(T)
    (hydrogenic-scaling shapes; coefficients calibrated per element).
    """

    z_max: int = 10           # highest charge state tracked
    chi0_ev: float = 13.6     # ionisation-potential scale [eV]
    s0: float = 1e-14         # ionisation prefactor [m^3/s]
    r0: float = 1e-19         # recombination prefactor [m^3/s]

    def ionisation_rate(self, t_e_ev, z):
        chi = self.chi0_ev * (z + 1.0) ** 2
        t = jnp.maximum(t_e_ev, 0.1)
        return self.s0 * (z + 1.0) * jnp.sqrt(t) * jnp.exp(-chi / t)

    def recombination_rate(self, t_e_ev, z):
        t = jnp.maximum(t_e_ev, 0.1)
        return self.r0 * z**2 / jnp.sqrt(t)


def coronal_equilibrium(species: ImpuritySpecies, t_e_ev, n_total=1.0):
    """Closed-form coronal charge-state distribution at one T_e.

    Balance S_z n_z = R_{z+1} n_{z+1} gives the recursive ratios; the
    distribution is normalised to ``n_total``.
    """
    z_states = jnp.arange(species.z_max + 1, dtype=default_float())

    def ratio(z):
        s = species.ionisation_rate(t_e_ev, z)
        r = species.recombination_rate(t_e_ev, z + 1.0)
        return s / jnp.maximum(r, 1e-30)

    log_ratios = jnp.log(jnp.maximum(jax.vmap(ratio)(z_states[:-1]), 1e-300))
    log_n = jnp.concatenate([jnp.zeros(1), jnp.cumsum(log_ratios)])
    log_n = log_n - jnp.max(log_n)
    n = jnp.exp(log_n)
    return n_total * n / jnp.sum(n)


class ImpurityState(NamedTuple):
    n_z: jnp.ndarray     # (Z+1, nr) charge-state densities [1e19 m^-3]


@partial(jax.jit, static_argnames=("species",))
def impurity_step(
    species: ImpuritySpecies,
    state: ImpurityState,
    t_e_ev: jnp.ndarray,      # (nr,) electron temperature [eV]
    n_e_19: jnp.ndarray,      # (nr,)
    d_imp: jnp.ndarray,       # (nr,) diffusivity [m^2/s]
    rho: jnp.ndarray,
    dt,
    *,
    edge_source_1e19: float = 0.0,
) -> ImpurityState:
    """One operator-split step: implicit atomic rates + CN radial diffusion.

    Atomic step is pointwise-implicit (backward Euler on the tridiagonal
    ladder in charge-state space, solved with the batched Thomas kernel over
    radius); diffusion advances every state with the shared CN machinery.
    """
    n_z = state.n_z
    zp1, nr = n_z.shape
    drho = rho[1] - rho[0]
    n_e_m3 = jnp.maximum(n_e_19, 1e-3) * 1e19

    z_states = jnp.arange(zp1, dtype=n_z.dtype)
    s_z = jax.vmap(lambda z: species.ionisation_rate(t_e_ev, z))(z_states)
    r_z = jax.vmap(lambda z: species.recombination_rate(t_e_ev, z))(z_states)
    s_z = s_z * n_e_m3[None, :]           # (Z+1, nr) [1/s]
    r_z = r_z * n_e_m3[None, :]
    s_z = s_z.at[-1].set(0.0)             # fully stripped cannot ionise
    r_z = r_z.at[0].set(0.0)              # neutral cannot recombine

    # Backward-Euler ladder (tridiagonal in z) for every radius at once:
    # (I - dt A) n^{new} = n,   A = ladder matrix.
    sub = -dt * s_z[:-1, :]               # from z-1 ionising into z
    diag = 1.0 + dt * (s_z + r_z)
    sup = -dt * r_z[1:, :]                # from z+1 recombining into z
    n_new = thomas_solve_batched(sub.T, diag.T, sup.T, n_z.T).T
    n_new = jnp.maximum(n_new, 0.0)

    # Radial CN diffusion per charge state (batched over z).
    def diffuse(n_1d):
        lh = explicit_diffusion_rhs(n_1d, d_imp, rho, drho)
        rhs = n_1d + 0.5 * dt * lh
        a, b, c = build_cn_tridiag(d_imp, dt, rho, drho)
        b = b.at[0].set(1.0).at[-1].set(1.0)
        c = c.at[0].set(-1.0)
        a = a.at[-1].set(0.0)
        rhs = rhs.at[0].set(0.0).at[-1].set(edge_source_1e19)
        from scpn_fusion_tpu.ops.tridiag import thomas_solve
        out = thomas_solve(a, b, c, rhs)
        return jnp.maximum(out.at[0].set(out[1]), 0.0)

    # Only the neutral stage receives the edge (wall) source.
    n_diff = jax.vmap(diffuse)(n_new)
    idx = jnp.arange(zp1)
    edge_vals = jnp.where(idx == 0, edge_source_1e19, 0.0)
    n_diff = n_diff.at[:, -1].set(edge_vals)
    return ImpurityState(n_diff)


def line_radiation_w_m3(species: ImpuritySpecies, state: ImpurityState,
                        t_e_ev: jnp.ndarray, n_e_19: jnp.ndarray):
    """Total line radiation: P = n_e sum_z n_z L_z(T), with the cooling rate
    L_z ~ c0 z^2 / sqrt(T) exp(-E_line/T) (coronal closure)."""
    zp1 = state.n_z.shape[0]
    z_states = jnp.arange(zp1, dtype=state.n_z.dtype)
    t = jnp.maximum(t_e_ev, 0.1)
    lz = 1e-33 * z_states[:, None] ** 2 / jnp.sqrt(t)[None, :] \
        * jnp.exp(-10.0 * z_states[:, None] / t[None, :])
    # densities in 1e19: fold 1e38 host-side (f32-safe).
    return (n_e_19[None, :] * state.n_z) * (lz * 1e38)


@partial(jax.jit, static_argnames=("species", "n_steps"))
def run_impurity(
    species: ImpuritySpecies,
    state: ImpurityState,
    t_e_ev: jnp.ndarray,
    n_e_19: jnp.ndarray,
    d_imp: jnp.ndarray,
    rho: jnp.ndarray,
    dt,
    *,
    n_steps: int,
    edge_source_1e19: float = 0.0,
):
    """Evolve the impurity system; returns (state, radiation trace)."""
    def step(s, _):
        s2 = impurity_step(species, s, t_e_ev, n_e_19, d_imp, rho, dt,
                           edge_source_1e19=edge_source_1e19)
        p_rad = jnp.sum(line_radiation_w_m3(species, s2, t_e_ev, n_e_19))
        return s2, {"p_rad_total": p_rad,
                    "n_total": jnp.sum(s2.n_z)}

    return jax.lax.scan(step, state, None, length=n_steps)
