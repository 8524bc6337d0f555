"""Fixed-boundary Grad-Shafranov equilibrium: the compiled Picard solver.

This is the compiled redesign of the reference's host-driven Picard loop
(``fusion_kernel_newton_solver.py:390-615``): the *entire* nonlinear solve —
topology analysis, profile/source update, elliptic sweeps (SOR / Jacobi /
multigrid V-cycle), under-relaxation, Anderson mixing, divergence guard with
best-state tracking, and the dual convergence criterion — runs inside ONE
``jax.lax.while_loop`` under ``jit``.  The host participates only at entry
and exit (the design the reference itself validated on GPU in
``jax_predictive_forward_compiled.py:12-27``: the eager version is
host-dispatch-bound).

Semantics parity with the reference:
* seed plasma: normalised Gaussian J + 50 Jacobi pre-sweeps (``:384-410``)
* zero-current short-circuit: vacuum field is the exact answer (``:445-465``)
* per-iteration: axis/X-point -> J_phi (Ip-renormalised) -> elliptic step ->
  under-relaxation ``psi <- (1-a) psi + a psi_new``
* Anderson acceleration every 3rd step with Tikhonov-regularised LSQ mixing
* convergence: ``mean|dpsi| < tol`` and optionally GS-residual RMS < gs_tol
* divergence: non-finite update ends the loop; the best-seen state is returned
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scpn_fusion_tpu.core.config import ReactorConfig
from scpn_fusion_tpu.core.grid import Grid
from scpn_fusion_tpu.models.equilibrium.profiles import (
    ProfileCoeffs,
    plasma_current_density,
    profile_coeffs_from_physics,
)
from scpn_fusion_tpu.models.equilibrium.topology import analyze_topology, compute_b_field
from scpn_fusion_tpu.models.equilibrium.vacuum import vacuum_psi_from_config
from scpn_fusion_tpu.ops.multigrid import _vcycle_impl
from scpn_fusion_tpu.ops.stencil import (
    apply_dirichlet,
    gs_residual_rms,
    jacobi_step,
    jacobi_sweeps,
    sor_step,
)

# Precision of the Anderson contractions.  At the default precision an H100
# may round float32 operands to TF32 (10-bit mantissa): forced TF32 moved
# the float32 mix of a 4 x 257^2 history 1.7e-6 from float64, against
# 1.5e-7 in full float32.  Pinned, the default precision cannot reach them.
CONTRACT_PRECISION = jax.lax.Precision.HIGHEST


class EquilibriumResult(NamedTuple):
    """Result pytree (contract mirrors the reference's result dict
    ``fusion_kernel_newton_solver.py:604-615``)."""

    psi: jnp.ndarray
    j_phi: jnp.ndarray
    b_r: jnp.ndarray
    b_z: jnp.ndarray
    converged: jnp.ndarray          # bool scalar
    iterations: jnp.ndarray         # int32 scalar
    residual: jnp.ndarray           # best update-diff seen
    gs_residual: jnp.ndarray        # final GS-residual RMS
    gs_residual_best: jnp.ndarray
    residual_history: jnp.ndarray   # (max_iter,), NaN-padded
    gs_residual_history: jnp.ndarray


class _Carry(NamedTuple):
    k: jnp.ndarray
    psi: jnp.ndarray
    diff: jnp.ndarray
    gs_res: jnp.ndarray
    converged: jnp.ndarray
    best_diff: jnp.ndarray
    best_psi: jnp.ndarray
    gs_best: jnp.ndarray
    res_hist: jnp.ndarray
    gs_hist: jnp.ndarray
    # Anderson rolling buffers (newest last); depth 1 when disabled.
    psi_buf: jnp.ndarray   # (m, NZ, NR)
    f_buf: jnp.ndarray     # (m, NZ, NR)
    n_valid: jnp.ndarray


def _anderson_mix(
    psi_buf: jnp.ndarray,
    f_buf: jnp.ndarray,
    n_valid: jnp.ndarray,
    gram_in_f32: bool = False,
) -> jnp.ndarray:
    """Tikhonov-regularised Anderson mixing over fixed-size history buffers.

    Port of the reference algorithm (``fusion_kernel_iterative_solver.py:
    248-314``) with a static buffer: invalid (not-yet-filled) history rows are
    masked to zero.  Regularisation is scale-RELATIVE (1e-8 of the mean Gram
    diagonal, plus a 1e-10 absolute floor) and the extrapolation weights are
    norm-clipped: near convergence the Gram matrix is numerically singular in
    f32, and an absolute-only Tikhonov term lets O(1e-6) reduction-order
    noise (e.g. from the distributed V-cycle's psum ordering) produce huge
    mixing weights that destabilise the whole Picard loop — observed as
    non-convergence of the 2-shard solve before this safeguard.

    Buffers are kept in field shape (m, NZ, NR) — NOT flattened — so the
    history operations stay GSPMD-clean when the field is mesh-sharded
    (reshaping a non-divisibly-sharded axis forced data movement and, with
    the Z-slab sharded elliptic solve, produced wrong mixes that locked the
    Picard loop into a period-3 limit cycle; einsum contractions over the
    2D field lower to plain psums).
    """
    m = psi_buf.shape[0]
    idx = jnp.arange(m)
    valid = idx >= (m - n_valid)                       # newest entries are valid
    f_masked = jnp.where(valid[:, None, None], f_buf, 0.0)

    d_f = f_masked[1:] - f_masked[:-1]                 # (m-1, NZ, NR)
    pair_valid = idx[:-1] >= (m - n_valid)             # both rows valid
    d_f = jnp.where(pair_valid[:, None, None], d_f, 0.0)

    rhs = f_masked[-1]
    # ``gram_in_f32`` (mixed-precision path): the Gram build + LU solve run
    # in f32.  The mixing WEIGHTS only steer the combination (any weight
    # error is absorbed by the fixed-point iteration); the combination
    # itself stays in the buffers' own (f64) dtype below, which is what
    # preserves precision.
    cdt = jnp.float32 if gram_in_f32 else f_buf.dtype
    d_f_c = d_f.astype(cdt)
    gram = jnp.einsum("mij,nij->mn", d_f_c, d_f_c,
                      precision=CONTRACT_PRECISION)
    scale = jnp.trace(gram) / (m - 1)
    gram = gram + (1e-10 + 1e-8 * scale) * jnp.eye(m - 1, dtype=cdt)
    gamma = jnp.linalg.solve(
        gram, jnp.einsum("mij,ij->m", d_f_c, rhs.astype(cdt),
                         precision=CONTRACT_PRECISION)
    ).astype(f_buf.dtype)
    # Extrapolation safeguard: bound ||gamma|| (standard safeguarded-AA).
    g_norm = jnp.linalg.norm(gamma)
    g_max = jnp.asarray(10.0, f_buf.dtype)
    gamma = gamma * jnp.minimum(1.0, g_max / jnp.maximum(g_norm, 1e-30))

    # Telescoped iterate weights for type-II AA: the mixed iterate is
    # y_last - sum_j gamma_j (y_{j+1} - y_j), i.e. alpha_0 = gamma_0,
    # alpha_j = gamma_j - gamma_{j-1}, alpha_last = 1 - gamma_{m-2}.
    # (The pre-fix mapping alpha[:-1] = -gamma extrapolated in the WRONG
    # direction — verified on a linear fixed-point map, 2026-08-18.)
    alpha = jnp.zeros((m,), dtype=f_buf.dtype)
    alpha = alpha.at[:-1].add(gamma)
    alpha = alpha.at[1:].add(-gamma)
    alpha = alpha.at[-1].add(1.0)
    alpha = jnp.where(valid, alpha, 0.0)
    alpha_sum = jnp.sum(alpha)
    safe = jnp.abs(alpha_sum) >= 1e-12
    alpha = jnp.where(safe, alpha / jnp.where(safe, alpha_sum, 1.0), 0.0)

    mixed = jnp.einsum("m,mij->ij", alpha, psi_buf,
                       precision=CONTRACT_PRECISION)
    # Fall back to the newest iterate if the mix was degenerate.
    return jnp.where(safe, mixed, psi_buf[-1])


def solve_fixed_boundary_impl(
    grid: Grid,
    psi0: jnp.ndarray,
    psi_bc: jnp.ndarray,
    i_target: jnp.ndarray,
    p_coeffs: ProfileCoeffs,
    ff_coeffs: ProfileCoeffs,
    tol: jnp.ndarray,
    gs_tol: jnp.ndarray,
    alpha_relax: jnp.ndarray,
    omega: jnp.ndarray,
    *,
    solver_method: str,
    max_iter: int,
    h_mode: bool,
    inner_sweeps: int,
    anderson_m: int,
    mu0: float,
    use_gs_criterion: bool,
    elliptic_fn=None,
    skip_seed: bool = False,
    anderson_gram_f32: bool = False,
    mg_pre_smooth: int = 3,
    mg_post_smooth: int = 3,
    mg_min_grid: int = 5,
) -> EquilibriumResult:
    r_1d = grid.R
    rr = grid.RR
    zz = grid.ZZ
    d_r, d_z = grid.dR, grid.dZ
    dtype = psi0.dtype

    # "anderson" mixes over SOR inner sweeps (reference pairing);
    # "anderson_mg" mixes over the multigrid V-cycle — the V-cycle is a
    # near-exact elliptic solve, so Anderson works on the pure Picard
    # source-update map and cuts the outer iteration count several-fold
    # (the headline-bench configuration).
    use_anderson = solver_method in ("anderson", "anderson_mg")
    m_hist = anderson_m if use_anderson else 1

    # ── seed plasma: normalised Gaussian J + 50 Jacobi pre-sweeps ──
    # ``skip_seed`` (static): a warm start (FMG cascade / previous-shot
    # reuse) already carries a near-converged interior; the seed sweeps
    # would pull it back toward the Gaussian guess and waste ~50 sweeps.
    if skip_seed:
        psi = psi0
    else:
        r_center = 0.5 * (grid.R_min + grid.R_max)
        dist_sq = (rr - r_center) ** 2 + zz**2
        j_seed = jnp.exp(-dist_sq / 2.0)
        i_seed = jnp.sum(j_seed) * d_r * d_z
        j_seed = j_seed * (i_target / jnp.maximum(i_seed, 1e-30))
        seed_source = -mu0 * rr * j_seed
        psi = jacobi_sweeps(psi0, seed_source, r_1d, d_r, d_z, 50)

    def elliptic_step(psi_in: jnp.ndarray, source: jnp.ndarray) -> jnp.ndarray:
        if elliptic_fn is not None:
            # Injected elliptic solver (e.g. the distributed sharded V-cycle,
            # ``parallel/sharded_mg.sharded_vcycle`` — same Picard/Anderson
            # outer loop, mesh-parallel inner solve).
            out = elliptic_fn(psi_in, source)
        elif solver_method == "jacobi":
            out = psi_in
            for _ in range(inner_sweeps):
                out = jacobi_step(out, source, r_1d, d_r, d_z)
        elif solver_method in ("multigrid", "anderson_mg"):
            out = _vcycle_impl(psi_in, source, r_1d, d_r, d_z,
                               1.0, mg_pre_smooth, mg_post_smooth,
                               mg_min_grid, 50)
        else:  # "sor" | "anderson"
            out = psi_in
            for _ in range(inner_sweeps):
                out = sor_step(out, source, r_1d, d_r, d_z, omega)
        return apply_dirichlet(out, psi_bc)

    def picard_source(psi_k: jnp.ndarray) -> jnp.ndarray:
        """Topology + Ip-renormalised current source for one iteration."""
        topo = analyze_topology(psi_k, zz, d_r, d_z, grid.Z_min)
        j_phi = plasma_current_density(
            psi_k, topo.psi_axis, topo.psi_boundary, rr,
            h_mode=h_mode, p_coeffs=p_coeffs, ff_coeffs=ff_coeffs,
            mu0=mu0, i_target=i_target, d_r=d_r, d_z=d_z,
        )
        return -mu0 * rr * j_phi

    def body(c: _Carry) -> _Carry:
        source = picard_source(c.psi)
        psi_new = elliptic_step(c.psi, source)

        diff = jnp.mean(jnp.abs(psi_new - c.psi))
        psi_relaxed = (1.0 - alpha_relax) * c.psi + alpha_relax * psi_new

        if use_anderson:
            # Residual of the UNDAMPED fixed-point map, f = G(psi) - psi:
            # pairing it with the damped iterate y = psi + alpha f is the
            # standard Walker-Ni type-II AA.  (The pre-fix residual
            # psi_new - psi_relaxed = (1 - alpha)(G(psi) - psi) is
            # IDENTICALLY ZERO at relaxation 1.0, silently disabling the
            # mixer in the headline configuration.)
            psi_buf = jnp.roll(c.psi_buf, -1, axis=0).at[-1].set(psi_relaxed)
            f_buf = jnp.roll(c.f_buf, -1, axis=0).at[-1].set(
                psi_new - c.psi)
            n_valid = jnp.minimum(c.n_valid + 1, m_hist)

            def do_mix(_):
                mixed = _anderson_mix(psi_buf, f_buf, n_valid,
                                      gram_in_f32=anderson_gram_f32)
                return apply_dirichlet(mixed, psi_bc)

            psi_next = jax.lax.cond(
                (n_valid >= 3) & (c.k % 3 == 0),
                do_mix, lambda _: psi_relaxed, operand=None,
            )
        else:
            psi_buf, f_buf, n_valid = c.psi_buf, c.f_buf, c.n_valid
            psi_next = psi_relaxed

        # The per-iteration GS residual (a full-grid stencil + reduction)
        # only gates convergence when use_gs_criterion is on; otherwise
        # skip it statically — the final residual is still computed once
        # post-loop for the result contract.
        if use_gs_criterion:
            gs_res = gs_residual_rms(psi_next, source, r_1d, d_r, d_z)
            gs_best = jnp.minimum(gs_res, c.gs_best)
        else:
            gs_res = jnp.asarray(jnp.nan, dtype)
            gs_best = c.gs_best

        improved = diff < c.best_diff
        best_diff = jnp.where(improved, diff, c.best_diff)
        best_psi = jnp.where(improved, psi_next, c.best_psi)

        upd_ok = diff < tol
        gs_ok = (gs_res < gs_tol) if use_gs_criterion else jnp.bool_(True)
        converged = upd_ok & gs_ok

        return _Carry(
            k=c.k + 1,
            psi=psi_next,
            diff=diff,
            gs_res=gs_res,
            converged=converged,
            best_diff=best_diff,
            best_psi=best_psi,
            gs_best=gs_best,
            res_hist=c.res_hist.at[c.k].set(diff),
            gs_hist=c.gs_hist.at[c.k].set(gs_res),
            psi_buf=psi_buf,
            f_buf=f_buf,
            n_valid=n_valid,
        )

    def cond(c: _Carry) -> jnp.ndarray:
        return (c.k < max_iter) & (~c.converged) & jnp.isfinite(c.diff)

    def guarded_body(c: _Carry) -> _Carry:
        """Freeze finished elements: under ``vmap`` the while_loop runs
        until ALL batch elements finish, and an unguarded body would keep
        Picard-iterating already-converged elements past their stopping
        point — batched results then drift ~O(tol/contraction) from the
        standalone solve (measured 2.7e-3 span-rel at B=16).  Selecting
        the old carry when ``cond`` is false makes every batched
        element's trajectory identical to its standalone run; on a single
        solve the guard is a no-op (the loop exits when cond is false)."""
        new = body(c)
        keep = cond(c)
        return jax.tree.map(lambda a, b: jnp.where(keep, a, b), new, c)

    init = _Carry(
        k=jnp.int32(0),
        psi=psi,
        diff=jnp.asarray(1e30, dtype),  # finite sentinel: loop must start
        gs_res=jnp.asarray(jnp.inf, dtype),
        converged=jnp.bool_(False),
        best_diff=jnp.asarray(jnp.inf, dtype),
        best_psi=psi,
        gs_best=jnp.asarray(jnp.inf, dtype),
        res_hist=jnp.full((max_iter,), jnp.nan, dtype),
        gs_hist=jnp.full((max_iter,), jnp.nan, dtype),
        psi_buf=jnp.zeros((m_hist,) + psi.shape, dtype),
        f_buf=jnp.zeros((m_hist,) + psi.shape, dtype),
        n_valid=jnp.int32(0),
    )
    final = jax.lax.while_loop(cond, guarded_body, init)

    # Divergence guard: if the last update went non-finite, return best state.
    diverged = ~jnp.isfinite(final.diff)
    psi_out = jnp.where(diverged, final.best_psi, final.psi)

    # Recompute the consistent source/current for the returned psi.
    topo = analyze_topology(psi_out, zz, d_r, d_z, grid.Z_min)
    j_phi = plasma_current_density(
        psi_out, topo.psi_axis, topo.psi_boundary, rr,
        h_mode=h_mode, p_coeffs=p_coeffs, ff_coeffs=ff_coeffs,
        mu0=mu0, i_target=i_target, d_r=d_r, d_z=d_z,
    )
    source = -mu0 * rr * j_phi
    gs_final = gs_residual_rms(psi_out, source, r_1d, d_r, d_z)
    b_r, b_z = compute_b_field(psi_out, rr, d_r, d_z)

    return EquilibriumResult(
        psi=psi_out,
        j_phi=j_phi,
        b_r=b_r,
        b_z=b_z,
        converged=final.converged & ~diverged,
        iterations=final.k,
        residual=final.best_diff,
        gs_residual=gs_final,
        gs_residual_best=jnp.minimum(final.gs_best, gs_final),
        residual_history=final.res_hist,
        gs_residual_history=final.gs_hist,
    )


_solve_fixed_boundary = partial(
    jax.jit,
    static_argnames=("grid", "solver_method", "max_iter", "h_mode",
                     "inner_sweeps", "anderson_m", "mu0", "use_gs_criterion",
                     "elliptic_fn", "skip_seed",
                     "anderson_gram_f32", "mg_pre_smooth", "mg_post_smooth",
                     "mg_min_grid"),
)(solve_fixed_boundary_impl)


def solve_equilibrium(
    cfg: ReactorConfig,
    grid: Grid | None = None,
    *,
    psi0: jnp.ndarray | None = None,
    boundary_flux: jnp.ndarray | None = None,
    preserve_initial_state: bool = False,
    i_target: float | jnp.ndarray | None = None,
    dtype=jnp.float32,
    skip_seed: bool = False,
) -> EquilibriumResult:
    """Solve the fixed-boundary GS equilibrium for a reactor configuration.

    Host-side wrapper: prepares the initial/boundary flux exactly like the
    reference's ``_prepare_initial_flux`` (``fusion_kernel_iterative_solver
    .py:412-451``), then dispatches into the single compiled solve.

    Parameters
    ----------
    cfg : static reactor configuration (geometry + solver controls).
    grid : optional pre-built grid (defaults to ``Grid.from_config``).
    psi0 : optional initial flux (used with ``preserve_initial_state``).
    boundary_flux : optional explicit Dirichlet boundary map, shape (NZ, NR).
    i_target : overrides ``cfg.physics.plasma_current_target`` (traced —
        differentiable without recompilation).
    """
    if grid is None:
        grid = Grid.from_config(cfg, dtype=dtype)

    i_t = cfg.physics.plasma_current_target if i_target is None else i_target
    i_t = jnp.asarray(i_t, dtype)
    mu0 = float(cfg.physics.vacuum_permeability)

    # Zero-current short-circuit: vacuum field is the exact equilibrium.
    if i_target is None and abs(cfg.physics.plasma_current_target) < 1e-12 \
            and not preserve_initial_state:
        psi_vac = vacuum_psi_from_config(grid, cfg).astype(dtype)
        zeros = grid.zeros().astype(dtype)
        b_r, b_z = compute_b_field(psi_vac, grid.RR, grid.dR, grid.dZ)
        n = cfg.solver.max_iterations
        return EquilibriumResult(
            psi=psi_vac, j_phi=zeros, b_r=b_r, b_z=b_z,
            converged=jnp.bool_(True), iterations=jnp.int32(0),
            residual=jnp.asarray(0.0, dtype), gs_residual=jnp.asarray(0.0, dtype),
            gs_residual_best=jnp.asarray(0.0, dtype),
            residual_history=jnp.full((n,), jnp.nan, dtype),
            gs_residual_history=jnp.full((n,), jnp.nan, dtype),
        )

    # Initial / boundary flux preparation.
    if boundary_flux is not None:
        psi_bc = jnp.asarray(boundary_flux, dtype)
        if psi_bc.shape != grid.shape:
            raise ValueError(
                f"boundary_flux shape {psi_bc.shape} must match grid {grid.shape}")
    elif preserve_initial_state and psi0 is not None:
        psi_bc = jnp.asarray(psi0, dtype)
    else:
        psi_bc = vacuum_psi_from_config(grid, cfg).astype(dtype)

    if preserve_initial_state and psi0 is not None:
        psi_init = apply_dirichlet(jnp.asarray(psi0, dtype), psi_bc)
    else:
        psi_init = psi_bc

    p_coeffs, ff_coeffs = profile_coeffs_from_physics(cfg.physics, dtype)
    sol = cfg.solver

    return _solve_fixed_boundary(
        grid,
        psi_init,
        psi_bc,
        i_t,
        p_coeffs,
        ff_coeffs,
        jnp.asarray(sol.convergence_threshold, dtype),
        jnp.asarray(sol.gs_residual_threshold
                    if sol.gs_residual_threshold > 0 else jnp.inf, dtype),
        jnp.asarray(sol.relaxation_factor, dtype),
        jnp.asarray(sol.sor_omega, dtype),
        solver_method=sol.solver_method,
        max_iter=sol.max_iterations,
        h_mode=cfg.physics.profile_mode == "h-mode",
        inner_sweeps=sol.inner_sweeps,
        anderson_m=sol.anderson_depth,
        mu0=mu0,
        use_gs_criterion=sol.gs_residual_threshold > 0,
        skip_seed=skip_seed,
        mg_pre_smooth=sol.mg_pre_smooth,
        mg_post_smooth=sol.mg_post_smooth,
        mg_min_grid=sol.mg_min_grid,
    )


def solve_equilibrium_fmg(
    cfg: ReactorConfig,
    *,
    coarse_tol: float = 1e-3,
    min_coarse: int = 65,
    i_target: float | jnp.ndarray | None = None,
    dtype=jnp.float32,
) -> tuple[EquilibriumResult, list[dict]]:
    """Nested-iteration (FMG) Picard cascade to the configured resolution.

    Classic full-multigrid applied at the PICARD level: solve the
    equilibrium on a coarse grid first (loose ``coarse_tol``), bilinearly
    prolong the converged flux, and warm-start the next level, finishing
    at the configured resolution and tolerance.  The coarse levels cost
    ~1/4 (1/16, ...) of a fine outer iteration each, and the warm start
    roughly halves the fine-level outer count (513^2 headline: ~6
    Anderson-MG iterations vs ~8 direct; measured in ``bench.py``).
    Same fixed point
    as the direct solve to within the convergence-tolerance scale — the
    fine level runs the UNCHANGED residual-gated solve, only its initial
    guess differs.  (The reference's warm starts reuse a *previous* shot's
    solution, ``jax_predictive_forward_compiled.py``; this cascade needs
    no history and accelerates cold solves.)

    Coarse levels converge on the update criterion alone (their only job
    is the warm start); a ``gs_residual_threshold`` gates the finest level,
    as in ``mixed_precision.solve_equilibrium_mixed_fmg``.

    Returns ``(final_result, cascade_info)`` where cascade_info lists
    per-level grid size and outer iterations.
    """
    from scpn_fusion_tpu.ops.multigrid import prolongate_bilinear

    nr, nz = cfg.grid_resolution
    if nr != nz:
        raise ValueError("solve_equilibrium_fmg expects a square grid")
    sizes = [nr]
    while (sizes[-1] - 1) % 2 == 0 and (sizes[-1] - 1) // 2 + 1 >= min_coarse:
        sizes.append((sizes[-1] - 1) // 2 + 1)
    sizes = sizes[::-1]

    psi = None
    info: list[dict] = []
    res = None
    for n in sizes:
        level_cfg = dataclasses.replace(
            cfg,
            grid_resolution=(n, n),
            solver=dataclasses.replace(
                cfg.solver,
                convergence_threshold=(cfg.solver.convergence_threshold
                                       if n == nr else coarse_tol),
                gs_residual_threshold=(cfg.solver.gs_residual_threshold
                                       if n == nr else 0.0)))
        # Warm levels need the EXACT fine-grid vacuum Dirichlet ring —
        # preserve_initial_state alone would take the boundary from the
        # prolonged field (O(h_coarse^2) boundary error that the fine
        # solve can never repair).
        level_grid = Grid.from_config(level_cfg, dtype=dtype)
        bc = (vacuum_psi_from_config(level_grid, level_cfg).astype(dtype)
              if psi is not None else None)
        res = solve_equilibrium(
            level_cfg,
            grid=level_grid,
            psi0=psi,
            boundary_flux=bc,
            preserve_initial_state=psi is not None,
            i_target=i_target,
            dtype=dtype,
            skip_seed=psi is not None)
        info.append({"n": n, "iterations": int(res.iterations),
                     "converged": bool(res.converged)})
        if n != nr:
            psi = prolongate_bilinear(res.psi, 2 * (n - 1) + 1,
                                      2 * (n - 1) + 1)
    return res, info
