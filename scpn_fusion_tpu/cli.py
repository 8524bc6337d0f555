"""Command-line interface: `python -m scpn_fusion_tpu.cli <mode> ...`.

The L6 surface (reference: ``cli.py`` console script with a 30-mode registry
dispatched through *subprocesses*, ``cli.py:39-243``).  accelerator-first redesign:
modes are plain function calls in-process — there is no subprocess
indirection to amortise because solvers are compiled functions, not scripts.
argparse only (no third-party CLI dependency).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _mode_kernel(args) -> int:
    """Fixed-boundary equilibrium solve from a JSON reactor config."""
    import jax.numpy as jnp

    from scpn_fusion_tpu.core.config import load_config
    from scpn_fusion_tpu.models.equilibrium import solve_equilibrium

    cfg = load_config(args.config)
    res = solve_equilibrium(cfg)
    out = {
        "reactor": cfg.reactor_name,
        "converged": bool(res.converged),
        "iterations": int(res.iterations),
        "residual": float(res.residual),
        "gs_residual": float(res.gs_residual),
    }
    print(json.dumps(out))
    if args.output:
        np.savez(args.output, psi=np.asarray(res.psi),
                 j_phi=np.asarray(res.j_phi),
                 b_r=np.asarray(res.b_r), b_z=np.asarray(res.b_z))
        print(f"saved: {args.output}", file=sys.stderr)
    return 0 if out["converged"] else 1


def _mode_free_boundary(args) -> int:
    from scpn_fusion_tpu.core.config import load_config
    from scpn_fusion_tpu.models.equilibrium.free_boundary import solve_free_boundary

    cfg = load_config(args.config)
    res = solve_free_boundary(cfg, max_outer_iter=args.max_outer)
    out = {
        "converged": bool(res.converged),
        "outer_iterations": int(res.outer_iterations),
        "final_diff": float(res.final_diff),
        "coil_currents": np.asarray(res.coil_currents).tolist(),
    }
    print(json.dumps(out))
    if args.output:
        np.savez(args.output, psi=np.asarray(res.psi))
    return 0 if out["converged"] else 1


def _mode_geqdsk(args) -> int:
    """Reconstruct an equilibrium from a G-EQDSK file (parity lane)."""
    from scpn_fusion_tpu.io import read_geqdsk
    from scpn_fusion_tpu.models.equilibrium.eqdsk_solve import solve_from_geqdsk

    eq = read_geqdsk(args.file)
    res = solve_from_geqdsk(eq, max_iter=args.max_iter)
    out = {
        "file": str(args.file),
        "grid": [eq.nw, eq.nh],
        "converged": bool(res.converged),
        "iterations": int(res.iterations),
        "span_rel_rmse": float(res.span_rel_rmse),
        "span_rel_rmse_core": float(res.span_rel_rmse_core),
    }
    print(json.dumps(out))
    return 0 if out["converged"] else 1


def _mode_transport(args) -> int:
    import jax.numpy as jnp

    from scpn_fusion_tpu.models.transport import (
        TransportParams, initial_state, run_transport)

    params = TransportParams()
    state = initial_state(params)
    final, trace = run_transport(state, jnp.float32(args.dt),
                                 jnp.float32(args.p_aux), params, args.steps)
    out = {
        "steps": args.steps,
        "ti_core_kev": float(final.ti[1]),
        "te_core_kev": float(final.te[1]),
        "he_ash_peak": float(np.max(np.asarray(final.n_he))),
        "z_eff": float(final.z_eff),
    }
    print(json.dumps(out))
    return 0


def _mode_flight_sim(args) -> int:
    from scpn_fusion_tpu.control.flight_sim import FlightSimParams, run_shot_reduced

    params = FlightSimParams(control_hz=args.hz, shot_duration_s=args.duration)
    _, metrics = run_shot_reduced(params)
    out = {k: float(v) for k, v in metrics.items()}
    out["ticks"] = params.n_steps
    print(json.dumps(out))
    return 0 if out["disruption_fraction"] == 0.0 else 1


def _mode_realtime(args) -> int:
    """Three-node realtime bus session (reference
    ``run_realtime_simulation.py`` counterpart — physics, controller and
    diagnostics as separate OS processes over a dict-proxy bus)."""
    from scpn_fusion_tpu.control.realtime_bus import run_realtime_session

    res = run_realtime_session(n_ticks=args.ticks,
                               tick_interval_s=args.tick_interval)
    out = {
        "ticks": res.n_ticks,
        "final_r_err_m": res.final_r_err,
        "final_z_err_m": res.final_z_err,
        "open_loop_r_err_m": res.open_loop_r_err,
        "controller_actions": res.controller_actions,
        "stale_action_reads": res.stale_action_reads,
        "diagnostics": res.diagnostics,
        "wall_s": round(res.wall_s, 3),
    }
    print(json.dumps(out))
    closed = (res.final_r_err < 0.5 * res.open_loop_r_err
              and not res.diagnostics.get("disrupted_any", True))
    return 0 if closed else 1


def _mode_burn(args) -> int:
    from scpn_fusion_tpu.models.physics.scaling_burn import burn_equilibrium_0d

    pt = burn_equilibrium_0d(
        ne19=args.ne19, p_aux_mw=args.p_aux, ip_ma=args.ip, bt_t=args.bt,
        r_m=args.r0, a_m=args.a, kappa=args.kappa)
    out = {"Q": float(pt.q_fusion), "P_fusion_MW": float(pt.p_fusion_mw),
           "T_keV": float(pt.t_kev), "tau_E_s": float(pt.tau_e_s),
           "converged": bool(pt.converged)}
    print(json.dumps(out))
    return 0


def _mode_validate(args) -> int:
    """Run one named campaign, or the full pipeline with --all
    (reference ``full_validation_pipeline.py`` role).  Each campaign runs
    in-process via runpy; a non-zero exit from any campaign fails the
    pipeline, and RESULTS.md is regenerated at the end."""
    import runpy

    vdir = Path(__file__).resolve().parents[1] / "validation"
    if args.all:
        names = sorted(p.stem for p in vdir.glob("run_*.py"))
    else:
        names = [f"run_{args.campaign}"]
    worst = 0
    for name in names:
        script = vdir / f"{name}.py"
        if not script.exists():
            print(f"unknown campaign: {name}", file=sys.stderr)
            return 2
        print(f"== {name}", file=sys.stderr)
        try:
            runpy.run_path(str(script), run_name="__main__")
        except SystemExit as exc:
            worst = max(worst, int(exc.code or 0))
    try:
        runpy.run_path(str(vdir / "collect_results.py"),
                       run_name="__main__")
    except SystemExit:
        pass
    return worst


def _mode_dashboard(args) -> int:
    from scpn_fusion_tpu.ui.dashboard import generate_dashboard
    from scpn_fusion_tpu.ui.html_dashboard import (
        emit_studio_manifest,
        generate_html_dashboard,
    )

    print(generate_dashboard("DASHBOARD.md"))
    print(generate_html_dashboard(".", "DASHBOARD.html"))
    print(emit_studio_manifest(".", "studio_manifest.json"))
    return 0


def _mode_tglf(args) -> int:
    """Native TGLF point evaluation (GK path A)."""
    from scpn_fusion_tpu.models.gyrokinetics.interface import GKLocalParams
    from scpn_fusion_tpu.models.gyrokinetics.registry import (
        resolve_tglf_solver,
    )

    params = GKLocalParams(
        r_l_ti=args.rlti, r_l_te=args.rlte, r_l_ne=args.rlne,
        q=args.q, s_hat=args.s_hat, epsilon=args.epsilon,
        te_ti=args.te_ti, nu_star=args.nu_star)
    out = resolve_tglf_solver().run_from_params(params)
    print(json.dumps({
        "chi_i_m2_s": out.chi_i, "chi_e_m2_s": out.chi_e,
        "d_e_m2_s": out.d_e, "dominant_mode": out.dominant_mode,
        "gamma_max_cs_a": float(np.max(out.gamma)) if out.gamma.size
        else 0.0,
    }))
    return 0


def _mode_stress(args) -> int:
    """Randomized multi-shot stress campaign (vmapped)."""
    from scpn_fusion_tpu.control.flight_sim import FlightSimParams
    from scpn_fusion_tpu.control.stress import (
        StressConfig,
        run_stress_campaign,
    )

    res = run_stress_campaign(FlightSimParams(), StressConfig(),
                              n_shots=args.shots, seed=args.seed)
    print(json.dumps({
        "n_shots": args.shots,
        "disruption_rate": float(res.disruption_rate),
        "r_err_p95_m": float(res.r_err_p95),
        "r_err_p99_m": float(res.r_err_p99),
    }))
    return 0 if float(res.disruption_rate) == 0.0 else 1


def _mode_design_scan(args) -> int:
    from scpn_fusion_tpu.models.physics.design_scan import (
        compact_reactor_search,
    )

    res = compact_reactor_search(n_samples=args.samples, seed=args.seed,
                                 p_aux_mw=args.p_aux)
    i = int(res.best_index)
    pts = res.points
    print(json.dumps({
        "n_feasible_q10": int(res.n_feasible),
        "best": {
            "r_m": float(pts.r_m[i]), "a_m": float(pts.a_m[i]),
            "b0_t": float(pts.b0_t[i]), "ip_ma": float(pts.ip_ma[i]),
            "q_fusion": float(pts.q_fusion[i]),
            "p_net_mw": float(pts.p_net_mw[i]),
        },
    }, indent=2))
    return 0 if int(res.n_feasible) > 0 else 1


def _mode_disruption(args) -> int:
    from scpn_fusion_tpu.models.physics.disruption_sequence import (
        DisruptionParams,
        run_disruption_sequence,
        structural_response_screen,
    )

    p = DisruptionParams(ip0_ma=args.ip)
    _, s = run_disruption_sequence(p, spi_ne20_injected=args.spi,
                                   spi_time_ms=0.2)
    screen = structural_response_screen(s)
    print(json.dumps({
        "tau_cq_ms": float(s.tau_cq_ms),
        "i_re_final_ma": float(s.i_re_final_ma),
        "halo_peak_ma": float(s.halo_peak_ma),
        "mitigated": bool(s.mitigated),
        "structural_screen": screen,
    }, indent=2))
    return 0


def _mode_startup(args) -> int:
    from scpn_fusion_tpu.control.scenario import (
        optimal_prefill_pressure,
        run_startup_sequence,
    )

    p_pa = args.pressure if args.pressure is not None \
        else optimal_prefill_pressure()
    res = run_startup_sequence(v_loop=args.v_loop, p_pa=p_pa, r0_m=6.2,
                               a_m=2.0)
    print(json.dumps({
        "prefill_pa": p_pa,
        "breakdown_ok": bool(res.breakdown_ok),
        "ionization_fraction": float(res.ionization_fraction),
        "burn_through_ok": bool(res.burn_through_ok),
        "succeeded": bool(res.succeeded),
    }, indent=2))
    return 0 if bool(res.succeeded) else 1


def _mode_gk(args) -> int:
    from scpn_fusion_tpu.models.gyrokinetics.nonlinear import (
        NonlinearGKConfig,
        run_nonlinear_gk,
    )

    n = args.grid
    cfg = NonlinearGKConfig(n_kx=n, n_ky=n, n_theta=n, n_vpar=n,
                            n_mu=max(n // 2, 2), n_steps=args.steps,
                            save_interval=max(args.steps // 10, 1))
    _, trace = run_nonlinear_gk(cfg)
    print(json.dumps({
        "q_ion_final_gb": float(trace.q_ion[-1]),
        "phi_rms_final": float(trace.phi_rms[-1]),
        "zonal_rms_final": float(trace.zonal_rms[-1]),
        "n_saves": int(trace.times.shape[0]),
    }, indent=2))
    return 0




def _mode_divertor(args) -> int:
    """Divertor heat exhaust: tungsten monoblock vs lithium vapor shield
    + TEMHD operating point (reference CLI mode "divertor")."""
    from scpn_fusion_tpu.models.physics.divertor_lab import (
        divertor_heat_load, lithium_vapor_shield, temhd_liquid_metal_state,
        tungsten_monoblock,
    )

    load = divertor_heat_load(args.p_sol, args.r0, args.b_pol,
                              expansion_factor=args.expansion)
    w = tungsten_monoblock(load.q_target)
    li = lithium_vapor_shield(load.q_target)
    st = temhd_liquid_metal_state(args.flow, args.p_sol, args.r0,
                                  args.b_pol, expansion_factor=args.expansion)
    print(json.dumps({
        "lambda_q_mm": float(load.lambda_q_m) * 1e3,
        "q_target_MW_m2": float(load.q_target) / 1e6,
        "tungsten_surface_C": float(w.t_surface_c),
        "tungsten_melted": bool(w.melted),
        "lithium_surface_C": float(li.t_surface_c),
        "temhd_stable": bool(st.is_stable),
    }))
    return 0


def _mode_breeding(args) -> int:
    """Multigroup blanket neutronics (reference CLI mode "breeding")."""
    from scpn_fusion_tpu.models.nuclear.blanket import (
        MultiGroupConfig, multigroup_tbr,
    )

    res = multigroup_tbr(MultiGroupConfig(
        thickness_cm=args.thickness, li6_enrichment=args.li6))
    print(json.dumps({"tbr": float(res.tbr),
                      "thickness_cm": args.thickness,
                      "li6_enrichment": args.li6}))
    return 0


def _mode_optimizer(args) -> int:
    """Compact reactor random-search optimiser (reference CLI mode
    "optimizer", ``compact_reactor_optimizer``)."""
    from scpn_fusion_tpu.models.physics.design_scan import (
        compact_reactor_search,
    )

    res = compact_reactor_search(n_samples=args.samples, seed=args.seed)
    i = int(res.best_index)
    pt = res.points
    print(json.dumps({
        "n_feasible": int(res.n_feasible),
        "best": {"R0_m": float(pt.r_m[i]), "a_m": float(pt.a_m[i]),
                 "B0_T": float(pt.b0_t[i]), "Ip_MA": float(pt.ip_ma[i]),
                 "Q": float(pt.q_fusion[i]),
                 "P_fusion_MW": float(pt.p_fusion_mw[i])},
    }))
    return 0 if int(res.n_feasible) > 0 else 1


def _mode_heating(args) -> int:
    """ECRH deposition profile + single-pass efficiency (reference CLI
    mode "heating", ``rf_heating``)."""
    from scpn_fusion_tpu.models.physics.rf_heating import (
        ECRHParams, ecrh_deposition,
    )

    rho, p_dep, eff = ecrh_deposition(
        ECRHParams(), p_ecrh_mw=args.power, t_e_kev=args.te,
        n_e_m3=args.ne * 1e19)
    i = int(np.argmax(np.asarray(p_dep)))
    print(json.dumps({
        "absorbed_fraction": float(eff),
        "peak_rho": float(np.asarray(rho)[i]),
        "peak_MW_per_bin": float(np.asarray(p_dep)[i]),
    }))
    return 0


def _mode_wdm(args) -> int:
    """Whole-device-model discharge (reference CLI mode "wdm")."""
    from scpn_fusion_tpu.models.wdm import (
        WDMConfig, collapse_time_s, default_initial_state, run_discharge,
    )

    cfg = WDMConfig()
    trace = run_discharge(cfg, default_initial_state(cfg),
                          n_steps=args.steps)
    tc = collapse_time_s(trace)
    print(json.dumps({
        "steps": args.steps,
        "final_te_core_keV": float(np.asarray(trace.te_core_kev)[-1]),
        "final_w_total_1e19": float(np.asarray(trace.w_impurity_total)[-1]),
        "collapsed": tc is not None,
        "collapse_time_s": tc,
    }))
    return 0


def _mode_safety(args) -> int:
    """Disruption predictor quick train/eval (reference CLI mode
    "safety", ``disruption_predictor``)."""
    import jax
    import jax.numpy as jnp

    from scpn_fusion_tpu.control.disruption import (
        evaluate_predictor, train_disruption_predictor,
    )

    rng = np.random.default_rng(args.seed)
    n, t_len = 24, 200
    shots = rng.standard_normal((n, t_len, 3)).astype(np.float32) * 0.1
    labels = (np.arange(n) % 2 == 0).astype(np.float32)
    t = np.arange(t_len // 2, dtype=np.float32)
    grow = 1.0 - np.exp(-t / 30.0)
    for i in range(n):
        if labels[i] > 0.5:
            shots[i, t_len // 2:, 0] += 2.0 * grow * np.sin(0.8 * t)
            shots[i, t_len // 2:, 1] += 1.5 * grow
    pred = train_disruption_predictor(
        jnp.asarray(shots), jnp.asarray(labels), jax.random.PRNGKey(0),
        n_steps=args.train_steps)
    m = evaluate_predictor(pred, jnp.asarray(shots), jnp.asarray(labels))
    print(json.dumps({"recall": float(m["recall"]),
                      "fpr": float(m["fpr"]),
                      "n_shots": n}))
    return 0 if float(m["recall"]) >= 0.9 else 1


def _mode_sawtooth(args) -> int:
    """Kadomtsev sawtooth monitor + crash (reference CLI mode "sawtooth")."""
    import jax.numpy as jnp

    from scpn_fusion_tpu.models.physics.sawtooth import sawtooth_step

    rho = jnp.linspace(0.0, 1.0, args.n)
    q = args.q0 + (args.qa - args.q0) * rho**2
    shear = jnp.gradient(q) / jnp.maximum(jnp.gradient(rho), 1e-9) \
        * rho / jnp.maximum(q, 1e-9)
    t = 5.0 * (1.0 - rho**2) + 0.5
    nprof = 8.0 * (1.0 - rho**2) + 1.0
    res = sawtooth_step(rho, t, nprof, q, shear)
    print(json.dumps({
        "triggered": bool(res.triggered),
        "rho_q1": float(res.rho_1),
        "rho_mix": float(res.rho_mix),
        "t_core_before_keV": float(t[0]),
        "t_core_after_keV": float(res.t_new[0]),
    }))
    return 0


def _mode_diagnostics(args) -> int:
    """Synthetic diagnostics on an analytic plasma (reference CLI mode
    "diagnostics", ``run_diagnostics``)."""
    import jax.numpy as jnp

    from scpn_fusion_tpu.core.grid import Grid
    from scpn_fusion_tpu.models.diagnostics.forward import (
        generate_forward_channels,
    )

    n = args.n
    grid = Grid.from_bounds(n, n, 4.0, 8.4, -2.2, 2.2, dtype=np.float32)
    rho = jnp.sqrt(((grid.RR - 6.2) / 2.0) ** 2 + (grid.ZZ / 3.6) ** 2)
    ne = 1e20 * jnp.maximum(1.0 - rho**2, 0.0)
    te = 20.0 * jnp.maximum(1.0 - rho**2, 0.0) ** 1.5
    src = 1e18 * jnp.maximum(1.0 - rho**2, 0.0) ** 2
    chords = jnp.asarray([[[6.2, -2.2], [6.2, 2.2]],
                          [[5.0, -2.2], [5.0, 2.2]]])
    pts = jnp.asarray([[6.2, 0.0], [7.0, 0.0]])
    ch = generate_forward_channels(
        ne_m3=ne, te_kev=te, neutron_source=src, grid=grid, chords=chords,
        thomson_points=pts, ece_channels=pts,
        volume_element_m3=grid.dR * grid.dZ * 2 * np.pi * 6.2)
    print(json.dumps({
        "interferometer_rad": np.asarray(ch.interferometer_rad).tolist(),
        "neutron_rate_hz": float(ch.neutron_rate_hz),
        "thomson_v": np.asarray(ch.thomson_v).tolist(),
    }))
    return 0


def _mode_optimal(args) -> int:
    """Optimal shot-trajectory search (reference CLI mode "optimal",
    ``fusion_optimal_control``): Adam on the differentiable shot objective."""
    import jax.numpy as jnp

    from scpn_fusion_tpu.control.optimal_scenario import (
        OptimizerConfig,
        ShotKnobs,
        optimize_shot,
    )
    from scpn_fusion_tpu.control.scenario import FluxBudget

    budget = FluxBudget(phi_cs_vs=args.flux_vs, l_plasma_uh=7.0,
                        r0_m=args.r0)
    k0 = ShotKnobs(jnp.asarray(args.p_aux), jnp.asarray(args.ne),
                   jnp.asarray(args.ip))
    res = optimize_shot(k0, budget, cfg=OptimizerConfig(n_iters=args.iters))
    hist = np.asarray(res.loss_history)
    print(json.dumps({
        "final_loss": float(hist[-1]),
        "feasible": bool(res.feasible),
        "q_flattop": float(res.q_flattop),
        "p_aux_mw": float(res.knobs.p_aux_flat_mw),
        "ne_1e19": float(res.knobs.ne_flat_19),
        "ip_ma": float(res.knobs.ip_flat_ma),
        "iterations": args.iters,
    }))
    return 0


def _mode_learning(args) -> int:
    """SOC + soft-Q learning runtime (reference CLI mode "learning",
    ``advanced_soc_fusion_learning``)."""
    import jax

    from scpn_fusion_tpu.control.soc_learning import run_soc_learning

    _, summary, _ = run_soc_learning(jax.random.PRNGKey(args.seed),
                                     n_steps=args.steps)
    print(json.dumps({k: float(v) for k, v in summary.items()}))
    return 0


def _mode_digital_twin(args) -> int:
    """Reduced digital twin shot (reference CLI mode "digital-twin")."""
    from scpn_fusion_tpu.control.digital_twin import (
        TwinConfig,
        run_digital_twin,
    )

    _, trace = run_digital_twin(TwinConfig(grid_size=args.n),
                                n_steps=args.steps)
    print(json.dumps({
        "t_core_final": float(np.asarray(trace.t_core)[-1]),
        "max_island_width": float(np.max(np.asarray(trace.island_widths))),
        "max_danger_fraction": float(np.max(np.asarray(
            trace.danger_fraction))),
        "steps": args.steps,
    }))
    return 0


def _mode_control_room(args) -> int:
    """Multi-subsystem control-room session (reference CLI mode
    "control-room")."""
    from scpn_fusion_tpu.control.control_room import (
        render_control_room_report,
        run_control_room_session,
    )

    trace, summary = run_control_room_session(
        steps=args.steps, size=args.n, seed=args.seed)
    if args.report:
        Path(args.report).write_text(
            render_control_room_report(trace, summary))
        print(f"report: {args.report}", file=sys.stderr)
    print(json.dumps({k: (float(v) if isinstance(v, (int, float))
                          or hasattr(v, "item") else v)
                      for k, v in summary.items()}))
    return 0


def _mode_sandpile(args) -> int:
    """SOC sandpile reactor (reference CLI mode "sandpile")."""
    from scpn_fusion_tpu.models.physics.sandpile import (
        SandpileConfig,
        avalanche_statistics,
        run_sandpile,
    )

    trace = run_sandpile(SandpileConfig(n_cells=args.n, n_steps=args.steps),
                         seed=args.seed)
    stats = avalanche_statistics(trace)
    print(json.dumps({k: float(v) for k, v in stats.items()}))
    return 0


def _mode_nuclear(args) -> int:
    """Plasma-wall interaction screen (reference CLI mode "nuclear",
    ``nuclear_wall_interaction``): sputtering/erosion scan on a first-wall
    material."""
    from scpn_fusion_tpu.models.nuclear.pwi import (
        SputteringMaterial,
        erosion_scan,
    )

    mat = SputteringMaterial.from_name(args.material)
    temps, erosion, yields = erosion_scan(
        mat, args.flux, args.t_min, args.t_max, args.n)
    erosion = np.asarray(erosion)
    temps = np.asarray(temps)
    print(json.dumps({
        "material": args.material,
        "peak_erosion_mm_year": float(erosion.max()),
        "t_at_peak_ev": float(temps[int(erosion.argmax())]),
        "threshold_t_ev": float(temps[int(np.argmax(erosion > 0.0))]),
    }))
    return 0


def _mode_geometry(args) -> int:
    """3D geometry / force-balance screen (reference CLI mode "geometry",
    ``geometry_3d``): near-axisymmetric 3D force balance + stellarator
    flux-surface metrics."""
    import jax.numpy as jnp

    from scpn_fusion_tpu.models.equilibrium.force_balance_3d import (
        ForceBalanceConfig,
        Geometry3D,
        solve_force_balance_3d,
    )
    from scpn_fusion_tpu.models.physics.stellarator import (
        effective_ripple,
        w7x_config,
    )

    g = Geometry3D(r_axis=args.r0, a_minor=args.a, kappa=args.kappa,
                   triangularity=args.delta)
    out = solve_force_balance_3d(g, ForceBalanceConfig(
        max_iterations=args.iters))
    eps_eff = effective_ripple(w7x_config(), jnp.asarray(0.5))
    print(json.dumps({
        "initial_residual": float(out.initial_residual),
        "final_residual": float(out.residual),
        "iterations": int(out.iterations),
        "w7x_eps_eff_s0p5": float(eps_eff),
    }))
    return 0


def _mode_neuro_control(args) -> int:
    """Spiking neuro-cybernetic position control (reference CLI mode
    "neuro-control")."""
    import jax

    from scpn_fusion_tpu.control.neuro_cybernetic import (
        run_neuro_cybernetic_shot,
    )

    _, metrics = run_neuro_cybernetic_shot(
        jax.random.PRNGKey(args.seed), n_ticks=args.steps)
    print(json.dumps({k: float(v) for k, v in metrics.items()}))
    return 0


def _mode_neural(args) -> int:
    """Neural surrogate artifact evaluation (reference CLI mode "neural",
    ``neural_equilibrium``): loads the committed surrogate weights and
    reports their pinned training metrics + a fresh forward check."""
    import jax.numpy as jnp

    from scpn_fusion_tpu.models.surrogates.pretrained import (
        load_transport_surrogate,
    )

    predict, metrics = load_transport_surrogate(args.name)
    x = jnp.asarray(np.linspace(0.2, 0.8, 7)[None, :], jnp.float32)
    y = np.asarray(predict(x))
    print(json.dumps({
        "artifact": args.name,
        "forward_finite": bool(np.all(np.isfinite(y))),
        "output_shape": list(y.shape),
        **{k: v for k, v in metrics.items()
           if isinstance(v, (int, float, str))},
    }))
    return 0


def _mode_live_dashboard(args) -> int:
    """Live mission-control dashboard server (reference CLI surface:
    the Streamlit app ``ui/app.py``; here a dependency-free stdlib HTTP
    server with a background compiled-solve worker)."""
    from scpn_fusion_tpu.ui.live_server import serve_live_dashboard

    cfg = None
    if args.config:
        from scpn_fusion_tpu.core.config import load_config

        cfg = load_config(args.config)
    serve_live_dashboard(host=args.host, port=args.port, cfg=cfg,
                         period_s=args.period)
    return 0


def _mode_stellarator_replay(args) -> int:
    """Stellarator control replay benchmark (reference CLI mode
    "stellarator-control-replay-benchmark") — runs the campaign lane."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "validation" / \
        "run_stellarator_lane.py"
    spec = importlib.util.spec_from_file_location("stellarator_lane", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return int(mod.main())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="scpn-fusion-tpu",
        description="JAX-native plasma physics and control framework")
    sub = p.add_subparsers(dest="mode", required=True)

    k = sub.add_parser("kernel", help="fixed-boundary GS solve from config")
    k.add_argument("config")
    k.add_argument("--output", default=None)
    k.set_defaults(fn=_mode_kernel)

    fb = sub.add_parser("free-boundary", help="free-boundary GS solve")
    fb.add_argument("config")
    fb.add_argument("--max-outer", type=int, default=20)
    fb.add_argument("--output", default=None)
    fb.set_defaults(fn=_mode_free_boundary)

    g = sub.add_parser("geqdsk", help="reconstruct from a G-EQDSK file")
    g.add_argument("file")
    g.add_argument("--max-iter", type=int, default=400)
    g.set_defaults(fn=_mode_geqdsk)

    t = sub.add_parser("transport", help="1.5D transport scenario")
    t.add_argument("--steps", type=int, default=200)
    t.add_argument("--dt", type=float, default=0.05)
    t.add_argument("--p-aux", type=float, default=40.0)
    t.set_defaults(fn=_mode_transport)

    f = sub.add_parser("flight-sim", help="closed-loop reduced flight sim")
    f.add_argument("--hz", type=float, default=10000.0)
    f.add_argument("--duration", type=float, default=1.0)
    f.set_defaults(fn=_mode_flight_sim)

    rtb = sub.add_parser(
        "realtime", help="multi-process realtime bus session "
        "(physics/controller/diagnostics nodes)")
    rtb.add_argument("--ticks", type=int, default=400)
    rtb.add_argument("--tick-interval", type=float, default=0.002)
    rtb.set_defaults(fn=_mode_realtime)

    b = sub.add_parser("burn", help="0D burn operating point")
    b.add_argument("--ne19", type=float, default=10.0)
    b.add_argument("--p-aux", type=float, default=50.0)
    b.add_argument("--ip", type=float, default=15.0)
    b.add_argument("--bt", type=float, default=5.3)
    b.add_argument("--r0", type=float, default=6.2)
    b.add_argument("--a", type=float, default=2.0)
    b.add_argument("--kappa", type=float, default=1.7)
    b.set_defaults(fn=_mode_burn)

    v = sub.add_parser("validate", help="run validation campaigns")
    v.add_argument("--campaign", default="equilibrium_parity",
                   help="campaign name (validation/run_<name>.py)")
    v.add_argument("--all", action="store_true",
                   help="run every campaign + regenerate RESULTS.md")
    v.set_defaults(fn=_mode_validate)

    db = sub.add_parser("dashboard",
                        help="regenerate MD+HTML dashboards + manifest")
    db.set_defaults(fn=_mode_dashboard)

    tg = sub.add_parser("tglf", help="native TGLF point evaluation")
    tg.add_argument("--rlti", type=float, default=9.0)
    tg.add_argument("--rlte", type=float, default=6.9)
    tg.add_argument("--rlne", type=float, default=2.2)
    tg.add_argument("--q", type=float, default=1.4)
    tg.add_argument("--s-hat", dest="s_hat", type=float, default=0.8)
    tg.add_argument("--epsilon", type=float, default=0.16)
    tg.add_argument("--te-ti", dest="te_ti", type=float, default=1.0)
    tg.add_argument("--nu-star", dest="nu_star", type=float, default=0.1)
    tg.set_defaults(fn=_mode_tglf)

    sx = sub.add_parser("stress", help="randomized multi-shot campaign")
    sx.add_argument("--shots", type=int, default=100)
    sx.add_argument("--seed", type=int, default=0)
    sx.set_defaults(fn=_mode_stress)

    d = sub.add_parser("design-scan",
                       help="vmapped compact-reactor design search")
    d.add_argument("--samples", type=int, default=2048)
    d.add_argument("--p-aux", type=float, default=50.0)
    d.add_argument("--seed", type=int, default=0)
    d.set_defaults(fn=_mode_design_scan)

    dis = sub.add_parser("disruption",
                         help="staged disruption sequence + SPI scan")
    dis.add_argument("--ip", type=float, default=15.0)
    dis.add_argument("--spi", type=float, default=0.0,
                     help="injected SPI inventory [1e20 m^-3]")
    dis.set_defaults(fn=_mode_disruption)

    st = sub.add_parser("startup", help="breakdown/burn-through screen")
    st.add_argument("--v-loop", type=float, default=20.0)
    st.add_argument("--pressure", type=float, default=None,
                    help="prefill pressure [Pa] (default: Paschen optimum)")
    st.set_defaults(fn=_mode_startup)

    gk = sub.add_parser("gk", help="nonlinear 5D gyrokinetic run")
    gk.add_argument("--steps", type=int, default=100)
    gk.add_argument("--grid", type=int, default=8,
                    help="kx=ky=theta=vpar grid size (mu = grid/2)")
    gk.set_defaults(fn=_mode_gk)

    dv = sub.add_parser("divertor", help="divertor heat exhaust lab")
    dv.add_argument("--p-sol", type=float, default=80.0)
    dv.add_argument("--r0", type=float, default=2.1)
    dv.add_argument("--b-pol", type=float, default=2.5)
    dv.add_argument("--expansion", type=float, default=15.0)
    dv.add_argument("--flow", type=float, default=2.0)
    dv.set_defaults(fn=_mode_divertor)

    br = sub.add_parser("breeding", help="multigroup blanket TBR")
    br.add_argument("--thickness", type=float, default=80.0)
    br.add_argument("--li6", type=float, default=0.9)
    br.set_defaults(fn=_mode_breeding)

    op = sub.add_parser("optimizer", help="compact reactor search")
    op.add_argument("--samples", type=int, default=4096)
    op.add_argument("--seed", type=int, default=0)
    op.set_defaults(fn=_mode_optimizer)

    he = sub.add_parser("heating", help="ECRH deposition")
    he.add_argument("--power", type=float, default=20.0)
    he.add_argument("--te", type=float, default=20.0)
    he.add_argument("--ne", type=float, default=10.0, help="ne [1e19 m^-3]")
    he.set_defaults(fn=_mode_heating)

    wd = sub.add_parser("wdm", help="whole-device-model discharge")
    wd.add_argument("--steps", type=int, default=200)
    wd.set_defaults(fn=_mode_wdm)

    sf = sub.add_parser("safety", help="disruption predictor quick eval")
    sf.add_argument("--seed", type=int, default=0)
    sf.add_argument("--train-steps", type=int, default=1500)
    sf.set_defaults(fn=_mode_safety)

    sw = sub.add_parser("sawtooth", help="Kadomtsev sawtooth crash")
    sw.add_argument("--n", type=int, default=101)
    sw.add_argument("--q0", type=float, default=0.9)
    sw.add_argument("--qa", type=float, default=3.5)
    sw.set_defaults(fn=_mode_sawtooth)

    dg = sub.add_parser("diagnostics", help="synthetic forward diagnostics")
    dg.add_argument("--n", type=int, default=65)
    dg.set_defaults(fn=_mode_diagnostics)

    oc = sub.add_parser("optimal", help="optimal shot-trajectory search")
    oc.add_argument("--p-aux", dest="p_aux", type=float, default=30.0)
    oc.add_argument("--ne", type=float, default=8.0)
    oc.add_argument("--ip", type=float, default=12.0)
    oc.add_argument("--flux-vs", dest="flux_vs", type=float, default=280.0)
    oc.add_argument("--r0", type=float, default=6.2)
    oc.add_argument("--iters", type=int, default=40)
    oc.set_defaults(fn=_mode_optimal)

    lr = sub.add_parser("learning", help="SOC + soft-Q learning runtime")
    lr.add_argument("--steps", type=int, default=2000)
    lr.add_argument("--seed", type=int, default=0)
    lr.set_defaults(fn=_mode_learning)

    dt = sub.add_parser("digital-twin", help="reduced digital twin shot")
    dt.add_argument("--n", type=int, default=32)
    dt.add_argument("--steps", type=int, default=200)
    dt.set_defaults(fn=_mode_digital_twin)

    cr = sub.add_parser("control-room", help="control-room session")
    cr.add_argument("--n", type=int, default=24)
    cr.add_argument("--steps", type=int, default=200)
    cr.add_argument("--seed", type=int, default=42)
    cr.add_argument("--report", default=None)
    cr.set_defaults(fn=_mode_control_room)

    sp = sub.add_parser("sandpile", help="SOC sandpile reactor")
    sp.add_argument("--n", type=int, default=64)
    sp.add_argument("--steps", type=int, default=2000)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=_mode_sandpile)

    nu = sub.add_parser("nuclear", help="plasma-wall interaction screen")
    nu.add_argument("--material", default="Tungsten")
    nu.add_argument("--flux", type=float, default=1e24)
    nu.add_argument("--t-min", dest="t_min", type=float, default=5.0)
    nu.add_argument("--t-max", dest="t_max", type=float, default=200.0)
    nu.add_argument("--n", type=int, default=60)
    nu.set_defaults(fn=_mode_nuclear)

    ge = sub.add_parser("geometry", help="3D geometry / force balance")
    ge.add_argument("--r0", type=float, default=6.2)
    ge.add_argument("--a", type=float, default=2.0)
    ge.add_argument("--kappa", type=float, default=1.6)
    ge.add_argument("--delta", type=float, default=0.3)
    ge.add_argument("--iters", type=int, default=20)
    ge.set_defaults(fn=_mode_geometry)

    nc = sub.add_parser("neuro-control", help="spiking neuro-cybernetic "
                                             "position control")
    nc.add_argument("--steps", type=int, default=200)
    nc.add_argument("--seed", type=int, default=0)
    nc.set_defaults(fn=_mode_neuro_control)

    ne = sub.add_parser("neural", help="neural surrogate artifact eval")
    ne.add_argument("--name", default="neural_transport")
    ne.set_defaults(fn=_mode_neural)

    sr = sub.add_parser("stellarator-replay",
                        help="stellarator control replay benchmark lane")
    sr.set_defaults(fn=_mode_stellarator_replay)

    ld = sub.add_parser("live-dashboard",
                        help="live mission-control dashboard HTTP server")
    ld.add_argument("--host", default="127.0.0.1")
    ld.add_argument("--port", type=int, default=8750)
    ld.add_argument("--config", default=None)
    ld.add_argument("--period", type=float, default=0.5)
    ld.set_defaults(fn=_mode_live_dashboard)

    return p



def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
