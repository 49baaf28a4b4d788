"""AWFL dycore oracle test: one ``tendencies`` evaluation of the port vs
the scalar transliteration of the reference kernels (tests/awfl_oracle.py)
at f64 rtol 1e-10 (VERDICT r3 item 2).

Covers everything the port vectorizes: halo assembly (periodic x/y +
hydrostatic-rho / zero-w vertical BCs), characteristic acoustic split,
upwind-selected WENO reconstruction (uniform x/y matrices AND per-level
variable-grid z matrices on a stretched column), FCT positivity limiting
(with limiters actually firing), the port's sharding-invariant seam rule,
flux divergence, and the gravity source — in both the 2-D (ny=1) and 3-D
(ny>1) configurations.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pam_tpu.core import Coupler
from pam_tpu.dycore.awfl import AwflDycore
from pam_tpu.ops import recon_matrices as rm

import awfl_oracle as orc


def _setup(nx, ny, nz, nens, seed=0):
    rng = np.random.default_rng(seed)
    cpl = Coupler(nz=nz, ny=ny, nx=nx, nens=nens, xlen=2000.0 * nx,
                  ylen=2000.0 * max(ny, 1), dtype=jnp.float64)
    cpl = cpl.add_tracer("water_vapor", "Water Vapor", True, True)
    cpl = cpl.add_tracer("puff", "positive puff", True, False)
    cpl = cpl.add_tracer("chi", "signed scalar", False, False)

    # stretched vertical grid -> per-level matrices differ by level
    dzc = 300.0 * (1.0 + 0.35 * np.sin(np.arange(nz)))
    zint = np.concatenate(([0.0], np.cumsum(dzc)))
    state = dict(cpl.allocate_state(zint))

    zmid = 0.5 * (zint[1:] + zint[:-1])
    T = 300.0 - 6.5e-3 * zmid
    p = 1e5 * np.exp(-zmid / 8500.0)
    rho = p / (287.042 * T)
    shape = (nens, nz, ny, nx)
    b = lambda a: np.broadcast_to(a[None, :, None, None], shape).copy()
    # smooth background + structured perturbations + noise (exercises the
    # limiter's smooth AND shock-adjacent weight regimes)
    xs = np.arange(nx) / nx
    state["density_dry"] = jnp.asarray(
        b(rho) * (1.0 + 0.02 * np.sin(2 * np.pi * xs)[None, None, None, :] +
                  0.005 * rng.standard_normal(shape)))
    state["temp"] = jnp.asarray(
        b(T) + 2.0 * np.cos(2 * np.pi * xs)[None, None, None, :] +
        0.5 * rng.standard_normal(shape))
    state["uvel"] = jnp.asarray(10.0 + 5.0 * rng.standard_normal(shape))
    state["vvel"] = jnp.asarray(3.0 * rng.standard_normal(shape))
    state["wvel"] = jnp.asarray(2.0 * rng.standard_normal(shape))
    qv = 0.01 * np.exp(-zmid / 3000.0)
    state["water_vapor"] = jnp.asarray(
        b(qv * rho) * (1.0 + 0.1 * rng.standard_normal(shape)))
    # zero-background puff with sharp blobs -> FCT limiters FIRE (incl.
    # at the periodic seam: one blob touches i=0); zero-mass cells beside
    # a blob see WENO outflow with zero availability
    puff = np.zeros(shape)
    puff[:, nz // 2, :, 0] = 1e-3
    puff[:, nz // 2, :, nx // 2] = 2e-3
    puff[:, nz // 3, :, :] = 1e-4 * rng.random((nens, ny, nx))
    state["puff"] = jnp.asarray(puff * np.asarray(state["density_dry"]))
    state["chi"] = jnp.asarray(0.01 * rng.standard_normal(shape) *
                               np.asarray(state["density_dry"]))

    dyc = AwflDycore.build(cpl, dzc)
    state = dyc.declare_current_profile_as_hydrostatic(state)
    return cpl, dyc, state, dzc


def _run_both(nx, ny, nz, nens, seed):
    cpl, dyc, state, dzc = _setup(nx, ny, nz, nens, seed)
    dyn, tracers = dyc.coupler_to_dynamics(state)
    dt = 30.0

    st_j, tt_j = jax.jit(
        lambda d, t: dyc.tendencies(d, t, t, dt, state))(dyn, tracers)

    # port internal layout (v, nens, ny, nz, nx) -> oracle (v, nz, ny, nx, e)
    to_orc = lambda a: np.transpose(np.asarray(a), (0, 3, 2, 4, 1))
    dyn_o = to_orc(dyn)
    trac_o = to_orc(tracers)
    dz2 = np.broadcast_to(dzc[:, None], (nz, nens)).copy()
    hy_dens = np.transpose(np.asarray(state["hy_dens_cells"]))   # (nz, nens)
    hy_pres = np.transpose(np.asarray(state["hy_pressure_cells"]))
    c = cpl.const
    C = {"gamma_d": c.gamma_d, "C0": c.C0, "grav": c.grav}
    s2c_v, wrl_v = rm.vertical_recon_matrices(
        np.broadcast_to(dzc, (nens, nz)), dyc.ord)
    idl, sigma = rm.weno_ideal_weights(dyc.ord)
    mats = dict(s2c=rm.sten_to_coefs(dyc.ord),
                wrl=rm.weno_lower_sten_to_coefs(dyc.ord),
                c2g=rm.coefs_to_gll_lower(dyc.ord),
                idl=idl, sigma=sigma, vert_s2c=s2c_v, vert_wrl=wrl_v)
    st_o, tt_o = orc.compute_tendencies_oracle(
        dyn_o, trac_o, trac_o, dt, cpl.dx, cpl.dy, dz2, hy_dens, hy_pres,
        list(cpl.tracer_positive), C, mats, seam_rule="uniform")
    return (to_orc(st_j), to_orc(tt_j), st_o, tt_o,
            dict(cpl=cpl, dyc=dyc, state=state, dyn_o=dyn_o, trac_o=trac_o,
                 dt=dt, dz2=dz2, hy=(hy_dens, hy_pres), C=C, mats=mats))


def _assert_close(got, want, what):
    for v in range(got.shape[0]):
        scale = max(1.0, float(np.abs(want[v]).max()))
        np.testing.assert_allclose(got[v], want[v], rtol=1e-10,
                                   atol=1e-10 * scale,
                                   err_msg=f"{what} var {v}")


def test_awfl_tendencies_match_oracle_2d():
    st_j, tt_j, st_o, tt_o, ctx = _run_both(nx=8, ny=1, nz=6, nens=2,
                                            seed=3)
    _assert_close(st_j, st_o, "state tendencies (2-D)")
    _assert_close(tt_j, tt_o, "tracer tendencies (2-D)")
    # the FCT limiter must actually have fired somewhere (else the oracle
    # only certifies the unlimited path)
    _, tt_nofct = orc.compute_tendencies_oracle(
        ctx["dyn_o"], ctx["trac_o"],
        np.full_like(ctx["trac_o"], 1e30),   # unlimited mass availability
        ctx["dt"], ctx["cpl"].dx, ctx["cpl"].dy, ctx["dz2"], *ctx["hy"],
        list(ctx["cpl"].tracer_positive), ctx["C"], ctx["mats"])
    assert np.abs(tt_o - tt_nofct).max() > 0.0, "FCT never fired"


def test_awfl_tendencies_match_oracle_3d():
    st_j, tt_j, st_o, tt_o, _ = _run_both(nx=6, ny=4, nz=5, nens=1, seed=7)
    _assert_close(st_j, st_o, "state tendencies (3-D)")
    _assert_close(tt_j, tt_o, "tracer tendencies (3-D)")


def test_seam_rule_documented_deviation():
    """The port's uniform periodic FCT seam rule vs the reference's
    post-hoc min() reconciliation (Dycore.h:574-579): identical everywhere
    except possibly the seam faces of a tracer whose limiter fires at the
    boundary with seam inflow; the deviation is documented at
    pam_tpu/dycore/awfl.py ``limit``."""
    _, _, _, tt_uni, ctx = _run_both(nx=8, ny=1, nz=6, nens=2, seed=3)
    _, tt_ref = orc.compute_tendencies_oracle(
        ctx["dyn_o"], ctx["trac_o"], ctx["trac_o"], ctx["dt"],
        ctx["cpl"].dx, ctx["cpl"].dy, ctx["dz2"], *ctx["hy"],
        list(ctx["cpl"].tracer_positive), ctx["C"], ctx["mats"],
        seam_rule="reference")
    diff = np.abs(tt_uni - tt_ref)
    # interior cells (not adjacent to the x seam) must be identical
    assert diff[:, :, :, 1:-1, :].max() == 0.0


def test_awfl_full_timestep_matches_oracle():
    """The FULL Dycore::timeStep above the single oracled tendencies
    evaluation (VERDICT r4 item 3d): positivity pre-clamp, the acoustic
    CFL dt and >=2 sub-cycles, and per cycle the 3-stage SSPRK3 with the
    per-stage FCT starting-point bookkeeping (Dycore.h:107-255). The
    coupler conversions on both sides are the port's own (validated by
    the GCM round-trip tests), so the comparison isolates the time loop."""
    cpl, dyc, state, dzc = _setup(nx=8, ny=1, nz=6, nens=2, seed=5)
    c = cpl.const
    C = {"gamma_d": c.gamma_d, "C0": c.C0, "grav": c.grav,
         "R_d": c.R_d, "R_v": c.R_v}
    nz, nens = 6, 2
    dz2 = np.broadcast_to(dzc[:, None], (nz, nens)).copy()
    dt_dyn_o = orc.compute_time_step_oracle(
        *(np.asarray(state[k]) for k in ("density_dry", "uvel", "vvel",
                                         "wvel", "temp", "water_vapor")),
        cpl.dx, cpl.dy, dz2, C, cfl=dyc.cfl)
    dt_dyn_p = float(jax.jit(dyc.compute_time_step)(state))
    np.testing.assert_allclose(dt_dyn_p, dt_dyn_o, rtol=1e-14)
    dt_phys = 2.5 * dt_dyn_o               # forces ncycles >= 2 (here 3)
    assert int(np.ceil(dt_phys / dt_dyn_o)) >= 2

    out = jax.jit(lambda s: dyc.timestep(s, dt_phys))(state)

    dyn, tracers = dyc.coupler_to_dynamics(state)
    to_orc = lambda a: np.transpose(np.asarray(a), (0, 3, 2, 4, 1))
    from_orc = lambda a: jnp.asarray(np.transpose(a, (0, 4, 2, 1, 3)))
    hy_dens = np.transpose(np.asarray(state["hy_dens_cells"]))
    hy_pres = np.transpose(np.asarray(state["hy_pressure_cells"]))
    from pam_tpu.ops import recon_matrices as rm2
    s2c_v, wrl_v = rm2.vertical_recon_matrices(
        np.broadcast_to(dzc, (nens, nz)), dyc.ord)
    idl, sigma = rm2.weno_ideal_weights(dyc.ord)
    mats = dict(s2c=rm2.sten_to_coefs(dyc.ord),
                wrl=rm2.weno_lower_sten_to_coefs(dyc.ord),
                c2g=rm2.coefs_to_gll_lower(dyc.ord),
                idl=idl, sigma=sigma, vert_s2c=s2c_v, vert_wrl=wrl_v)
    dyn_o, trac_o = orc.time_step_oracle(
        to_orc(dyn), to_orc(tracers), dt_phys, dt_dyn_o, cpl.dx, cpl.dy,
        dz2, hy_dens, hy_pres, list(cpl.tracer_positive), C, mats,
        seam_rule="uniform")
    out_o = dyc.dynamics_to_coupler(state, from_orc(dyn_o),
                                    from_orc(trac_o))
    for k in ("density_dry", "uvel", "wvel", "temp", "water_vapor",
              "puff", "chi"):
        a, b = np.asarray(out[k]), np.asarray(out_o[k])
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * scale,
                                   err_msg=f"timestep {k}")
