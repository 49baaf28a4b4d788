"""Semi-implicit SPAM tests: reference-state balance, linear solver +
quasi-Newton stepping on the Skamarock-Klemp gravity wave
(ref: timesteppers/SI_Newton.h, extrudedmodel.h:2531-3162)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pam_tpu.spam.geometry import ExtrudedGeometry
from pam_tpu.spam.thermo import IdealGasPottemp, ThermoConstants
from pam_tpu.spam.varset import VariableSet
from pam_tpu.spam.tendencies import SpamTendencies
from pam_tpu.spam.testcases import GravityWave, setup_testcase
from pam_tpu.spam import si


def _setup(nx=40, nz=16, perturb=True):
    tc = GravityWave(add_perturbation=perturb)
    zint = np.linspace(0, tc.Lz, nz + 1)
    geom = ExtrudedGeometry.build(nx, zint, tc.Lx, nens=1,
                                  dtype=jnp.float64)
    thermo = IdealGasPottemp(ThermoConstants())
    vs = VariableSet(variant="CE", tracer_names=(), tracer_positive=(),
                     geom=geom, thermo=thermo)
    dens, v, w, geop = setup_testcase(tc, geom, thermo)
    ref = si.build_reference_state(
        geom, thermo, vs, lambda z: tc.refrho_f(z, thermo),
        lambda z: tc.refentropicdensity_f(z, thermo),
        lambda z: np.asarray(tc.refnsq_f(z, thermo)), tc.g)
    J = jnp.asarray
    tend = SpamTendencies(
        geom=geom, varset=vs, thermo=thermo, grav=tc.g,
        force_refstate_hydrostatic_balance=True,
        refdens=J(ref["dens"]), ref_rho_pi=J(ref["rho_pi"]),
        ref_q_pi=J(ref["q_pi"]), ref_rho_di=J(ref["rho_di"]),
        ref_q_di=J(ref["q_di"]), ref_B=J(ref["B"]))
    return tc, geom, thermo, vs, tend, ref, dens, v, w, geop


def test_reference_state_balance():
    """With the perturbation-density recon + ref_B correction, the
    unperturbed reference state is in near-discrete hydrostatic balance
    (the reference's force_refstate_hydrostatic_balance machinery)."""
    tc, geom, th, vs, tend, ref, dens, v, w, geop = _setup(perturb=False)
    _, fv, fw = tend.compute_rhs(dens, v, w, geop, 1.0)
    dzp = float(np.mean(geom.dz_p))
    # physical dw/dt residual (w is a 01-form ~ w*dz)
    assert float(jnp.max(jnp.abs(fw))) / dzp < 1e-3
    # without the reference state: imbalance is ~g-sized (sanity contrast)
    import dataclasses
    tend0 = dataclasses.replace(tend, refdens=None, ref_rho_pi=None,
                                ref_rho_di=None,
                                force_refstate_hydrostatic_balance=False)
    _, _, fw0 = tend0.compute_rhs(dens, v, w, geop, 1.0)
    assert float(jnp.max(jnp.abs(fw0))) > 10 * float(jnp.max(jnp.abs(fw)))


def test_si_stable_beyond_acoustic_cfl_and_conserves():
    """SI at dt 6x beyond the vertical acoustic limit stays stable and
    conserves mass/entropy exactly, energy to ~1e-10."""
    tc, geom, th, vs, tend, ref, dens, v, w, geop = _setup()
    dt = 10.0  # vertical acoustic limit ~ dz/cs = 625/317 ~ 2.0 s
    lin = si.CompressibleVelocityLinearSystem.build(geom, th, vs, ref, dt,
                                                    grav=tc.g)
    step = jax.jit(lambda a, b, c: si.si_step(tend, lin, a, b, c, geop, dt))
    E0 = float(tend.energy(dens, v, w, geop)[0][0])
    m0 = float(dens[0].sum())
    s0 = float(dens[1].sum())
    d_, v_, w_ = dens, v, w
    for _ in range(60):  # 600 s
        d_, v_, w_ = step(d_, v_, w_)
    assert bool(jnp.isfinite(d_).all())
    E1 = float(tend.energy(d_, v_, w_, geop)[0][0])
    assert abs(float(d_[0].sum()) - m0) / m0 < 1e-13
    assert abs(float(d_[1].sum()) - s0) / s0 < 1e-13
    assert abs(E1 - E0) / abs(E0) < 1e-9
    # wave amplitude stays at the linear scale (no spurious growth)
    dzp = float(np.mean(geom.dz_p))
    assert float(jnp.max(jnp.abs(w_))) / dzp < 0.05


@pytest.mark.slow
def test_si_converges_to_explicit():
    """SI solution approaches the explicit SSPRK3 solution as dt -> 0."""
    tc, geom, th, vs, tend, ref, dens, v, w, geop = _setup()
    T = 120.0
    dt_e = 0.25
    step_e = jax.jit(lambda a, b, c: tend.ssprk3_step(a, b, c, geop, dt_e))
    de, ve, we = dens, v, w
    for _ in range(int(T / dt_e)):
        de, ve, we = step_e(de, ve, we)
    wa = np.asarray(we)
    errs = []
    for dt in (1.0, 2.0):
        lin = si.CompressibleVelocityLinearSystem.build(geom, th, vs, ref,
                                                        dt, grav=tc.g)
        step = jax.jit(lambda a, b, c: si.si_step(tend, lin, a, b, c,
                                                  geop, dt))
        d2, v2, w2 = dens, v, w
        for _ in range(int(T / dt)):
            d2, v2, w2 = step(d2, v2, w2)
        wb = np.asarray(w2)
        errs.append(np.linalg.norm(wa - wb) / np.linalg.norm(wa))
    assert errs[0] < 0.05
    assert errs[0] < errs[1]  # smaller dt -> closer to explicit


def test_si_dycore_wrapper():
    """SpamDycore.with_si runs through the coupler-facing timestep."""
    from pam_tpu.core import Coupler
    from pam_tpu.spam.dycore import SpamDycore
    tc = GravityWave()
    nz, nx = 16, 40
    cpl = Coupler(nz=nz, ny=1, nx=nx, nens=1, xlen=tc.Lx, ylen=tc.Lx,
                  dtype=jnp.float64)
    cpl = cpl.add_tracer("water_vapor", "vap", True, True)
    zint = np.linspace(0.0, tc.Lz, nz + 1)
    dyc = SpamDycore.build(cpl, zint, grav=tc.g, variant="MCE_rho")
    ref = si.build_reference_state(
        dyc.geom, dyc.thermo, dyc.varset,
        lambda z: tc.refrho_f(z, dyc.thermo),
        lambda z: tc.refentropicdensity_f(z, dyc.thermo),
        lambda z: np.asarray(tc.refnsq_f(z, dyc.thermo)), tc.g)
    dyc_si = dyc.with_si(ref, dt_si=5.0)
    state = dict(cpl.allocate_state(zint))
    shape = (1, nz, 1, nx)
    zmid = 0.5 * (zint[1:] + zint[:-1])
    rho = np.asarray(tc.refrho_f(zmid, dyc.thermo))
    state["density_dry"] = jnp.asarray(
        np.broadcast_to(0.99 * rho[None, :, None, None], shape).copy())
    state["water_vapor"] = jnp.asarray(
        np.broadcast_to(0.01 * rho[None, :, None, None], shape).copy())
    state["temp"] = jnp.full(shape, tc.T_ref, jnp.float64)
    out = jax.jit(lambda s: dyc_si.timestep(s, 20.0))(state)
    for k in ("density_dry", "temp", "uvel", "wvel", "water_vapor"):
        assert bool(jnp.isfinite(out[k]).all()), k
    # 4 SI substeps of 5 s ran; mass conserved through the coupler
    m0 = float((state["density_dry"] + state["water_vapor"]).sum())
    m1 = float((out["density_dry"] + out["water_vapor"]).sum())
    assert abs(m1 - m0) / m0 < 1e-12


@pytest.mark.slow
def test_pressure_linear_system_matches_velocity_system():
    """The pressure-based solver (the reference DEFAULT linear_system,
    extrudedmodel.h:5059) drives the same SI iteration as the velocity
    solver: both converge to the same step on the gravity wave."""
    tc, geom, th, vs, tend, ref, dens, v, w, geop = _setup()
    dt = 10.0
    linv = si.CompressibleVelocityLinearSystem.build(geom, th, vs, ref, dt,
                                                     grav=tc.g)
    linp = si.CompressiblePressureLinearSystem.build(geom, th, vs, ref, dt)
    # more iterations -> both converge to the same nonlinear solution
    dv, vv, wv = si.si_step(tend, linv, dens, v, w, geop, dt, max_iters=8)
    dp, vp, wp = si.si_step(tend, linp, dens, v, w, geop, dt, max_iters=8)
    scale = float(jnp.max(jnp.abs(vv))) + 1e-30
    assert float(jnp.max(jnp.abs(vv - vp))) / scale < 1e-6
    wscale = float(jnp.max(jnp.abs(wv))) + 1e-30
    assert float(jnp.max(jnp.abs(wv - wp))) / wscale < 1e-5


def test_pressure_si_stable_beyond_acoustic_cfl():
    tc, geom, th, vs, tend, ref, dens, v, w, geop = _setup()
    dt = 10.0
    lin = si.CompressiblePressureLinearSystem.build(geom, th, vs, ref, dt)
    step = jax.jit(lambda a, b, c: si.si_step(tend, lin, a, b, c, geop, dt))
    E0 = float(tend.energy(dens, v, w, geop)[0][0])
    m0 = float(dens[0].sum())
    d_, v_, w_ = dens, v, w
    for _ in range(60):
        d_, v_, w_ = step(d_, v_, w_)
    assert bool(jnp.isfinite(d_).all())
    E1 = float(tend.energy(d_, v_, w_, geop)[0][0])
    assert abs(float(d_[0].sum()) - m0) / m0 < 1e-13
    assert abs(E1 - E0) / abs(E0) < 1e-9
    dzp = float(np.mean(geom.dz_p))
    assert float(jnp.max(jnp.abs(w_))) / dzp < 0.05


def test_pressure_si_3d_bubble():
    """3-D SI: rising bubble on (x, y, z) at dt far beyond the acoustic
    limit — the ndims=2 SI configuration the reference only reaches through
    the pressure system."""
    from pam_tpu.spam.testcases import RisingBubble
    from pam_tpu.spam.extruded3d import Tendencies3D
    tc = RisingBubble()
    nx = ny = 12
    nz = 12
    zint = np.linspace(0, tc.Lz, nz + 1)
    geom = ExtrudedGeometry.build3d(nx, ny, zint, tc.Lx, tc.Lx, 1,
                                    jnp.float64)
    thermo = IdealGasPottemp(ThermoConstants())
    vs = VariableSet(variant="CE", geom=geom, thermo=thermo)
    ref = si.build_reference_state(
        geom, thermo, vs, lambda z: tc.refrho_f(z, thermo),
        lambda z: tc.refentropicdensity_f(z, thermo),
        lambda z: np.asarray(tc.refnsq_f(z, thermo)), tc.g)
    J = jnp.asarray
    tend = Tendencies3D(
        geom=geom, varset=vs, thermo=thermo, grav=tc.g,
        force_refstate_hydrostatic_balance=True,
        refdens=J(ref["dens"]), ref_rho_pi=J(ref["rho_pi"]),
        ref_q_pi=J(ref["q_pi"]), ref_rho_di=J(ref["rho_di"]),
        ref_q_di=J(ref["q_di"]), ref_B=J(ref["B"]))
    from pam_tpu.spam.testcases import setup_testcase_3d
    dens, v, w, geop = setup_testcase_3d(tc, geom, thermo)
    dt = 2.0   # acoustic limit ~ dz/cs = 125/347 ~ 0.36 s
    lin = si.CompressiblePressureLinearSystem.build(geom, thermo, vs, ref,
                                                    dt)
    step = jax.jit(lambda a, b, c: si.si_step(tend, lin, a, b, c, geop, dt))
    m0 = float(dens[0].sum())
    s0 = float(dens[1].sum())
    d_, v_, w_ = dens, v, w
    for _ in range(20):   # 40 s
        d_, v_, w_ = step(d_, v_, w_)
    assert bool(jnp.isfinite(d_).all())
    assert bool(jnp.isfinite(w_).all())
    assert abs(float(d_[0].sum()) - m0) / m0 < 1e-13
    assert abs(float(d_[1].sum()) - s0) / s0 < 1e-13
    # bubble rises: positive w at the (spherical) bubble center column
    wphys = np.asarray(w_)[0] / np.asarray(geom.dz_p)[0][:, None, None]
    assert wphys.max() > 1e-3
    assert wphys.max() < 5.0


@pytest.mark.slow
def test_pressure_gravity_matches_velocity_system():
    """The gravity-aware pressure solver (the stratification-robust
    variant, extrudedmodel.h:3970-4580) converges to the same SI step as
    the velocity solver on the gravity wave."""
    tc, geom, th, vs, tend, ref, dens, v, w, geop = _setup()
    dt = 10.0
    linv = si.CompressibleVelocityLinearSystem.build(geom, th, vs, ref, dt,
                                                     grav=tc.g)
    ling = si.CompressiblePressureGravityLinearSystem.build(geom, th, vs,
                                                            ref, dt)
    dv, vv, wv = si.si_step(tend, linv, dens, v, w, geop, dt, max_iters=8)
    dg, vg, wg = si.si_step(tend, ling, dens, v, w, geop, dt, max_iters=8)
    scale = float(jnp.max(jnp.abs(vv))) + 1e-30
    assert float(jnp.max(jnp.abs(vv - vg))) / scale < 1e-8
    wscale = float(jnp.max(jnp.abs(wv))) + 1e-30
    assert float(jnp.max(jnp.abs(wv - wg))) / wscale < 1e-8


def test_pressure_gravity_si_conserves():
    tc, geom, th, vs, tend, ref, dens, v, w, geop = _setup()
    dt = 10.0
    lin = si.CompressiblePressureGravityLinearSystem.build(geom, th, vs,
                                                           ref, dt)
    step = jax.jit(lambda a, b, c: si.si_step(tend, lin, a, b, c, geop, dt))
    E0 = float(tend.energy(dens, v, w, geop)[0][0])
    m0 = float(dens[0].sum())
    d_, v_, w_ = dens, v, w
    for _ in range(60):
        d_, v_, w_ = step(d_, v_, w_)
    assert bool(jnp.isfinite(d_).all())
    E1 = float(tend.energy(d_, v_, w_, geop)[0][0])
    assert abs(float(d_[0].sum()) - m0) / m0 < 1e-13
    assert abs(E1 - E0) / abs(E0) < 1e-9
    dzp = float(np.mean(geom.dz_p))
    assert float(jnp.max(jnp.abs(w_))) / dzp < 0.05


def test_pressure_gravity_stable_in_stratified_mmf_f32():
    """The coupled supercell-column MMF config at f32/dt=20s: the plain
    pressure solver diverges here (no buoyancy in its operator) while
    pressure_gravity and velocity stay stable — the property the gravity
    variant exists for."""
    import jax
    from pam_tpu.driver.mmf import setup_supercell_mmf
    from pam_tpu.modules import gcm_forcing
    drv, state = setup_supercell_mmf(
        nx=33, ny=1, nz=50, nens=1, xlen=64000.0, ylen=64000.0,
        zlen=20000.0, micro="kessler", dt_gcm=900.0, dt_crm_phys=20.0,
        dycore="spam", dtype=jnp.float32,
        dycore_kwargs={"linear_system": "pressure_gravity"})
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       drv.dt_gcm)
    step = jax.jit(drv.crm_phys_step)
    for _ in range(30):
        state = step(state)
    assert bool(np.isfinite(np.asarray(state["temp"])).all())
    assert bool(np.isfinite(np.asarray(state["wvel"])).all())


def test_two_point_discrete_gradient_si():
    """si_two_point_discrete_gradient (params.h:158 + extrudedmodel.h:
    2086-2172): the exact two-point gradient must stay close to the
    2-point-quadrature SI trajectory and conserve energy at least as well
    over a rising-bubble run."""
    import jax
    from pam_tpu.driver.mmf import setup_supercell_mmf
    kw = dict(nx=16, ny=1, nz=16, nens=1, xlen=32000.0, ylen=64000.0,
              zlen=20000.0, micro="kessler", dt_gcm=1e9, dt_crm_phys=20.0,
              dycore="spam")
    _, state = setup_supercell_mmf(**kw)
    drv_q, _ = setup_supercell_mmf(**kw)
    drv_tp, _ = setup_supercell_mmf(
        **{**kw, "dycore_kwargs": {"si_two_point": True}})
    dq, dtp = drv_q.dycore, drv_tp.dycore
    dens, v, w = dq.coupler_to_dynamics(state)

    from pam_tpu.spam import si as si_mod
    step_q = jax.jit(lambda d, vv, ww: si_mod.si_step(
        dq.tend, dq.si_linsys, d, vv, ww, dq.geop, 20.0, 3, 2))
    step_tp = jax.jit(lambda d, vv, ww: si_mod.si_step(
        dtp.tend, dtp.si_linsys, d, vv, ww, dtp.geop, 20.0, 3, 2,
        two_point=True))
    xq = xtp = (dens, v, w)
    E0q = float(dq.tend.energy(*xq, dq.geop)[0][0])
    for _ in range(20):
        xq = step_q(*xq)
        xtp = step_tp(*xtp)
    for a, b in zip(xq, xtp):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(b).all()
        scale = np.abs(a).max()
        assert np.abs(a - b).max() < 2e-3 * scale, np.abs(a - b).max() / scale
    Eq = float(dq.tend.energy(*xq, dq.geop)[0][0])
    Etp = float(dtp.tend.energy(*xtp, dtp.geop)[0][0])
    # both conserve well; the two-point form must not be worse than 3x
    assert abs(Etp - E0q) <= 3.0 * abs(Eq - E0q) + 1e-7 * abs(E0q), \
        (Etp - E0q, Eq - E0q)


def test_pcr_matches_thomas():
    """Parallel cyclic reduction (ops/tridiag.py) == Thomas scan to
    roundoff on random diagonally-dominant complex systems."""
    from pam_tpu.spam.si import _pcr, _tridiag_real
    rng = np.random.RandomState(7)
    n, b1, b2 = 49, 4, 9
    L = rng.randn(b1, n, b2)
    U = rng.randn(b1, n, b2)
    L[:, 0] = 0.0
    U[:, -1] = 0.0
    D = 4.0 + np.abs(L) + np.abs(U) + rng.rand(b1, n, b2)
    R = rng.randn(b1, n, b2) + 1j * rng.randn(b1, n, b2)
    x_thomas = np.asarray(_tridiag_real(jnp.asarray(L), jnp.asarray(D),
                                        jnp.asarray(U), jnp.asarray(R)))
    x_pcr = np.asarray(jnp.moveaxis(_pcr(
        jnp.moveaxis(jnp.asarray(L, complex), 1, 0),
        jnp.moveaxis(jnp.asarray(D, complex), 1, 0),
        jnp.moveaxis(jnp.asarray(U, complex), 1, 0),
        jnp.moveaxis(jnp.asarray(R), 1, 0)), 0, 1))
    np.testing.assert_allclose(x_pcr, x_thomas, rtol=1e-10, atol=1e-12)
    # residual check
    for i in range(b1):
        for j in range(b2):
            A = np.diag(D[i, :, j]) + np.diag(L[i, 1:, j], -1) + \
                np.diag(U[i, :-1, j], 1)
            r = A @ x_pcr[i, :, j] - R[i, :, j]
            assert np.abs(r).max() < 1e-10


def test_si_monitored_residuals_decrease():
    """si_monitor_convergence parity (SI_Newton.h:52-132): the Newton
    residual norm must drop substantially across iterations, and the
    monitored step must equal the plain si_step."""
    import jax
    from pam_tpu.driver.mmf import setup_supercell_mmf
    from pam_tpu.spam import si as si_mod
    drv, state = setup_supercell_mmf(nx=16, ny=1, nz=12, nens=1,
                                     xlen=32000.0, ylen=64000.0,
                                     zlen=20000.0, micro="kessler",
                                     dt_gcm=1e9, dt_crm_phys=20.0,
                                     dycore="spam")
    d = drv.dycore
    dens, v, w = d.coupler_to_dynamics(state)
    xn, norms = jax.jit(lambda a, b, c: si_mod.si_step_monitored(
        d.tend, d.si_linsys, a, b, c, d.geop, 20.0, 3, 2))(dens, v, w)
    norms = np.asarray(norms)
    assert norms.shape == (4,)
    assert (norms > 0).all()
    # quasi-Newton convergence: two orders of magnitude over 3 iterations
    assert norms[-1] / norms[0] < 1e-2, norms
    ref = jax.jit(lambda a, b, c: si_mod.si_step(
        d.tend, d.si_linsys, a, b, c, d.geop, 20.0, 3, 2))(dens, v, w)
    for a, b in zip(ref, xn):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-11, atol=1e-11)
