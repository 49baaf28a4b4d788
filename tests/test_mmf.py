"""MMF end-to-end: supercell column init + forcing + dycore + sponge +
Kessler, mirroring the mmf_simplified driver loop (driver.cpp:237-272) at a
CI-sized configuration (analog of inputs/ci/input_pamc.yaml scale-down)."""

import numpy as np
import jax
import jax.numpy as jnp

from pam_tpu.driver.mmf import setup_supercell_mmf
from pam_tpu.driver.supercell_column import supercell_init_column
from pam_tpu.core.constants import DEFAULT_CONSTANTS
import pytest


def test_supercell_column_physical():
    zint = np.linspace(0.0, 20000.0, 51)
    col = supercell_init_column(zint, DEFAULT_CONSTANTS)
    # surface conditions: warm, dense, moist; decreasing with height
    assert 1.0 < col["rho_d"][0] < 1.3
    assert 295.0 < col["temp"][0] < 301.0
    assert col["temp"][-1] < 220.0
    assert (np.diff(col["rho_d"]) < 0).all()
    assert col["rho_v"][0] > 0.005 and col["rho_v"][-1] < 1e-4
    # shear profile: -15 m/s at surface to +15 aloft
    assert col["uvel"][0] < -10 and col["uvel"][-1] > 14
    # hydrostatic balance of the integrated column: dp/dz ~ -rho*g
    p = (col["rho_d"] * DEFAULT_CONSTANTS.R_d +
         col["rho_v"] * DEFAULT_CONSTANTS.R_v) * col["temp"]
    dz = np.diff(zint)
    rho_full = col["rho_d"] + col["rho_v"]
    dpdz = np.diff(p) / (0.5 * (dz[:-1] + dz[1:]))
    rho_mid = 0.5 * (rho_full[:-1] + rho_full[1:])
    resid = np.abs(dpdz + rho_mid * DEFAULT_CONSTANTS.grav) / \
        (rho_mid * DEFAULT_CONSTANTS.grav)
    assert resid.max() < 0.02, resid.max()


def test_mmf_supercell_kessler_short_run():
    drv, state = setup_supercell_mmf(nx=16, ny=1, nz=20, nens=1,
                                     xlen=32000.0, ylen=64000.0,
                                     zlen=20000.0, micro="kessler",
                                     dt_gcm=80.0, dt_crm_phys=20.0)
    step = jax.jit(drv.gcm_step)
    s = step(state)
    s = step(s)
    for name in ("density_dry", "uvel", "wvel", "temp", "water_vapor",
                 "cloud_liquid", "precip_liquid"):
        arr = np.asarray(s[name])
        assert np.isfinite(arr).all(), name
    # moisture stays nonnegative
    assert float(jnp.min(s["water_vapor"])) >= 0
    # winds bounded (stable integration)
    assert float(jnp.max(jnp.abs(s["wvel"]))) < 30.0
    assert float(jnp.max(jnp.abs(s["uvel"]))) < 60.0
    # temperature stays physical
    t = np.asarray(s["temp"])
    assert t.min() > 180.0 and t.max() < 330.0


def test_mmf_forcing_keeps_column_near_gcm():
    """With forcing on, the horizontal-mean state stays anchored to the GCM
    column over a GCM step (the MMF contract, gcm_forcing.h:8-17)."""
    drv, state = setup_supercell_mmf(nx=16, ny=1, nz=20, nens=1,
                                     xlen=32000.0, ylen=64000.0,
                                     zlen=20000.0, micro="kessler",
                                     dt_gcm=60.0, dt_crm_phys=20.0)
    s = jax.jit(drv.gcm_step)(state)
    t_mean = np.asarray(jnp.mean(s["temp"], axis=(-2, -1)))[0]
    t_gcm = np.asarray(s["gcm_temp"])[0]
    assert np.abs(t_mean - t_gcm).max() < 5.0


@pytest.mark.slow
def test_mmf_spam_dycore_short_run():
    """PAM-C MMF path: SPAM MCE_rho dycore with the coupled SI integrator
    (CoupledTestCase reference state from coupler ref_* columns,
    extrudedmodel.h:5768-6069; coupled defaults core/params.h:120-165)."""
    drv, state = setup_supercell_mmf(nx=16, ny=1, nz=20, nens=2,
                                     xlen=32000.0, ylen=64000.0,
                                     zlen=20000.0, micro="kessler",
                                     dt_gcm=80.0, dt_crm_phys=20.0,
                                     dycore="spam")
    assert drv.dycore.name == "SPAM++"
    step = jax.jit(drv.gcm_step)
    s = step(state)
    s = step(s)
    for name in ("density_dry", "uvel", "wvel", "temp", "water_vapor",
                 "cloud_liquid", "precip_liquid"):
        assert np.isfinite(np.asarray(s[name])).all(), name
    t = np.asarray(s["temp"])
    assert t.min() > 180.0 and t.max() < 330.0
    assert float(jnp.max(jnp.abs(s["wvel"]))) < 30.0
    # dry mass approximately conserved over the dycore (forcing + micro may
    # move vapor): compare total (dry+vapor) column mass drift per step
    m0 = float(jnp.sum(state["density_dry"] + state["water_vapor"]))
    m1 = float(jnp.sum(s["density_dry"] + s["water_vapor"]))
    assert abs(m1 - m0) / m0 < 1e-2


@pytest.mark.slow
def test_coupled_reference_state_balance():
    """The coupled reference state must be (near-)hydrostatically balanced:
    a broadcast ref column run through the SPAM SI dycore alone stays put
    (w stays small) — the premise of force_refstate_hydrostatic_balance."""
    drv, state = setup_supercell_mmf(nx=8, ny=1, nz=20, nens=1,
                                     xlen=16000.0, ylen=64000.0,
                                     zlen=20000.0, micro="kessler",
                                     dt_gcm=80.0, dt_crm_phys=20.0,
                                     dycore="spam", perturb_seeds=None)
    # strip the temperature perturbation: rebroadcast the pure column
    from pam_tpu.modules.broadcast import broadcast_initial_gcm_column
    state = broadcast_initial_gcm_column(drv.coupler, state)
    s = dict(state)
    for _ in range(3):
        s = drv.dycore.timestep(s, 20.0)
    assert float(jnp.max(jnp.abs(s["wvel"]))) < 0.5
    assert float(jnp.max(jnp.abs(s["temp"] - state["temp"]))) < 1.5


@pytest.mark.slow
def test_mmf_stretched_vertical_grid():
    """MMF on a stretched (tanh vcoords) vertical grid, both dycores —
    the reference's vcoords-file path (driver.cpp:135-170). Regression:
    quadrature rounding at z=0 must not NaN the supercell sounding."""
    from pam_tpu.utils.vertical_levels import tanh_levels
    zint = tanh_levels(20, 0.0, 20000.0)
    for dyc in ("awfl", "spam"):
        drv, state = setup_supercell_mmf(nx=16, ny=1, nz=20, nens=1,
                                         xlen=32000.0, zlen=20000.0,
                                         micro="kessler", dt_gcm=80.0,
                                         dt_crm_phys=20.0, dycore=dyc,
                                         zint=zint)
        s = jax.jit(drv.gcm_step)(state)
        t = np.asarray(s["temp"])
        assert np.isfinite(t).all(), dyc
        assert t.min() > 180.0 and t.max() < 330.0


def test_kessler_ens_chunked_matches_global_when_trivial():
    """ens_chunk = nens must be EXACTLY the global path, and small chunks
    must agree wherever the chunk-local rainsplit equals the global one
    (here: an x-uniform initial state, so every chunk sees the same CFL
    min and the chunked result is bit-identical). The deviation knob is
    documented in KesslerMicro: each chunk's sub-cycle count is its own,
    as each CRM's would be outside the batched implementation."""
    import dataclasses
    from pam_tpu.driver.mmf import setup_supercell_mmf
    from pam_tpu.modules import gcm_forcing

    drv, state = setup_supercell_mmf(nx=8, ny=1, nz=12, nens=4,
                                     xlen=16000.0, ylen=64000.0,
                                     zlen=20000.0, micro="kessler",
                                     dt_gcm=80.0, dt_crm_phys=20.0,
                                     dycore="spam")
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       drv.dt_gcm)
    # make it rain so rainsplit > 1
    pr = np.array(state["precip_liquid"])
    pr[:, 2:8] = 3e-3 * np.asarray(state["density_dry"])[:, 2:8]
    state["precip_liquid"] = jnp.asarray(pr)

    base = drv.micro.timestep(state, 20.0)
    full = dataclasses.replace(drv.micro, ens_chunk=4).timestep(state, 20.0)
    chunked = dataclasses.replace(drv.micro, ens_chunk=2).timestep(state,
                                                                   20.0)
    for k in ("temp", "water_vapor", "cloud_liquid", "precip_liquid",
              "precl"):
        np.testing.assert_array_equal(np.asarray(base[k]),
                                      np.asarray(full[k]), err_msg=k)
        # x-uniform ensemble -> chunk minima == global min -> identical
        np.testing.assert_allclose(np.asarray(base[k]),
                                   np.asarray(chunked[k]), rtol=1e-12,
                                   err_msg=k)


def test_crm_step_ens_microbatched_matches_full():
    """crm_phys_step_microbatched must reproduce the full-ensemble step:
    members are independent CRMs, so sequential chunks change
    nothing except Kessler's batched rainsplit min (per-chunk). With
    micro='none' the equality is exact; with kessler on an x-uniform
    ensemble the chunk minima coincide and it is exact too."""
    from pam_tpu.driver.mmf import setup_supercell_mmf
    from pam_tpu.modules import gcm_forcing

    # (micro="none" is not valid for the coupled SPAM varset — it
    # requires the moist tracers; kessler with qr=0 has rainsplit=1 in
    # every chunk, so the equality below is exact there too)
    for micro in ("kessler",):
        kw = dict(nx=8, ny=1, nz=12, xlen=16000.0, ylen=64000.0,
                  zlen=20000.0, micro=micro, dt_gcm=80.0,
                  dt_crm_phys=20.0, dycore="spam")
        drv_chunk, _ = setup_supercell_mmf(nens=2, **kw)
        drv_full, state = setup_supercell_mmf(nens=4, **kw)
        state = gcm_forcing.compute_gcm_forcing_tendencies(
            drv_full.coupler, state, drv_full.dt_gcm)

        ref = jax.jit(drv_full.crm_phys_step)(state)
        out = jax.jit(lambda s: drv_chunk.crm_phys_step_microbatched(s, 2))(
            state)
        # the AUTO route: a chunk-built driver fed the full ensemble must
        # take the micro-batched path transparently (VERDICT r3 item 5)
        auto = jax.jit(drv_chunk.crm_phys_step)(state)
        for k in ("temp", "water_vapor", "uvel", "wvel", "density_dry"):
            np.testing.assert_allclose(np.asarray(ref[k]),
                                       np.asarray(out[k]), rtol=5e-13,
                                       atol=1e-13, err_msg=(micro, k))
            np.testing.assert_array_equal(np.asarray(out[k]),
                                          np.asarray(auto[k]),
                                          err_msg=("auto", micro, k))
        # the HOST-dispatched route (round 5): same chunk program
        # dispatched per chunk from the host — must equal the in-jit
        # unrolled micro-batch bitwise (identical chunk slices through
        # the identical single-chunk program)
        host = drv_chunk.crm_phys_step_hostchunked(state)
        for k in ("temp", "water_vapor", "uvel", "wvel", "density_dry"):
            np.testing.assert_array_equal(np.asarray(host[k]),
                                          np.asarray(auto[k]),
                                          err_msg=("host", micro, k))
        # run() with mb_mode="host" keeps the state chunked across the
        # GCM loop; one GCM step must match the unrolled driver's run()
        import dataclasses as _dc
        r_ref = _dc.replace(drv_chunk, mb_mode="unrolled").run(state, 80.0)
        r_host = drv_chunk.run(state, 80.0)  # default mb_mode="host"
        for k in ("temp", "water_vapor", "uvel"):
            np.testing.assert_allclose(np.asarray(r_ref[k]),
                                       np.asarray(r_host[k]), rtol=5e-13,
                                       atol=1e-13,
                                       err_msg=("run-host", micro, k))
        # non-multiple ensembles must fail loudly, not reshape-garble
        import pytest as _pytest
        bad = {k: (v[:3] if hasattr(v, "shape") and v.ndim and
                   v.shape[0] == 4 else v) for k, v in state.items()}
        with _pytest.raises(ValueError, match="micro-batching"):
            drv_chunk.crm_phys_step(bad)
        with _pytest.raises(ValueError, match="micro-batching"):
            drv_chunk.crm_phys_step_hostchunked(bad)
        # chunk-of-1 micro-batching must equal an explicit per-member
        # loop (ground truth for the chunk split/concat bookkeeping)
        drv_one, _ = setup_supercell_mmf(nens=1, **kw)
        m16 = jax.jit(lambda s: drv_one.crm_phys_step_microbatched(s, 4))(
            state)
        refs = [jax.jit(drv_one.crm_phys_step)(
            {k: (v[i:i + 1] if hasattr(v, "shape") and v.ndim else v)
             for k, v in state.items()}) for i in range(4)]
        for k in ("temp", "water_vapor", "uvel"):
            want = np.concatenate([np.asarray(r[k]) for r in refs], axis=0)
            np.testing.assert_allclose(np.asarray(m16[k]), want,
                                       rtol=5e-13, atol=1e-13,
                                       err_msg=("per-member", k))


def test_standalone_mmf_yaml_end_to_end(tmp_path):
    """The standalone driver's MMF branch end-to-end from a YAML file:
    config parse -> setup -> MmfDriver.run (per-CRM-step dispatch, round
    5) -> NetCDF writer + callback cadence (driver.cpp:221-272)."""
    import yaml
    from pam_tpu.driver import standalone

    cfg = dict(sim_time=160, crm_nx=8, crm_ny=1, crm_nz=8, nens=2,
               xlen=16000.0, ylen=64000.0, zlen=20000.0, vcoords="uniform",
               dt_gcm=80.0, dt_crm_phys=20.0, micro="kessler",
               dycore="spam", out_freq=80.0,
               out_prefix=str(tmp_path / "mmf_e2e"))
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(cfg))
    loaded = standalone.load_config(str(p))
    state = standalone.run_mmf(loaded, verbose=False)
    assert state is not None
    for k in ("temp", "uvel", "wvel", "water_vapor"):
        assert bool(jnp.isfinite(state[k]).all()), k
    outs = list(tmp_path.glob("mmf_e2e*"))
    assert outs, "no output written"
    # ens_chunk (round 5): nens=4 run as two host-dispatched chunks must
    # match the plain nens=4 run (kessler rainsplit min becomes
    # per-chunk; qr=0 here so it is exact up to fusion reassociation)
    cfg4 = dict(cfg, nens=4, out_freq=-1.0)
    ref4 = standalone.run_mmf(cfg4, verbose=False)
    # with output ON: the writer must carry the FULL ensemble dimension,
    # not the chunk driver's (code-review finding, round 5)
    out4 = standalone.run_mmf(
        dict(cfg4, ens_chunk=2, out_freq=80.0,
             out_prefix=str(tmp_path / "mmf_chunked")), verbose=False)
    chunked_outs = list(tmp_path.glob("mmf_chunked*"))
    assert chunked_outs, "no output written in ens_chunk mode"
    from scipy.io import netcdf_file
    with netcdf_file(str(chunked_outs[0]), "r") as f:
        assert f.dimensions["nens"] == 4
    for k in ("temp", "uvel", "water_vapor"):
        np.testing.assert_allclose(np.asarray(ref4[k]),
                                   np.asarray(out4[k]), rtol=5e-13,
                                   atol=1e-13, err_msg=("ens_chunk", k))
    import pytest as _pytest
    with _pytest.raises(ValueError, match="ens_chunk"):
        standalone.run_mmf(dict(cfg4, ens_chunk=3), verbose=False)
