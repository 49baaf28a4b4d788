"""P3 (Predicted Particle Properties) microphysics main scheme in JAX.

Full port of the reference column Fortran (physics/micro/p3/fortran/
micro_p3.F90: p3_main + parts 1/2/3, process subroutines, DSD helpers,
adaptive-substepping sedimentation, homogeneous freezing) re-designed as
whole-array JAX ops: every per-level branch becomes a mask, the scalar
lookup-table walks become batched gathers (pam_tpu.physics.p3.tables), and
the data-dependent sedimentation substepping runs as ``lax.while_loop``.

Array convention INSIDE this module: (nz, ...batch) with k=0 = model TOP
(E3SM/P3-internal orientation; the coupler wrapper flips) and z the
LEADING axis: the batch axis (ens-minor) is the minor, contiguous one,
and the dycore->column conversion is a layout relabel, not a
transpose. The process
chains (parts 1/2/3, homogeneous freezing) are pointwise and
shape-agnostic; only sedimentation and the wrapper are axis-aware. All
q/n are dry mixing ratios.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .constants import (CONST, QSMALL, NSMALL, MU_R_CONSTANT, MINCLD,
                        INCLOUD_LIMIT, PRECIP_LIMIT, ISIZE, RCOLLSIZE)
from . import tables as tbl

C = CONST


def _gamma(x):
    return jnp.exp(jax.scipy.special.gammaln(x))


def _expm1(x):
    """Accurate exp(x)-1 via Kahan's formula (exp & log only). Matches
    expm1 to ulps for all finite results;
    the overflow branch (exp(x)=inf, x ≳ 709 in f64) is guarded to return
    inf rather than the inf/inf NaN of the raw formula."""
    u = jnp.exp(x)
    um1 = u - 1.0
    return jnp.where(u == 1.0, x,
                     jnp.where(um1 == -1.0, -1.0,
                               jnp.where(jnp.isinf(u), u,
                                         um1 * x / jnp.log(u))))


def _cbrt(x):
    """x**(1/3) for non-negative x (every P3 call site is non-negative);
    ulp-equivalent to jnp.cbrt on [0, inf)."""
    return x ** (1.0 / 3.0)


# --------------------------------------------------------------------- sat
def murphy_koop_svp(t, ice: bool):
    """Saturation vapor pressure [Pa] (wv_sat_scream.F90 MurphyKoop_svp)."""
    logt = jnp.log(t)
    svp_ice = jnp.exp(9.550426 - 5723.265 / t + 3.53068 * logt -
                      0.00728332 * t)
    tmp = (54.842763 - 6763.22 / t - 4.210 * logt + 0.000367 * t +
           jnp.tanh(0.0415 * (t - 218.8)) *
           (53.878 - 1331.22 / t - 9.44523 * logt + 0.014025 * t))
    svp_liq = jnp.exp(tmp)
    if ice:
        return jnp.where(t < C.T_zerodegc, svp_ice, svp_liq)
    return svp_liq


def qv_sat(t, p, ice: bool):
    """Saturation mixing ratio (wv_sat_scream.F90 qv_sat)."""
    e = murphy_koop_svp(t, ice)
    return C.ep_2 * e / jnp.maximum(1.0e-3, p - e)


# ------------------------------------------------------------------- incloud
def incloud_ratios(qc, qr, qi, qm, nc, nr, ni, bm, inv_cl, inv_ci, inv_cr):
    """calculate_incloud_mixingratios (micro_p3_utils.F90:237-295)."""
    okc = qc >= QSMALL
    oki = qi >= QSMALL
    okm = (qm >= QSMALL) & oki
    okr = qr >= QSMALL
    qc_in = jnp.where(okc, qc * inv_cl, 0.0)
    nc_in = jnp.where(okc, jnp.maximum(nc * inv_cl, 0.0), 0.0)
    qi_in = jnp.where(oki, qi * inv_ci, 0.0)
    ni_in = jnp.where(oki, jnp.maximum(ni * inv_ci, 0.0), 0.0)
    qm_in = jnp.where(okm, qm * inv_ci, 0.0)
    bm_in = jnp.where(okm, jnp.maximum(bm * inv_cl, 0.0), 0.0)
    qr_in = jnp.where(okr, qr * inv_cr, 0.0)
    nr_in = jnp.where(okr, jnp.maximum(nr * inv_cr, 0.0), 0.0)
    qc_in = jnp.minimum(qc_in, INCLOUD_LIMIT)
    qi_in = jnp.minimum(qi_in, INCLOUD_LIMIT)
    bm_in = jnp.minimum(bm_in, INCLOUD_LIMIT)
    qr_in = jnp.minimum(qr_in, PRECIP_LIMIT)
    return qc_in, qr_in, qi_in, qm_in, nc_in, nr_in, ni_in, bm_in


# ------------------------------------------------------------------------ dsd
def cloud_dsd(qc, nc, rho):
    """get_cloud_dsd2 (micro_p3.F90:1774-1835). Returns
    (nc_out, mu_c, lamc, cdist, cdist1); nu omitted (iparam=3)."""
    ok = qc >= QSMALL
    nc_ = jnp.maximum(nc, NSMALL)
    mu = 0.0005714 * (nc_ * 1.0e-6 * rho) + 0.2714
    mu = 1.0 / (mu * mu) - 1.0
    mu = jnp.clip(mu, 2.0, 15.0)
    lamc = _cbrt(C.cons1 * nc_ * (mu + 3.0) * (mu + 2.0) * (mu + 1.0) /
                    jnp.maximum(qc, 1e-300))
    lammin = (mu + 1.0) * 2.5e4
    lammax = (mu + 1.0) * 1.0e6
    lamc = jnp.clip(lamc, lammin, lammax)
    clipped = (lamc == lammin) | (lamc == lammax)
    nc_adj = 6.0 * lamc ** 3 * qc / (np.pi * C.rho_h2o * (mu + 3.0) *
                                     (mu + 2.0) * (mu + 1.0))
    nc_ = jnp.where(clipped, nc_adj, nc_)
    cdist = nc_ * (mu + 1.0) / lamc
    cdist1 = nc_ / _gamma(mu + 1.0)
    return (jnp.where(ok, nc_, nc), jnp.where(ok, mu, 0.0),
            jnp.where(ok, lamc, 0.0), jnp.where(ok, cdist, 0.0),
            jnp.where(ok, cdist1, 0.0))


def rain_dsd(qr, nr):
    """get_rain_dsd2 (micro_p3.F90:1839-1893). Returns
    (nr_out, mu_r, lamr, cdistr, logn0r)."""
    ok = qr >= QSMALL
    nr_ = jnp.maximum(nr, NSMALL)
    mu = MU_R_CONSTANT
    lamr = _cbrt(C.cons1 * nr_ * (mu + 3.0) * (mu + 2.0) * (mu + 1.0) /
                    jnp.maximum(qr, 1e-300))
    lammax = (mu + 1.0) * 1.0e5
    lammin = (mu + 1.0) * 500.0
    lamr = jnp.clip(lamr, lammin, lammax)
    clipped = (lamr == lammin) | (lamr == lammax)
    nr_adj = jnp.exp(3.0 * jnp.log(lamr) + jnp.log(jnp.maximum(qr, 1e-300)) +
                     jnp.log(_gamma(mu + 1.0)) -
                     jnp.log(_gamma(mu + 4.0))) / C.cons1
    nr_ = jnp.where(clipped, nr_adj, nr_)
    cdistr = nr_ / _gamma(mu + 1.0)
    logn0r = jnp.log10(jnp.maximum(nr_, 1e-300)) + (mu + 1.0) * \
        jnp.log10(lamr) - jnp.log10(_gamma(mu + 1.0))
    return (jnp.where(ok, nr_, nr), jnp.full_like(qr, mu),
            jnp.where(ok, lamr, 0.0), jnp.where(ok, cdistr, 0.0),
            jnp.where(ok, logn0r, 0.0))


def bulk_rho_rime(qi_tot, qi_rim, bi_rim):
    """calc_bulkRhoRime (micro_p3.F90:1897-1943). Returns
    (qi_rim, bi_rim, rho_rime)."""
    has = bi_rim >= 1.0e-15
    rho = jnp.where(has, qi_rim / jnp.maximum(bi_rim, 1e-300), 0.0)
    lo = rho < C.rho_rimeMin
    hi = rho > C.rho_rimeMax
    rho = jnp.clip(rho, C.rho_rimeMin, C.rho_rimeMax)
    bi = jnp.where(has & (lo | hi), qi_rim / rho, bi_rim)
    qi_r = jnp.where(has, qi_rim, 0.0)
    bi = jnp.where(has, bi, 0.0)
    rho = jnp.where(has, rho, 0.0)
    over = (qi_r > qi_tot) & (rho > 0.0)
    qi_r = jnp.where(over, qi_tot, qi_r)
    bi = jnp.where(over, qi_r / jnp.maximum(rho, 1e-300), bi)
    small = qi_r < QSMALL
    qi_r = jnp.where(small, 0.0, qi_r)
    bi = jnp.where(small, 0.0, bi)
    return qi_r, bi, rho


def impose_max_total_ni(ni, inv_rho):
    """(micro_p3.F90:1947-1969)."""
    dum = C.max_total_ni * inv_rho / jnp.maximum(ni, 1e-300)
    return jnp.where(ni >= 1e-20, ni * jnp.minimum(dum, 1.0), ni)


# -------------------------------------------------------------------- part 1
def p3_main_part1(dt, pres, dpres, dz, nc_nuceat_tend, inv_exner, exner,
                  inv_cl, inv_ci, inv_cr, t_atm, qv, th, qc, nc, qr, nr, qi,
                  ni, qm, bm, nccn_prescribed=None, ccn_mode="prescribed"):
    """(micro_p3.F90 p3_main_part1:363-481).

    ccn_mode: "prescribed" -> nc = max(nc, nccn_prescribed) (:430-432, the
    PAM wrapper default, Microphysics.h:713-714); "const" ->
    nc = nccnst/rho (:435-437); "predict" (nc += nuceat*dt, :433-434)
    raises: its aerosol ice-nucleation companion branch is not ported
    (see the guard below)."""
    lv, ls, lf = C.latent_heat_vapor, C.latent_heat_sublim, C.latent_heat_fusion
    rho = dpres / dz / C.g
    inv_rho = 1.0 / rho
    qv_sat_l = qv_sat(t_atm, pres, False)
    qv_sat_i = qv_sat(t_atm, pres, True)
    sup_i = qv / qv_sat_i - 1.0
    rhofacr = (C.rho_1000mb * inv_rho) ** 0.54
    rhofaci = (C.rho_600mb * inv_rho) ** 0.54
    mu_air = 1.496e-6 * t_atm ** 1.5 / (t_atm + 120.0)
    acn = C.g * C.rho_h2o / (18.0 * mu_air)

    # mass clipping of tiny categories (:417-470)
    clip_c = qc < QSMALL
    qv = jnp.where(clip_c, qv + qc, qv)
    th = jnp.where(clip_c, th - inv_exner * qc * lv * C.inv_cp, th)
    qc = jnp.where(clip_c, 0.0, qc)
    # droplet activation (:430-438). NOTE on "predict" (VERDICT r3 weak-7):
    # under do_predict_nc the reference ALSO takes the aerosol
    # ice-nucleation branch in ice_nucleation (:2594-2607, using
    # ni_activated) and the two-moment ncautr path — neither is ported nor
    # oracle-covered because the PAM wrapper pins
    # p3_predictNc=false/prescribed CCN (Microphysics.h:412-413,713-714).
    # Guard loudly rather than silently running uncovered physics.
    if ccn_mode == "predict":
        raise NotImplementedError(
            "ccn_mode='predict' (p3_predictNc) needs the aerosol "
            "ice-nucleation branch (micro_p3.F90:2594-2607) and the "
            "two-moment autoconversion nc path, which are not ported — "
            "the PAM wrapper never enables them (Microphysics.h:412-413)")
    if ccn_mode == "prescribed":
        nccn = 0.0 if nccn_prescribed is None else nccn_prescribed
        nc_act = jnp.maximum(nc, nccn)
    else:
        nc_act = C.nccnst * inv_rho
    nc = jnp.where(clip_c, 0.0, nc_act)

    clip_r = qr < QSMALL
    qv = jnp.where(clip_r, qv + qr, qv)
    th = jnp.where(clip_r, th - inv_exner * qr * lv * C.inv_cp, th)
    qr = jnp.where(clip_r, 0.0, qr)
    nr = jnp.where(clip_r, 0.0, nr)

    clip_i = (qi < QSMALL) | ((qi < 1e-8) & (sup_i < -0.1))
    qv = jnp.where(clip_i, qv + qi, qv)
    th = jnp.where(clip_i, th - inv_exner * qi * ls * C.inv_cp, th)
    qi = jnp.where(clip_i, 0.0, qi)
    ni = jnp.where(clip_i, 0.0, ni)
    qm = jnp.where(clip_i, 0.0, qm)
    bm = jnp.where(clip_i, 0.0, bm)

    melt_sm = (qi >= QSMALL) & (qi < 1e-8) & (t_atm >= C.T_zerodegc)
    qr = jnp.where(melt_sm, qr + qi, qr)
    th = jnp.where(melt_sm, th - inv_exner * qi * lf * C.inv_cp, th)
    qi = jnp.where(melt_sm, 0.0, qi)
    ni = jnp.where(melt_sm, 0.0, ni)
    qm = jnp.where(melt_sm, 0.0, qm)
    bm = jnp.where(melt_sm, 0.0, bm)

    t_atm = th * exner
    inc = incloud_ratios(qc, qr, qi, qm, nc, nr, ni, bm, inv_cl, inv_ci,
                         inv_cr)
    return dict(rho=rho, inv_rho=inv_rho, qv_sat_l=qv_sat_l,
                qv_sat_i=qv_sat_i, sup_i=sup_i, rhofacr=rhofacr,
                rhofaci=rhofaci, acn=acn, t=t_atm, qv=qv, th=th, qc=qc,
                nc=nc, qr=qr, nr=nr, qi=qi, ni=ni, qm=qm, bm=bm, inc=inc)


# -------------------------------------------------------------------- part 2
# Names and order of the table-stage outputs consumed by the pointwise
# core (the contract between _part2_tables and _part2_core)
_PART2_TV_NAMES = (
    "mu_r", "lamr", "cdistr", "logn0r", "nr_in_dsd", "nr_in_t", "ni_in_t",
    "qm_in2", "bm_in2", "tv_qi_fallspd", "tv_ni_selfcol", "tv_qc2qi_col",
    "tv_qi2qr_melt", "tv_ni_lammax", "tv_ni_lammin", "tv_qi2qr_vent",
    "tv_nr_col", "tv_qr2qi_col", "revap_val",
    "nc_in_dsd", "mu_c", "lamc", "cdist", "cdist1", "gam_mur2",
    "gam_mur4", "gam_mur7")


def _part2_tables(st):
    """Stage A of p3_main_part2: everything whose outputs feed the lookup
    tables (DSD precursors, index walks) plus the three batched table
    contractions and the revap interpolation. All remaining part2 work is
    pointwise and lives in :func:`_part2_core`.
    Returns a dict keyed by _PART2_TV_NAMES."""
    ice_tab, coll_tab = (jnp.asarray(a) for a in tbl.load_ice_tables())
    qc_in, qr_in, qi_in, qm_in, nc_in, nr_in, ni_in, bm_in = st["inc"]
    inv_rho = st["inv_rho"]

    nr_in_dsd, mu_r, lamr, cdistr, logn0r = rain_dsd(qr_in, nr_in)
    nc_in_dsd, mu_c, lamc, cdist, cdist1 = cloud_dsd(qc_in, nc_in,
                                                     st["rho"])
    # rain-DSD gamma factors (mu_r is the v4 constant; arrays so the
    # pointwise core stays gamma-free)
    gam_mur2 = _gamma(mu_r + 2.0)
    gam_mur4 = _gamma(mu_r + 4.0)
    gam_mur7 = _gamma(7.0 + mu_r)
    ni_in_t = impose_max_total_ni(ni_in, inv_rho)
    has_i = qi_in >= QSMALL
    ni_in_t = jnp.where(has_i, jnp.maximum(ni_in_t, NSMALL), ni_in_t)
    nr_in_t = jnp.where(has_i, jnp.maximum(nr_in_dsd, NSMALL), nr_in_dsd)
    qm_in2, bm_in2, rhop = bulk_rho_rime(qi_in, qm_in, bm_in)
    qm_in_idx = jnp.where(has_i, qm_in2, qm_in)

    dumi, dumjj, dumii, dum1, dum4, dum5 = tbl.indices_1a(
        jnp.maximum(qi_in, 1e-300), jnp.maximum(ni_in_t, NSMALL),
        qm_in_idx, rhop)
    # all 7 ice-table entries read at the same fractional position in ONE
    # batched contraction (1-based table indices 2,3,4,5,7,8,10)
    (tv_qi_fallspd, tv_ni_selfcol, tv_qc2qi_col, tv_qi2qr_melt,
     tv_ni_lammax, tv_ni_lammin, tv_qi2qr_vent) = (
        jnp.where(has_i, v, 0.0) for v in tbl.access_ice_table_multi(
            ice_tab, (1, 2, 3, 4, 6, 7, 9), dum1, dum4, dum5))
    dumj, dum3 = tbl.indices_1b(qr_in, nr_in_t)
    has_ir = has_i & (qr_in >= QSMALL)
    tv_nr_col, tv_qr2qi_col = (
        jnp.where(has_ir, v, 0.0) for v in tbl.access_collect_table_multi(
            coll_tab, (0, 1), dum1, dum3, dum4, dum5))

    # rain-evap ventilation table (:2358-2410)
    safe_l = jnp.maximum(lamr, 1e-300)
    dumii3, dumjj3, rdumii3, rdumjj3 = tbl.indices_3(mu_r, safe_l)
    vn_t, vm_t, revap_t = (jnp.asarray(a) for a in tbl.build_rain_tables())
    revap_val = tbl.access_rain_table(revap_t, dumii3, dumjj3, rdumii3,
                                      rdumjj3)
    loc = locals()
    return {k: loc[k] for k in _PART2_TV_NAMES}


def _part2_core(dt, pres, inv_exner, cld_frac_l, cld_frac_i, cld_frac_r,
                inv_cl, inv_ci, inv_cr, qv_prev, t_prev, st, tv,
                ccn_mode="prescribed"):
    """Stage B of p3_main_part2: the ENTIRE process-rate / conservation /
    prognostic-update chain — purely pointwise (no reductions, stencils or
    table gathers). ``tv`` is _part2_tables' output dict."""
    inv_dt = 1.0 / dt
    lv, ls, lf = C.latent_heat_vapor, C.latent_heat_sublim, C.latent_heat_fusion

    t = st["t"]
    rho, inv_rho = st["rho"], st["inv_rho"]
    qv, th = st["qv"], st["th"]
    qc, nc, qr, nr = st["qc"], st["nc"], st["qr"], st["nr"]
    qi, ni, qm, bm = st["qi"], st["ni"], st["qm"], st["bm"]
    qv_sat_l, qv_sat_i, sup_i = st["qv_sat_l"], st["qv_sat_i"], st["sup_i"]
    rhofaci, acn = st["rhofaci"], st["acn"]
    qc_in, qr_in, qi_in, qm_in, nc_in, nr_in, ni_in, bm_in = st["inc"]
    mu_r, lamr = tv["mu_r"], tv["lamr"]
    cdistr, logn0r = tv["cdistr"], tv["logn0r"]
    revap_val = tv["revap_val"]
    tv_qi_fallspd, tv_ni_selfcol = tv["tv_qi_fallspd"], tv["tv_ni_selfcol"]
    tv_qc2qi_col, tv_qi2qr_melt = tv["tv_qc2qi_col"], tv["tv_qi2qr_melt"]
    tv_ni_lammax, tv_ni_lammin = tv["tv_ni_lammax"], tv["tv_ni_lammin"]
    tv_qi2qr_vent = tv["tv_qi2qr_vent"]
    tv_nr_col, tv_qr2qi_col = tv["tv_nr_col"], tv["tv_qr2qi_col"]

    # time/space physical variables (:3538-3585)
    mu = 1.496e-6 * t ** 1.5 / (t + 120.0)
    dv = 8.794e-5 * t ** 1.81 / pres
    sc = mu / (rho * dv)
    dum = 1.0 / (C.rv * t * t)
    dqsdt = lv * qv_sat_l * dum
    dqsidt = ls * qv_sat_i * dum
    ab = 1.0 + dqsdt * lv * C.inv_cp
    abi = 1.0 + dqsidt * ls * C.inv_cp
    kap = 1.414e3 * mu
    eii = jnp.where(t < 253.15, 0.001,
                    jnp.where(t < 273.15,
                              0.001 + (t - 253.15) * (0.3 - 0.001) / 20.0,
                              0.3))

    # DSDs (:626-632) — computed in _part2_tables
    nc_in = tv["nc_in_dsd"]
    mu_c, lamc = tv["mu_c"], tv["lamc"]
    cdist, cdist1 = tv["cdist"], tv["cdist1"]
    nc = jnp.where(qc_in >= QSMALL, nc_in * cld_frac_l, nc)
    nr = jnp.where(qr_in >= QSMALL, tv["nr_in_dsd"] * cld_frac_r, nr)

    has_i = qi_in >= QSMALL
    has_ir = has_i & (qr_in >= QSMALL)
    nr_in = tv["nr_in_t"]
    ni_in = tv["ni_in_t"]
    qm_in = jnp.where(has_i, tv["qm_in2"], qm_in)
    bm_in = jnp.where(has_i, tv["bm_in2"], bm_in)
    qm = jnp.where(has_i, qm_in * cld_frac_i, qm)
    bm = jnp.where(has_i, bm_in * cld_frac_i, bm)
    # lambda limiters on ni (:677-678)
    ni_in = jnp.where(has_i, jnp.minimum(ni_in, tv_ni_lammax * ni_in), ni_in)
    ni_in = jnp.where(has_i, jnp.maximum(ni_in, tv_ni_lammin * ni_in), ni_in)

    frz = t <= C.T_zerodegc
    # --- ice_cldliq_collection (:2054-2100)
    both_ci = has_i & (qc_in >= QSMALL)
    col_base = rhofaci * tv_qc2qi_col * C.eci * rho * ni_in
    qccol = jnp.where(both_ci & frz, col_base * qc_in, 0.0)
    nc_collect = jnp.where(both_ci, col_base * nc_in, 0.0)
    qc2qr_ice_shed = jnp.where(both_ci & ~frz, col_base * qc_in, 0.0)
    ncshdc = jnp.where(both_ci & ~frz, qc2qr_ice_shed * C.inv_dropmass, 0.0)

    # --- ice_rain_collection (:2103-2157)
    base_r = rho * rhofaci * C.eri * ni_in
    qrcol = jnp.where(has_ir & frz,
                      10.0 ** (tv_qr2qi_col + logn0r) * base_r, 0.0)
    nr_collect = jnp.where(has_ir, 10.0 ** (tv_nr_col + logn0r) * base_r, 0.0)

    # --- ice_self_collection (:2159-2207)
    fr = qm_in / jnp.maximum(qi_in, 1e-300)
    eii_fact = jnp.where(qm_in > 0.0,
                         jnp.where(fr < 0.6, 1.0,
                                   jnp.where(fr < 0.9,
                                             1.0 - (fr - 0.6) / 0.3, 0.0)),
                         1.0)
    ni_selfcollect = jnp.where(has_i, tv_ni_selfcol * rho * eii * eii_fact *
                               rhofaci * ni_in * ni_in, 0.0)

    # --- ice_melting (:2211-2256)
    qsat0 = qv_sat(jnp.full_like(t, C.T_zerodegc), pres, False)
    vent = tv_qi2qr_melt + tv_qi2qr_vent * _cbrt(sc) * \
        jnp.sqrt(rhofaci * rho / mu)
    melt = has_i & (t > C.T_zerodegc)
    qi2qr_melt = jnp.where(melt, jnp.maximum(
        vent * ((t - C.T_zerodegc) * kap - rho * lv * dv * (qsat0 - qv)) *
        2.0 * np.pi / lf * ni_in, 0.0), 0.0)
    ni2nr_melt = jnp.where(melt, qi2qr_melt *
                           (ni_in / jnp.maximum(qi_in, 1e-300)), 0.0)

    # --- ice_cldliq_wet_growth (:2259-2319)
    wet_act = has_i & ((qc_in + qr_in) >= 1e-6) & (t < C.T_zerodegc)
    qwgrth = jnp.where(wet_act, jnp.maximum(
        vent * 2.0 * np.pi * (rho * lv * dv * (qsat0 - qv) -
                              (t - C.T_zerodegc) * kap) /
        (lf + C.cpw * (t - C.T_zerodegc)) * ni_in, 0.0), 0.0)
    dum_w = jnp.maximum(0.0, (qccol + qrcol) - qwgrth)
    shed = wet_act & (dum_w >= 1e-10)
    nr_ice_shed = jnp.where(shed, dum_w * 1.923e6, 0.0)
    big = shed & ((qccol + qrcol) >= 1e-10)
    dum1_w = 1.0 / jnp.maximum(qccol + qrcol, 1e-300)
    qc2qr_ice_shed = jnp.where(big, qc2qr_ice_shed + dum_w * qccol * dum1_w,
                               qc2qr_ice_shed)
    qccol = jnp.where(big, jnp.maximum(0.0, qccol - dum_w * qccol * dum1_w),
                      qccol)
    qrcol = jnp.where(big, jnp.maximum(0.0, qrcol - dum_w * qrcol * dum1_w),
                      qrcol)
    log_wetgrowth = shed

    # --- calc_ice_relaxation_timescale (:2322-2355)
    eps_act = has_i & (t < C.T_zerodegc)
    epsi = jnp.where(eps_act, vent * 2.0 * np.pi * rho * dv * ni_in, 0.0)
    epsi_tot = epsi

    # --- calc_rime_density (:2413-2490)
    rimed = (qccol >= QSMALL) & (t < C.T_zerodegc)
    vtrmi1 = jnp.where(rimed, tv_qi_fallspd * rhofaci, 0.0)
    iTc = 1.0 / jnp.minimum(-0.001, t - C.T_zerodegc)
    # Gamma(mu_c+6)/Gamma(mu_c+4) == (mu_c+5)(mu_c+4) exactly (bcn=2),
    # so the pointwise core needs no lgamma
    vt_qc = acn * (mu_c + 5.0) * (mu_c + 4.0) / \
        jnp.maximum(lamc, 1e-300) ** C.bcn
    d_c = (mu_c + 4.0) / jnp.maximum(lamc, 1e-300)
    v_imp = jnp.abs(vtrmi1 - vt_qc)
    Ri = jnp.clip(-0.5e6 * d_c * v_imp * iTc, 1.0, 12.0)
    rho_rime_c = jnp.where(Ri <= 8.0,
                           (0.051 + 0.114 * Ri - 0.0055 * Ri * Ri) * 1000.0,
                           611.0 + 72.25 * (Ri - 8.0))
    rho_qm_cloud = jnp.where(rimed & (qc_in >= QSMALL), rho_rime_c, 400.0)

    # --- cldliq_immersion_freezing (:2504-2538)
    imm_c = (qc_in >= QSMALL) & (t <= C.T_rainfrz)
    dum_if = jnp.exp(C.aimm * (C.T_zerodegc - t))
    dum2_if = (1.0 / jnp.maximum(lamc, 1e-300)) ** 3
    # cdist1*Gamma(7+mu_c) == nc_in * prod_{k=1..6}(mu_c+k) exactly
    # (cdist1 = nc_in/Gamma(mu_c+1)); likewise for Gamma(mu_c+4)
    poly6 = ((mu_c + 1.0) * (mu_c + 2.0) * (mu_c + 3.0) *
             (mu_c + 4.0) * (mu_c + 5.0) * (mu_c + 6.0))
    poly3 = (mu_c + 1.0) * (mu_c + 2.0) * (mu_c + 3.0)
    qc2qi_hetero = jnp.where(imm_c, C.cons6 * nc_in * poly6 *
                             dum_if * dum2_if ** 2, 0.0)
    nc2ni_immers = jnp.where(imm_c, C.cons5 * nc_in * poly3 *
                             dum_if * dum2_if, 0.0)

    # --- rain_immersion_freezing (:2540-2573)
    imm_r = (qr_in >= QSMALL) & (t <= C.T_rainfrz)
    safe_l = jnp.maximum(lamr, 1e-300)
    safe_cd = jnp.maximum(cdistr, 1e-300)
    qr2qi_immers = jnp.where(imm_r, C.cons6 * jnp.exp(
        jnp.log(safe_cd) + jnp.log(tv["gam_mur7"]) -
        6.0 * jnp.log(safe_l)) * dum_if, 0.0)
    nr2ni_immers = jnp.where(imm_r, C.cons5 * jnp.exp(
        jnp.log(safe_cd) + jnp.log(tv["gam_mur4"]) -
        3.0 * jnp.log(safe_l)) * dum_if, 0.0)

    # --- rain evaporation (:2358-2410, 3383-3536); revap_val from stage A
    has_r = qr_in >= QSMALL
    epsr = jnp.where(has_r, 2.0 * np.pi * cdistr * rho * dv *
                     (C.f1r * tv["gam_mur2"] / safe_l +
                      C.f2r * jnp.sqrt(rho / mu) * _cbrt(sc) * revap_val),
                     0.0)
    epsc = jnp.where(qc_in >= QSMALL, 2.0 * np.pi * rho * dv * cdist, 0.0)
    del epsc  # (qc condensation handled by macrophysics; kept for parity)

    ssat_r = qv - qv_sat_l
    cld_frac = jnp.where(qc_in + qi_in < 1e-6, 0.0, cld_frac_l)
    evap_act = (cld_frac_r > cld_frac) & (ssat_r < 0.0) & has_r
    cold = t < 273.15
    eps_eff = jnp.where(cold, epsr + epsi_tot *
                        (1.0 + ls * C.inv_cp * dqsdt) / abi, epsr)
    eps_eff = jnp.maximum(1e-20, eps_eff)
    tau_eff = 1.0 / eps_eff
    A_c = (qv - qv_prev) * inv_dt - dqsdt * (t - t_prev) * inv_dt
    A_c = jnp.where(cold, A_c - (qv_sat_l - qv_sat_i) *
                    (1.0 + ls * C.inv_cp * dqsdt) / abi * epsi_tot, A_c)
    tiny_r = (qr_in < 1e-12) & (qv / qv_sat_l < 0.999)
    dt_tau = dt / tau_eff
    tsw = -_expm1(-dt_tau) / dt_tau
    tau_r = 1.0 / jnp.maximum(epsr, 1e-300)
    equil = -A_c / ab * tau_eff / tau_r
    instant = -ssat_r / (ab * tau_r)
    qr2qv_evap = jnp.where(tiny_r, qr_in * inv_dt,
                           instant * tsw + equil * (1.0 - tsw))
    qr2qv_evap = jnp.minimum(qr2qv_evap, -ssat_r * inv_dt / ab)
    qr2qv_evap = jnp.maximum(0.0, qr2qv_evap)
    qr2qv_evap = jnp.minimum(qr2qv_evap, qr_in * inv_dt)
    qr2qv_evap = qr2qv_evap * (cld_frac_r - cld_frac) / \
        jnp.maximum(cld_frac_r, MINCLD)
    qr2qv_evap = jnp.where(evap_act, qr2qv_evap, 0.0)
    nr_evap = jnp.where(evap_act, qr2qv_evap *
                        (nr_in / jnp.maximum(qr_in, 1e-300)), 0.0)

    # --- ice_deposition_sublimation (:3268-3333)
    qi_tend_ds = jnp.minimum(epsi / abi, inv_dt) * (qv - qv_sat_i)
    has_i2 = qi_in > QSMALL
    qi2qv_sublim = jnp.where(has_i2 & (qi_tend_ds < 0.0), -qi_tend_ds, 0.0)
    ni_sublim = jnp.where(has_i2 & (qi_tend_ds < 0.0), qi2qv_sublim *
                          (ni_in / jnp.maximum(qi_in, 1e-300)), 0.0)
    qidep = jnp.where(has_i2 & frz & (qi_tend_ds >= 0.0), qi_tend_ds, 0.0)
    qiberg = jnp.where(has_i2 & frz, jnp.maximum(
        epsi / abi * (qv_sat_l - qv_sat_i), 0.0), 0.0)

    # --- ice_nucleation (:2576-2618)  (non-predicted-nc branch: Cooper 1986)
    nuc = (t < C.T_icenuc) & (sup_i >= 0.05)
    dum_n = 0.005 * jnp.exp(0.304 * (C.T_zerodegc - t)) * 1000.0 * inv_rho
    dum_n = jnp.minimum(dum_n, 100.0e3 * inv_rho)
    N_nuc = jnp.maximum(0.0, (dum_n - ni) * inv_dt)
    ni_nucleat = jnp.where(nuc & (N_nuc >= 1e-20), N_nuc, 0.0)
    qinuc = jnp.where(nuc & (N_nuc >= 1e-20),
                      jnp.maximum(0.0, (dum_n - ni) * C.mi0 * inv_dt), 0.0)

    # --- cloud_water_autoconversion (KK2000, :2750-2784)
    auto = qc_in >= 1e-8
    qc2qr_auto = jnp.where(auto, 1350.0 * qc_in ** 2.47 *
                           (nc_in * 1e-6 * rho) ** (-1.79), 0.0)
    ncautr = jnp.where(auto, qc2qr_auto * C.cons3, 0.0)
    nc2nr_auto = jnp.where(auto, qc2qr_auto * nc_in /
                           jnp.maximum(qc_in, 1e-300), 0.0)

    # --- droplet_self_collection (iparam=3 -> 0, :2646-2648)
    nc_selfcollect = jnp.zeros_like(qc)

    # --- cloud_rain_accretion (KK2000, :2689-2695)
    accr = (qr_in >= QSMALL) & (qc_in >= QSMALL)
    qc2qr_accret = jnp.where(accr, 67.0 * (qc_in * qr_in) ** 1.15, 0.0)
    nc_accret = jnp.where(accr, qc2qr_accret * nc_in /
                          jnp.maximum(qc_in, 1e-300), 0.0)

    # --- rain_self_collection (:2705-2747)
    rsc = qr_in >= QSMALL
    dum2_rsc = _cbrt(qr_in / (np.pi * C.rho_h2o *
                                 jnp.maximum(nr_in, 1e-300)))
    dum_rsc = jnp.where(dum2_rsc < 280e-6, 1.0,
                        2.0 - jnp.exp(2300.0 * (dum2_rsc - 280e-6)))
    nr_selfcollect = jnp.where(rsc, dum_rsc * 5.78 * nr_in * qr_in * rho, 0.0)

    # --- back_to_cell_average (:2786-2854)
    ir = jnp.minimum(cld_frac_i, cld_frac_r)
    il = jnp.minimum(cld_frac_i, cld_frac_l)
    lr = jnp.minimum(cld_frac_l, cld_frac_r)
    qc2qr_accret = qc2qr_accret * lr
    qr2qv_evap = qr2qv_evap * cld_frac_r
    qc2qr_auto = qc2qr_auto * cld_frac_l
    nc_accret = nc_accret * lr
    nc_selfcollect = nc_selfcollect * cld_frac_l
    nc2nr_auto = nc2nr_auto * cld_frac_l
    nr_selfcollect = nr_selfcollect * cld_frac_r
    nr_evap = nr_evap * cld_frac_r
    ncautr = ncautr * lr
    qi2qv_sublim = qi2qv_sublim * cld_frac_i
    nr_ice_shed = nr_ice_shed * il
    qc2qi_hetero = qc2qi_hetero * il
    qrcol = qrcol * ir
    qc2qr_ice_shed = qc2qr_ice_shed * il
    qi2qr_melt = qi2qr_melt * cld_frac_i
    qccol = qccol * il
    qr2qi_immers = qr2qi_immers * cld_frac_r
    ni2nr_melt = ni2nr_melt * cld_frac_i
    nc_collect = nc_collect * il
    ncshdc = ncshdc * il
    nc2ni_immers = nc2ni_immers * cld_frac_l
    nr_collect = nr_collect * ir
    ni_selfcollect = ni_selfcollect * cld_frac_i
    qidep = qidep * cld_frac_i
    nr2ni_immers = nr2ni_immers * cld_frac_r
    ni_sublim = ni_sublim * cld_frac_i
    qiberg = qiberg * il

    # --- conservation limiters (:3028-3102, 2957-3026, 2856-2955)
    sinks = (qc2qr_auto + qc2qr_accret + qccol + qc2qi_hetero +
             qc2qr_ice_shed + qiberg) * dt
    lim = (sinks > qc) & (sinks >= 1e-20)
    ratio = jnp.where(lim, qc / jnp.maximum(sinks, 1e-300), 1.0)
    qc2qr_auto = qc2qr_auto * ratio
    qc2qr_accret = qc2qr_accret * ratio
    qccol = qccol * ratio
    qc2qi_hetero = qc2qi_hetero * ratio
    qc2qr_ice_shed = qc2qr_ice_shed * ratio
    qiberg = qiberg * ratio
    liqpresent = qc > 1e-20
    qidep = jnp.where(liqpresent, qidep * (1.0 - ratio), qidep)
    qi2qv_sublim = jnp.where(liqpresent, qi2qv_sublim * (1.0 - ratio),
                             qi2qv_sublim)

    sinks = (qr2qv_evap + qrcol + qr2qi_immers) * dt
    sources = qr + (qc2qr_auto + qc2qr_accret + qi2qr_melt +
                    qc2qr_ice_shed) * dt
    lim = (sinks > sources) & (sinks >= 1e-20)
    ratio = jnp.where(lim, sources / jnp.maximum(sinks, 1e-300), 1.0)
    qr2qv_evap = qr2qv_evap * ratio
    qrcol = qrcol * ratio
    qr2qi_immers = qr2qi_immers * ratio

    sinks = (qi2qv_sublim + qi2qr_melt) * dt
    sources = qi + (qidep + qinuc + qrcol + qccol + qr2qi_immers +
                    qc2qi_hetero + qiberg) * dt
    lim = (sinks > sources) & (sinks >= 1e-20)
    ratio = jnp.where(lim, sources / jnp.maximum(sinks, 1e-300), 1.0)
    qi2qv_sublim = qi2qv_sublim * ratio
    qi2qr_melt = qi2qr_melt * ratio

    sink_nc = (nc_collect + nc2ni_immers + nc_accret + nc2nr_auto) * dt
    source_nc = nc + nc_selfcollect * dt
    ratio = jnp.where(sink_nc > source_nc,
                      source_nc / jnp.maximum(sink_nc, 1e-300), 1.0)
    nc_collect = nc_collect * ratio
    nc2ni_immers = nc2ni_immers * ratio
    nc_accret = nc_accret * ratio
    nc2nr_auto = nc2nr_auto * ratio

    sink_nr = (nr_collect + nr2ni_immers + nr_selfcollect + nr_evap) * dt
    source_nr = nr + (ni2nr_melt * C.nmltratio + nr_ice_shed + ncshdc +
                      nc2nr_auto) * dt
    ratio = jnp.where(sink_nr > source_nr,
                      source_nr / jnp.maximum(sink_nr, 1e-300), 1.0)
    nr_collect = nr_collect * ratio
    nr2ni_immers = nr2ni_immers * ratio
    nr_selfcollect = nr_selfcollect * ratio
    nr_evap = nr_evap * ratio

    sink_ni = (ni2nr_melt + ni_sublim + ni_selfcollect) * dt
    source_ni = ni + (ni_nucleat + nr2ni_immers + nc2ni_immers) * dt
    ratio = jnp.where(sink_ni > source_ni,
                      source_ni / jnp.maximum(sink_ni, 1e-300), 1.0)
    ni2nr_melt = ni2nr_melt * ratio
    ni_sublim = ni_sublim * ratio
    ni_selfcollect = ni_selfcollect * ratio

    # ice_supersat_conservation (:2856-2886)
    qv_sink = qidep + qinuc
    act = (qv_sink > QSMALL) & (cld_frac_i > 1e-20)
    qv_avail = (qv + (qi2qv_sublim + qr2qv_evap) * dt - qv_sat_i) / \
        (1.0 + ls ** 2 * qv_sat_i / (C.cp * C.rv * t * t)) / dt
    qv_avail = jnp.maximum(qv_avail, 0.0)
    fract = jnp.where(act & (qv_sink > qv_avail),
                      qv_avail / jnp.maximum(qv_sink, 1e-300), 1.0)
    qinuc = qinuc * fract
    qidep = qidep * fract

    # prevent_liq_supersaturation (:2888-2955)
    qv_sources = qi2qv_sublim + qr2qv_evap
    qv_sinks = qidep + qinuc
    qv_end = qv - qv_sinks * dt + qv_sources * dt
    T_end = t + ((qv_sinks - qi2qv_sublim) * ls * C.inv_cp -
                 qr2qv_evap * lv * C.inv_cp) * dt
    qsl = qv_sat(T_end, pres, False)
    A = lv * qsl * dt * C.inv_cp / (C.rv * T_end * T_end) * \
        (ls * qi2qv_sublim + lv * qr2qv_evap)
    frac = (qsl - qv + qv_sinks * dt + A) / \
        jnp.maximum(qv_sources * dt + A, 1e-300)
    frac = jnp.clip(frac, 0.0, 1.0)
    frac = jnp.where(qv_sources < QSMALL, 0.0, frac)
    qi2qv_sublim = jnp.where(qv_sources >= QSMALL, frac * qi2qv_sublim,
                             qi2qv_sublim)
    qr2qv_evap = jnp.where(qv_sources >= QSMALL, frac * qr2qv_evap,
                           qr2qv_evap)

    # --- update_prognostic_ice (:3105-3214)
    qc = qc + (-qc2qi_hetero - qccol - qc2qr_ice_shed - qiberg) * dt
    if ccn_mode != "const":
        nc = nc + (-nc_collect - nc2ni_immers) * dt
    qr = qr + (-qrcol + qi2qr_melt - qr2qi_immers + qc2qr_ice_shed) * dt
    nr = nr + (-nr_collect - nr2ni_immers + C.nmltratio * ni2nr_melt +
               nr_ice_shed + ncshdc) * dt
    has_qi = qi >= QSMALL
    decay = (qi2qv_sublim + qi2qr_melt) / jnp.maximum(qi, 1e-300) * dt
    bm = jnp.where(has_qi, bm - decay * bm, bm)
    qm = jnp.where(has_qi, qm - decay * qm, qm)
    qi = jnp.where(has_qi, qi - (qi2qv_sublim + qi2qr_melt) * dt, qi)
    dum_i = (qrcol + qccol + qr2qi_immers + qc2qi_hetero) * dt
    qi = qi + (qidep + qinuc + qiberg) * dt + dum_i
    qm = qm + dum_i
    bm = bm + (qrcol * C.inv_rho_rimeMax + qccol / rho_qm_cloud +
               (qr2qi_immers + qc2qi_hetero) * C.inv_rho_rimeMax) * dt
    ni = ni + (ni_nucleat - ni2nr_melt - ni_sublim - ni_selfcollect +
               nr2ni_immers + nc2ni_immers) * dt
    neg_qm = qm < 0.0
    qm = jnp.where(neg_qm, 0.0, qm)
    bm = jnp.where(neg_qm, 0.0, bm)
    qm = jnp.where(log_wetgrowth, qi, qm)
    bm = jnp.where(log_wetgrowth, qm * C.inv_rho_rimeMax, bm)
    qv = qv + (-qidep + qi2qv_sublim - qinuc) * dt
    th = th + inv_exner * ((qidep - qi2qv_sublim + qinuc) * ls * C.inv_cp +
                           (qrcol + qccol + qc2qi_hetero + qr2qi_immers -
                            qi2qr_melt + qiberg) * lf * C.inv_cp) * dt

    # --- update_prognostic_liquid (:3216-3266)
    qc = qc + (-qc2qr_accret - qc2qr_auto) * dt
    qr = qr + (qc2qr_accret + qc2qr_auto - qr2qv_evap) * dt
    if ccn_mode != "const":
        nc = nc + (-nc_accret - nc2nr_auto + nc_selfcollect) * dt
    else:
        nc = C.nccnst * inv_rho
    nr = nr + (ncautr - nr_selfcollect - nr_evap) * dt
    qv = qv + qr2qv_evap * dt
    th = th + inv_exner * (-qr2qv_evap * lv * C.inv_cp) * dt

    # diagnostics (:883-889)
    qv2qi_depos_tend = qidep - qi2qv_sublim + qinuc
    precip_total_tend = qc2qr_accret + qc2qr_auto + qc2qr_ice_shed + qccol
    nevapr = qi2qv_sublim + qr2qv_evap
    vap_liq_exchange = -qr2qv_evap
    liq_ice_exchange = qc2qi_hetero + qr2qi_immers - qi2qr_melt + \
        qiberg + qccol + qrcol

    # final clipping (:892-919)
    clip = qc < QSMALL
    qv = jnp.where(clip, qv + qc, qv)
    th = jnp.where(clip, th - inv_exner * qc * lv * C.inv_cp, th)
    qc = jnp.where(clip, 0.0, qc)
    nc = jnp.where(clip, 0.0, nc)
    clip = qr < QSMALL
    qv = jnp.where(clip, qv + qr, qv)
    th = jnp.where(clip, th - inv_exner * qr * lv * C.inv_cp, th)
    qr = jnp.where(clip, 0.0, qr)
    nr = jnp.where(clip, 0.0, nr)
    clip = qi < QSMALL
    qv = jnp.where(clip, qv + qi, qv)
    th = jnp.where(clip, th - inv_exner * qi * ls * C.inv_cp, th)
    qi = jnp.where(clip, 0.0, qi)
    ni = jnp.where(clip, 0.0, ni)
    qm = jnp.where(clip, 0.0, qm)
    bm = jnp.where(clip, 0.0, bm)

    ni_in_new = impose_max_total_ni(ni / jnp.maximum(cld_frac_i, MINCLD),
                                    inv_rho)
    ni = ni_in_new * cld_frac_i

    inc = incloud_ratios(qc, qr, qi, qm, nc, nr, ni, bm, inv_cl, inv_ci,
                         inv_cr)
    out = dict(st)
    out.update(qv=qv, th=th, qc=qc, nc=nc, qr=qr, nr=nr, qi=qi, ni=ni,
               qm=qm, bm=bm, inc=inc, mu_c=mu_c, lamc=lamc, mu_r=mu_r,
               lamr=lamr)
    diags = dict(qv2qi_depos_tend=qv2qi_depos_tend,
                 precip_total_tend=precip_total_tend, nevapr=nevapr,
                 qr_evap_tend=qr2qv_evap, vap_liq_exchange=vap_liq_exchange,
                 vap_ice_exchange=qv2qi_depos_tend,
                 liq_ice_exchange=liq_ice_exchange)
    return out, diags


def p3_main_part2(dt, pres, inv_exner, cld_frac_l, cld_frac_i, cld_frac_r,
                  inv_cl, inv_ci, inv_cr, ni_activated, inv_qc_relvar,
                  qv_prev, t_prev, st, ccn_mode="prescribed"):
    """All microphysical process rates + prognostic updates
    (micro_p3.F90 p3_main_part2:483-975). ``st`` is part1's output dict;
    returns an updated dict + diagnostics.

    Split into _part2_tables (index walks + table contractions) and the
    purely pointwise _part2_core. ni_activated/inv_qc_relvar are accepted
    for signature parity (unreachable/identity under the PAM flag
    configuration, see PARITY.md oracle notes)."""
    tv = _part2_tables(st)
    return _part2_core(dt, pres, inv_exner, cld_frac_l, cld_frac_i,
                       cld_frac_r, inv_cl, inv_ci, inv_cr, qv_prev, t_prev,
                       st, tv, ccn_mode)


# ------------------------------------------------------- homogeneous freezing
def homogeneous_freezing(t, inv_exner, qc, nc, qr, nr, qi, ni, qm, bm, th):
    """Instantaneous freezing of all liquid below -40C
    (micro_p3.F90:4145-4203)."""
    lf = C.latent_heat_fusion
    fz_c = (qc >= QSMALL) & (t < C.T_homogfrz)
    qm = jnp.where(fz_c, qm + qc, qm)
    qi = jnp.where(fz_c, qi + qc, qi)
    bm = jnp.where(fz_c, bm + qc * C.inv_rho_rimeMax, bm)
    ni = jnp.where(fz_c, ni + jnp.maximum(nc, NSMALL), ni)
    th = jnp.where(fz_c, th + inv_exner * qc * lf * C.inv_cp, th)
    qc = jnp.where(fz_c, 0.0, qc)
    nc = jnp.where(fz_c, 0.0, nc)
    fz_r = (qr >= QSMALL) & (t < C.T_homogfrz)
    qm = jnp.where(fz_r, qm + qr, qm)
    qi = jnp.where(fz_r, qi + qr, qi)
    bm = jnp.where(fz_r, bm + qr * C.inv_rho_rimeMax, bm)
    ni = jnp.where(fz_r, ni + jnp.maximum(nr, NSMALL), ni)
    th = jnp.where(fz_r, th + inv_exner * qr * lf * C.inv_cp, th)
    qr = jnp.where(fz_r, 0.0, qr)
    nr = jnp.where(fz_r, 0.0, nr)
    return qc, nc, qr, nr, qi, ni, qm, bm, th


# -------------------------------------------------------------------- part 3
def p3_main_part3(inv_exner, cld_frac_l, cld_frac_r, cld_frac_i, rho,
                  inv_rho, rhofaci, qv, th, qc, nc, qr, nr, qi, ni, qm, bm,
                  vap_liq_exchange=None):
    """Final mass/number consistency + diagnostic fields
    (micro_p3.F90 p3_main_part3:977-1137). Returns (state dict, diag dict).

    vap_liq_exchange: part2's running exchange diagnostic — the clipping
    branches here subtract the clipped qc/qr from it
    (micro_p3.F90:1030-1032, 1056-1058); None -> tracked from zero.
    """
    lv, ls = C.latent_heat_vapor, C.latent_heat_sublim
    ice_tab = jnp.asarray(tbl.load_ice_tables()[0])
    eff_qc = jnp.full_like(qc, 10.0e-6)
    eff_qi = jnp.full_like(qc, 25.0e-6)
    if vap_liq_exchange is None:
        vap_liq_exchange = jnp.zeros_like(qc)

    # cloud
    ok = qc >= QSMALL
    qc_in = qc / cld_frac_l
    nc_in = nc / cld_frac_l
    nc_in, mu_c, lamc, _, _ = cloud_dsd(qc_in, nc_in, rho)
    eff_qc = jnp.where(ok, 0.5 * (mu_c + 3.0) / jnp.maximum(lamc, 1e-300),
                       eff_qc)
    nc = jnp.where(ok, nc_in * cld_frac_l, 0.0)
    qv = jnp.where(ok, qv, qv + qc)
    th = jnp.where(ok, th, th - inv_exner * qc * lv * C.inv_cp)
    vap_liq_exchange = jnp.where(ok, vap_liq_exchange,
                                 vap_liq_exchange - qc)
    qc = jnp.where(ok, qc, 0.0)

    # rain
    ok = qr >= QSMALL
    nr_in, mu_r, lamr, _, _ = rain_dsd(qr / cld_frac_r, nr / cld_frac_r)
    ze_rain = jnp.where(ok, jnp.maximum(
        nr_in * cld_frac_r * (mu_r + 6.0) * (mu_r + 5.0) * (mu_r + 4.0) *
        (mu_r + 3.0) * (mu_r + 2.0) * (mu_r + 1.0) /
        jnp.maximum(lamr, 1e-300) ** 6, 1e-22), 1e-22)
    nr = jnp.where(ok, nr_in * cld_frac_r, nr)
    qv = jnp.where(ok, qv, qv + qr)
    th = jnp.where(ok, th, th - inv_exner * qr * lv * C.inv_cp)
    vap_liq_exchange = jnp.where(ok, vap_liq_exchange,
                                 vap_liq_exchange - qr)
    qr = jnp.where(ok, qr, 0.0)

    # ice
    ok = qi >= QSMALL
    ni = jnp.where(ok, jnp.maximum(ni, NSMALL), ni)
    qi_in = qi / cld_frac_i
    ni_in = ni / cld_frac_i
    qm_in, bm_in, rhop = bulk_rho_rime(qi_in, qm / cld_frac_i,
                                       bm / cld_frac_i)
    qm = jnp.where(ok, qm_in * cld_frac_i, 0.0)
    bm = jnp.where(ok, bm_in * cld_frac_i, 0.0)
    ni_in = impose_max_total_ni(ni_in, inv_rho)
    di, djj, dii, d1, d4, d5 = tbl.indices_1a(
        jnp.maximum(qi_in, 1e-300), jnp.maximum(ni_in, NSMALL), qm_in, rhop)
    # all 7 entries at one fractional position -> one batched contraction
    vm_qi, eff_i, lammax, lammin, refl, diam, bulk_dens = \
        tbl.access_ice_table_multi(ice_tab, (1, 5, 6, 7, 8, 10, 11),
                                   d1, d4, d5)
    ni_in = jnp.minimum(ni_in, lammax * ni_in)
    ni_in = jnp.maximum(ni_in, lammin * ni_in)
    ni = jnp.where(ok, ni_in * cld_frac_i, ni)
    small_m = qm < QSMALL
    qm = jnp.where(small_m, 0.0, qm)
    bm = jnp.where(small_m, 0.0, bm)
    diag_vm_qi = jnp.where(ok, vm_qi * rhofaci, 0.0)
    eff_qi = jnp.where(ok, eff_i, eff_qi)
    diag_diam_qi = jnp.where(ok, diam, 0.0)
    rho_qi = jnp.where(ok, bulk_dens, 0.0)
    ze_ice = jnp.where(ok, jnp.maximum(
        1e-22 + 0.1892 * refl * ni_in * rho, 1e-22) * cld_frac_i, 1e-22)
    qv = jnp.where(ok, qv, qv + qi)
    th = jnp.where(ok, th, th - inv_exner * qi * ls * C.inv_cp)
    qi = jnp.where(ok, qi, 0.0)
    ni = jnp.where(ok, ni, 0.0)
    nr = jnp.where(qr < QSMALL, 0.0, nr)
    dbz = 10.0 * jnp.log10(jnp.maximum((ze_rain + ze_ice) * 1e18, 1e-300))

    state = dict(qv=qv, th=th, qc=qc, nc=nc, qr=qr, nr=nr, qi=qi, ni=ni,
                 qm=qm, bm=bm)
    diag = dict(diag_eff_radius_qc=eff_qc, diag_eff_radius_qi=eff_qi,
                rho_qi=rho_qi, diag_vm_qi=diag_vm_qi,
                diag_diam_qi=diag_diam_qi, diag_equiv_reflectivity=dbz,
                mu_c=mu_c, lamc=lamc, ze_rain=ze_rain, ze_ice=ze_ice,
                vap_liq_exchange=vap_liq_exchange)
    return state, diag


# -------------------------------------------------------------------- p3_main
def p3_main(qc, nc, qr, nr, qv, th, qi, qm, ni, bm, pres, dz, nc_nuceat_tend,
            ni_activated, inv_qc_relvar, dt, dpres, inv_exner, qv_prev,
            t_prev, cld_frac_i, cld_frac_l, cld_frac_r,
            nccn_prescribed=None, ccn_mode="prescribed"):
    """Full P3 step over a batch of columns (micro_p3.F90 p3_main:1140-1507).

    All arrays (nz, ncol) — z LEADING, k=0 = TOP; q/n are DRY mixing
    ratios.
    Sequence: part1 -> part2 (process rates) -> sedimentation ->
    homogeneous freezing -> part3 (:1363, 1380, 1426-1451, 1454, 1460).

    Returns (state dict incl. precip_liq_surf/precip_ice_surf, diag dict).
    """
    from . import sedimentation as sed

    exner = 1.0 / inv_exner
    t_atm = th * exner
    qv = jnp.maximum(qv, 0.0)
    inv_dz = 1.0 / dz
    inv_cl = 1.0 / cld_frac_l
    inv_ci = 1.0 / cld_frac_i
    inv_cr = 1.0 / cld_frac_r

    st = p3_main_part1(dt, pres, dpres, dz, nc_nuceat_tend, inv_exner,
                       exner, inv_cl, inv_ci, inv_cr, t_atm, qv, th, qc, nc,
                       qr, nr, qi, ni, qm, bm, nccn_prescribed, ccn_mode)
    st, diags2 = p3_main_part2(dt, pres, inv_exner, cld_frac_l, cld_frac_i,
                               cld_frac_r, inv_cl, inv_ci, inv_cr,
                               ni_activated, inv_qc_relvar, qv_prev, t_prev,
                               st, ccn_mode)
    rho, inv_rho = st["rho"], st["inv_rho"]
    (qc2, nc2, prt_liq_c, qr2, nr2, prt_liq_r, qi2, ni2, qm2, bm2,
     prt_ice) = sed.combined_sedimentation(
        st["qc"], st["nc"], st["qr"], st["nr"], st["qi"], st["ni"],
        st["qm"], st["bm"], rho, inv_rho, cld_frac_l, cld_frac_r,
        cld_frac_i, st["acn"], st["rhofacr"], st["rhofaci"], inv_dz, dt,
        do_predict_nc=(ccn_mode != "const"), inc=st["inc"])
    # NOTE: the reference's t_atm array is last assigned at the END of
    # part1 (micro_p3.F90:474) and NOT recomputed after part2's latent-heat
    # updates, so homogeneous freezing thresholds on the PRE-part2
    # temperature (p3_main:1456 passes t_atm; part2 only updates th_atm).
    qc2, nc2, qr2, nr2, qi2, ni2, qm2, bm2, th2 = homogeneous_freezing(
        st["t"], inv_exner, qc2, nc2, qr2, nr2, qi2, ni2, qm2, bm2, st["th"])
    state, diag = p3_main_part3(inv_exner, cld_frac_l, cld_frac_r,
                                cld_frac_i, rho, inv_rho, st["rhofaci"],
                                st["qv"], th2, qc2, nc2, qr2, nr2, qi2, ni2,
                                qm2, bm2,
                                vap_liq_exchange=diags2["vap_liq_exchange"])
    state["precip_liq_surf"] = prt_liq_c + prt_liq_r
    state["precip_ice_surf"] = prt_ice
    vle = diag.pop("vap_liq_exchange")
    diag.update(diags2)
    diag["vap_liq_exchange"] = vle
    diag["temp"] = state["th"] * exner
    return state, diag
