"""SPAM extruded-model tendencies: the apply_symplectic pipeline.

Parity reference: dynamics/spam/src/models/extrudedmodel.h (ndims=1,
uniform vertical grid, WENOFUNC order-5 reconstructions, HEAVISIDE
upwinding, energy-conserving (EC) PV fluxes, Zalesak FCT for positive
densities) — the reference's compile-time defaults (src/common.h:62-126).

Redesign: the reference's ~20 staged kernels with inter-stage MPI
exchanges collapse into one fused pure function over whole arrays; halo
exchanges become periodic rolls (x) and mirror pads (z); every WENO
evaluation is the batched limiter from pam_tpu.ops.weno.

Sign convention: compute_rhs returns F with dx/dt = -F, matching the
reference integrators (SSPRK.h:63-78 uses waxpy(-dt, F, x)).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp
import numpy as np

from ..ops import precise
from ..ops import weno
from . import operators as op
from .operators import rollm, mirror_layer, mirror_iface, AXZ

# cache of per-level variable-grid recon matrices, keyed by geometry id
# (geometries are static per run)
_VERT_TABLE_CACHE: dict = {}


def _edge_recon_x(field, tables, recon_type: str = "wenofunc"):
    """Edge reconstruction along x (periodic): for each cell return
    (left_edge, right_edge) values. field: (..., nens, nlev, nx).
    recon_type: "wenofunc"/"weno" (limited) or "cfv" (centered, no
    limiting) — RECONSTRUCTION_TYPE, common.h:72-88."""
    from ..parallel import comm
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tables
    ord = s2c.shape[-1]
    hs = (ord - 1) // 2
    # periodic x stencils: stencil for cell i = cells i-hs..i+hs.
    # ONE halo_pad + ord fused slices instead of ord materialized rolls:
    # XLA folds slices of a single operand into the WENO fusion as offset
    # reads (a roll = slice+slice+concat materializes a full copy per
    # stencil), and under explicit sharding this is one 2-ppermute halo
    # exchange per stage instead of one per roll (comm.halo_pad).
    nx = field.shape[-1]
    pad = comm.halo_pad(field, hs)
    sten = [pad[..., s:s + nx] for s in range(ord)]
    if recon_type == "cfv":
        aw = weno.cfv_coefs_list(sten, s2c)
        return (weno._eval_edge_list(aw, c2g[:, 0]),
                weno._eval_edge_list(aw, c2g[:, 1]))
    # direct edge evaluation: 2 fusion outputs instead of ord coefficient
    # arrays (weno.weno_edges_list docstring; PERF round-4)
    return weno.weno_edges_list(sten, s2c, wrl, tvh, tvl, idl, sigma, c2g)


def _edge_recon_z(field_padded, tables, nlev, recon_type: str = "wenofunc",
                  per_level=None):
    """Edge reconstruction in z for cells 0..nlev-1 from a z-padded
    array (pad hs on each side): returns (bottom_edge, top_edge) per cell.

    per_level: optional (s2c, wrl) per-level variable-grid matrices with
    shapes (nens, nlev, ord, ord) / (nens, nlev, nsub, nsub, nsub) — the
    WENOFUNC stretched-grid path (weno_func_recon_variable.h)."""
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tables
    ord = s2c.shape[-1]
    sl = [slice(None)] * field_padded.ndim
    sten = []
    for s in range(ord):
        ss = list(sl)
        ss[AXZ] = slice(s, s + nlev)
        sten.append(field_padded[tuple(ss)])
    if per_level is not None:
        # leading [c, s] (+[i] for wrl) dims, trailing (nens, nlev, 1)
        # batch dims broadcastable against the (…, nens, nlev, nx) stencils
        s2c = jnp.moveaxis(jnp.asarray(per_level[0], field_padded.dtype),
                           (-2, -1), (0, 1))[..., None]
        wrl = jnp.moveaxis(jnp.asarray(per_level[1], field_padded.dtype),
                           (-3, -2, -1), (0, 1, 2))[..., None]
    if recon_type == "cfv":
        aw = weno.cfv_coefs_list(sten, s2c)
        return (weno._eval_edge_list(aw, c2g[:, 0]),
                weno._eval_edge_list(aw, c2g[:, 1]))
    return weno.weno_edges_list(sten, s2c, wrl, tvh, tvl, idl, sigma, c2g)


def _upwind_x(left, right, flux, utype: str = "heaviside",
              coeff: float = 250.0, area=None):
    """Twisted x recon at edge i. HEAVISIDE: flux>=0 selects right-edge of
    cell i-1, else left-edge of cell i (recon.h upwind_recon; copysign(1,0)
    = +1 so ties go upwind-left). TANH: smooth blend with parameter
    tanh(flux/area * coeff) (recon.h tanh_upwind_recon:326-340,
    flux de-areaed at recon.h:380-385)."""
    cand_L = rollm(right, -1)  # right edge of cell i-1
    if utype == "tanh":
        p = jnp.tanh((flux / area) * coeff)
        return 0.5 * (cand_L * (1 + p) + left * (1 - p))
    return jnp.where(flux >= 0, cand_L, left)


def _upwind_z(bottom, top, flux_int, utype: str = "heaviside",
              coeff: float = 250.0, area=None):
    """Twisted z recon at interior interfaces k=1..nlev-1: flux>=0 selects
    top-edge of cell k-1 else bottom-edge of cell k. Returns (..., nlev-1, nx)."""
    cand_L = top[..., :-1, :]
    cand_R = bottom[..., 1:, :]
    if utype == "tanh":
        p = jnp.tanh((flux_int / area) * coeff)
        return 0.5 * (cand_L * (1 + p) + cand_R * (1 - p))
    return jnp.where(flux_int >= 0, cand_L, cand_R)


@dataclasses.dataclass(frozen=True, eq=False)
class SpamTendencies:
    """All static config + precomputed tables for the extruded CE/MCE model."""
    geom: Any
    varset: Any
    thermo: Any
    grav: float = 9.80616
    ord: int = 5
    force_refstate_hydrostatic_balance: bool = False
    # numerics knobs (compile-time in the reference, common.h:72-111):
    # density (dual) reconstruction type and upwinding
    reconstruction_type: str = "wenofunc"   # "wenofunc"|"weno"|"cfv"
    diff_ord: int = 2                       # horizontal Hodge order 2|4|6
    dual_upwind_type: str = "heaviside"     # "heaviside"|"tanh"
    tanh_upwind_coeff: float = 250.0        # params.h:159
    # diffusion coefficients (extrudedmodel.h:207-212; all default 0 = off,
    # matching read_model_params_file defaults, extrudedmodel.h:5020-5078)
    scalar_horiz_diffusion_coeff: float = 0.0
    scalar_vert_diffusion_coeff: float = 0.0
    velocity_vort_horiz_diffusion_coeff: float = 0.0
    velocity_vort_vert_diffusion_coeff: float = 0.0
    velocity_div_horiz_diffusion_coeff: float = 0.0
    velocity_div_vert_diffusion_coeff: float = 0.0
    # reference state columns (None -> zeros); shapes (ndens, nens, nz[,+1])
    refdens: Any = None          # dual layers
    ref_q_pi: Any = None         # (ndens, nens, nz)   concentrations at v-levels
    ref_rho_pi: Any = None       # (nens, nz)
    ref_q_di: Any = None         # (ndens, nens, nz+1) at dual interfaces
    ref_rho_di: Any = None       # (nens, nz+1)
    ref_B: Any = None            # (nactive, nens, nz)

    def tables(self):
        return weno.weno_tables(self.ord, dtype=self.geom.dtype)

    def vert_per_level(self):
        """Per-level variable-grid matrices for the density (dual layer)
        vertical recon; None on uniform grids (the stretched-grid WENOFUNC
        path, weno_func_recon_variable.h + the per-level matrix setup of
        awfl/Dycore.h:897-940 applied to the SPAM mirror halos)."""
        g = self.geom
        if g.uniform_vertical:
            return None
        key = (id(g), self.ord, "dens")
        if key not in _VERT_TABLE_CACHE:
            from ..ops import recon_matrices as rm
            _VERT_TABLE_CACHE[key] = rm.mirror_recon_matrices(
                np.asarray(g.dz_d), self.ord, iface=True)
        return _VERT_TABLE_CACHE[key]

    def vert_per_level_q(self):
        """Per-level matrices for the qhz vertical recon (grid = primal
        layers, thickness dz_p); None on uniform grids."""
        g = self.geom
        if g.uniform_vertical:
            return None
        key = (id(g), self.ord, "q")
        if key not in _VERT_TABLE_CACHE:
            from ..ops import recon_matrices as rm
            _VERT_TABLE_CACHE[key] = rm.mirror_recon_matrices(
                np.asarray(g.dz_p), self.ord, iface=True)
        return _VERT_TABLE_CACHE[key]

    @property
    def hs(self):
        return (self.ord - 1) // 2

    # ------------------------------------------------------------------
    def functional_derivatives(self, dens, v, w, geop):
        """F, FW, K, B (ref: compute_functional_derivatives,
        extrudedmodel.h:1996-2084 + Hamiltonian_Hk_extruded.compute_he_U_and_K
        kinetic_energy.h:306-395)."""
        g = self.geom
        vs = self.varset
        th = self.thermo
        rho_n = vs.get_total_density(dens)        # n-form
        rho0 = op.Hn1bar_ho(rho_n, g, self.diff_ord)  # actual density
        # he at x-edges; hew at dual interfaces (mirror-layer pad)
        he = op.phi_x(rho0)
        rho0_pad = mirror_layer(rho0, 1)
        hew = op.phi_z_iface(rho0_pad)            # (nens, nz+1, nx)
        u = op.H10_ho(v, g, self.diff_ord)
        uw = op.H01(w, g)                         # zero at boundaries
        F = he * u
        FW = hew * uw
        # kinetic energy per dual cell (kinetic_energy.h:383-394)
        v_pad_r = rollm(v, 1)      # v[k,i+1]
        u_pad_r = rollm(u, 1)
        Kh = 0.5 * (v * u + v_pad_r * u_pad_r)
        w_pad = mirror_layer(w, 1)                # w_pad[k] = w[k-1]
        Kv = 0.5 * (w_pad[..., :-1, :] * uw[..., :-1, :] +
                    w_pad[..., 1:, :] * uw[..., 1:, :])
        K = 0.5 * (Kh + Kv)
        # B (Hs.compute_dHsdx + Hk.compute_dKddens)
        alpha = vs.get_alpha(dens)
        sv = vs.get_entropic_var(dens)
        qd, qv, ql, qi = vs.moist_qs(dens)
        geop0 = op.Hn1bar(geop, g)
        U = th.compute_U(alpha, sv, qd, qv, ql, qi)
        p = -th.compute_dUdalpha(alpha, sv, qd, qv, ql, qi)
        gExner = th.compute_dUdentropic_var(alpha, sv, qd, qv, ql, qi)
        B_mass = geop0 + U + p * alpha - sv * gExner
        if vs.variant != "CE":
            mu_d, mu_v, mu_l, mu_i = th.compute_dUdq(alpha, sv, qd, qv, ql, qi)
            B_mass = B_mass + qv * (mu_d - mu_v) + ql * (mu_d - mu_l) + \
                qi * (mu_d - mu_i)
        B_mass = B_mass + op.Hn1bar(K, g)
        B_entr = gExner
        B = jnp.stack([B_mass, B_entr])
        return F, FW, K, B

    # ------------------------------------------------------------------
    def q_and_f(self, dens, v, w):
        """Relative PV q and planetary f at dual vertices
        (ref: compute_q_and_f, extrudedmodel.h:543-589 +
        Functional_PVPE_extruded, functionals.h:104-400). Coriolis is zero
        for the x-z slab. Returns qhz (nens, nz+1, nx) with zero boundary
        rows (set_bnd, extrudedmodel.h:2226)."""
        rho_n = self.varset.get_total_density(dens)
        hv = op.R_avg(rho_n)
        w_pad = mirror_layer(w, 1)
        zeta = op.D1_ext(v, w_pad)
        nz1 = zeta.shape[AXZ]
        k = jnp.arange(nz1)
        interior = ((k > 0) & (k < nz1 - 1))[None, :, None]
        qhz = jnp.where(interior, zeta / jnp.where(hv == 0, 1.0, hv), 0.0)
        return qhz

    # ------------------------------------------------------------------
    def recons(self, dens, qhz, F, FW, FT, FTW):
        """Upwinded WENO reconstructions of densities and PV
        (ref: compute_edge_reconstructions_uniform + compute_recons,
        extrudedmodel.h:591-711, 1000-1174)."""
        g, vs = self.geom, self.varset
        tb = self.tables()
        hs = self.hs
        dtype = dens.dtype
        rho_n = vs.get_total_density(dens)
        rho0 = op.Hn1bar_ho(rho_n, g, self.diff_ord)

        # dens0 = (dens - refdens)/area  (compute_dens0, :379-417)
        if self.refdens is not None:
            dens0 = op.Hn1bar_ho(dens - self.refdens[:, :, :, None], g,
                                 self.diff_ord)
        else:
            dens0 = op.Hn1bar_ho(dens, g, self.diff_ord)

        # --- horizontal density recon at x-edges of dual cells ---
        dl, dr = _edge_recon_x(dens0, tb, self.reconstruction_type)
        area_x = jnp.asarray(g.d_area_nm11(), dens.dtype)[:, :, None]
        densrecon = _upwind_x(dl, dr, F[None], self.dual_upwind_type,
                              self.tanh_upwind_coeff, area_x)
        he = op.phi_x(rho0)
        if self.ref_rho_pi is not None:
            densrecon = densrecon + (self.ref_rho_pi[None, :, :, None] *
                                     self.ref_q_pi[:, :, :, None])
        densrecon = densrecon / he[None]

        # --- vertical density recon at dual interfaces ---
        dens0_zpad = mirror_iface(dens0, hs)
        db, dt_ = _edge_recon_z(dens0_zpad, tb, g.nz,
                                self.reconstruction_type,
                                per_level=self.vert_per_level())
        vert_int = _upwind_z(db, dt_, FW[None, :, 1:-1, :],
                             self.dual_upwind_type, self.tanh_upwind_coeff,
                             g.d_area_n0())
        # boundary rows: use one-sided edge values (multiplied by FW=0 anyway)
        densvertrecon = jnp.concatenate(
            [db[..., :1, :], vert_int, dt_[..., -1:, :]], axis=AXZ)
        rho0_pad = mirror_layer(rho0, 1)
        hew = op.phi_z_iface(rho0_pad)
        if self.ref_rho_di is not None:
            densvertrecon = densvertrecon + (self.ref_rho_di[None, :, :, None] *
                                             self.ref_q_di[:, :, :, None])
        densvertrecon = densvertrecon / hew[None]

        # --- qhz recons (the reference's storage convention: the stencil
        # for primal layer k is CENTERED at interface k+1 — the "+1 in k
        # ... since twisted 0-forms have extra dofs at the top and bottom",
        # recon.h:185-197,236-240) ---
        q_w_levels = qhz[..., 1:g.nz, :]            # interfaces 1..nz-1
        ql_, qr_ = _edge_recon_x(q_w_levels, tb)
        # straight recon at edge between cells i,i+1, stored at i
        qhzrecon = jnp.where(FTW >= 0, qr_, rollm(ql_, 1))
        # vertical: stencil per primal layer k over interfaces centered at
        # k+1 (mirror-iface pad, then drop the first padded row)
        qhz_pad = mirror_iface(qhz, hs)[..., 1:g.nz + 2 * hs, :]
        qb, qt = _edge_recon_z(qhz_pad, tb, g.nz - 1,
                               per_level=self.vert_per_level_q())
        # straight vert recon at v-level kv from primal-layer cells kv-1 (top)
        # and kv (bottom), upwinded by -FT (the d=0 'twist', recon.h:581-585)
        qt_pad = mirror_layer(qt, 1)   # qt_pad[k] = qt[k-1]
        cand0 = qt_pad[..., :g.nz, :]               # cell kv-1 top edge
        cand1 = jnp.concatenate([qb, qb[..., -1:, :]], axis=AXZ)  # cell kv bottom
        qhzvertrecon = jnp.where(-FT >= 0, cand0, cand1)
        return densrecon, densvertrecon, qhzrecon, qhzvertrecon

    # ------------------------------------------------------------------
    def fct(self, dens, densrecon, densvertrecon, F, FW, dt):
        """Zalesak FCT limiting of positive-density reconstructions
        (ref: extrudedmodel.h:2331-2392 + operators/fct.h).

        When the positive densities form a contiguous TAIL of the stack
        (rows k0.. — true for every shipped variable set: [rho, Theta,
        tracers...]), the edge-flux/Mf/ratio computation runs on that
        tail slice only: the masked full-stack form executes the same
        arithmetic on the non-positive rows and then discards it with a
        broadcast select XLA cannot row-split (3/12 of the FCT bucket
        dead on the P3 config, traced round 5). Results are bitwise
        identical (same ops on the same rows)."""
        pos_list = [bool(p) for p in self.varset.dens_pos]
        if not any(pos_list):
            return densrecon, densvertrecon
        k0 = next(i for i, p in enumerate(pos_list) if p)
        if all(pos_list[k0:]):
            dr_t, dvr_t = self._fct_all_pos(dens[k0:], densrecon[k0:],
                                            densvertrecon[k0:], F, FW, dt)
            if k0 == 0:
                return dr_t, dvr_t
            return (jnp.concatenate([densrecon[:k0], dr_t], axis=0),
                    jnp.concatenate([densvertrecon[:k0], dvr_t], axis=0))
        # non-contiguous positives: limiter on the full stack, per-row
        # select (bitwise equal to limiting each positive row)
        pos = jnp.asarray(self.varset.dens_pos)[:, None, None, None]
        dr_all, dvr_all = self._fct_all_pos(dens, densrecon, densvertrecon,
                                            F, FW, dt)
        return (jnp.where(pos, dr_all, densrecon),
                jnp.where(pos, dvr_all, densvertrecon))

    def _fct_all_pos(self, dens, densrecon, densvertrecon, F, FW, dt):
        """fct() limiter body: every row of the given stack is limited
        (callers slice/select for partially-positive stacks)."""
        edgeflux = densrecon * F[None]
        vertedgeflux = densvertrecon * FW[None]
        eps = 1.0e-8
        out_x = jnp.maximum(rollm(edgeflux, 1), 0.0) - \
            jnp.minimum(edgeflux, 0.0)
        out_z = jnp.maximum(vertedgeflux[..., 1:, :], 0.0) - \
            jnp.minimum(vertedgeflux[..., :-1, :], 0.0)
        Mf = (out_x + out_z) * dt + eps
        # Phi at x-edges: upwind cell i-1 if edgeflux>0 else i (fct.h:190-210)
        ratio = jnp.minimum(1.0, dens / Mf)
        phi_x_ = jnp.where(edgeflux > 0, rollm(ratio, -1), ratio)
        densrecon = densrecon * phi_x_
        # Phivert at interior interfaces: upwind cell k-1 if >0 else k
        vf = vertedgeflux[..., 1:-1, :]
        phi_z = jnp.where(vf > 0, ratio[..., :-1, :], ratio[..., 1:, :])
        ones = jnp.ones_like(densvertrecon[..., :1, :])
        phi_z_full = jnp.concatenate([ones, phi_z, ones], axis=AXZ)
        return densrecon, densvertrecon * phi_z_full

    # ------------------------------------------------------------------
    def tendencies_final(self, densrecon, densvertrecon, qhzrecon,
                         qhzvertrecon, B, F, FW):
        """Assemble -dx/dt (ref: compute_tendencies,
        extrudedmodel.h:1645-1921)."""
        vs = self.varset
        nact = vs.ndensity_active  # active ids are 0..nact-1 for CE/MCE
        # Wtend at w-points (primal layers)
        dBz = B[:, :, 1:, :] - B[:, :, :-1, :]      # (nact, nens, nz-1, nx)
        wtend = precise.einsum('lekx,lekx->ekx',
                           densvertrecon[:nact, :, 1:-1, :], dBz)
        if self.force_refstate_hydrostatic_balance:
            # + wD0_vert(ref q_di, ref B) (extrudedmodel.h:1684-1688)
            dB_ref = self.ref_B[:, :, 1:] - self.ref_B[:, :, :-1]
            wtend = wtend + precise.einsum(
                'lek,lek->ek', self.ref_q_di[:nact, :, 1:-1], dB_ref)[..., None]
        wtend = wtend + op.Qxz_w(qhzrecon, qhzvertrecon, F)
        # Vtend at v-points (primal interfaces)
        dBx = B - rollm(B, -1)                      # B[i]-B[i-1]
        vtend = precise.einsum('lekx,lekx->ekx', densrecon[:nact], dBx)
        vtend = vtend + op.Qxz_u(mirror_layer(qhzrecon, 1), qhzvertrecon, FW)
        # dens tendencies at dual cells
        denstend = op.Dnm1bar_x(F[None], densrecon) + \
            op.Dnm1bar_vert(FW[None], densvertrecon)
        return denstend, vtend, wtend

    # ------------------------------------------------------------------
    def apply_symplectic(self, dens, v, w, F, FW, B, dt, F_recon=None,
                         FW_recon=None):
        """Symplectic tendency assembly given functional derivatives
        (extrudedmodel.h apply_symplectic:2173-2486). For semi-implicit
        stepping, F/FW/B are quadrature-averaged over a discrete gradient
        while the PV/recon state (dens, v, w) is the midpoint
        (time_integrator.h:51-70); in that case the reference recomputes
        the FT/FTW wedges and every recon UPWINDING from he(xm)*u(xm)
        (needs_to_recompute_F=true: F2VAR/FW2VAR, extrudedmodel.h:
        2188-2204) while the FCT edge fluxes and final tendencies keep
        the averaged F/FW — pass those midpoint fluxes as
        F_recon/FW_recon (default: F/FW, the compute_rhs path where the
        two coincide)."""
        if F_recon is None:
            F_recon, FW_recon = F, FW
        FT = op.Wxz_u(FW_recon)
        FTW = op.Wxz_w(F_recon)
        qhz = self.q_and_f(dens, v, w)
        densrecon, densvertrecon, qhzrecon, qhzvertrecon = \
            self.recons(dens, qhz, F_recon, FW_recon, FT, FTW)
        densrecon, densvertrecon = self.fct(dens, densrecon, densvertrecon,
                                            F, FW, dt)
        return self.tendencies_final(densrecon, densvertrecon, qhzrecon,
                                     qhzvertrecon, B, F, FW)

    def compute_rhs(self, dens, v, w, geop, dt):
        """fd + symplectic + optional diffusion (model.h
        Tendencies::compute_rhs:275-284, diffusion hooks
        extrudedmodel.h:2439-2484). Returns (Fdens, Fv, Fw) with
        d(dens,v,w)/dt = -(Fdens, Fv, Fw)."""
        F, FW, K, B = self.functional_derivatives(dens, v, w, geop)
        denstend, vtend, wtend = self.apply_symplectic(dens, v, w, F, FW, B,
                                                       dt)
        if (self.scalar_horiz_diffusion_coeff > 0 or
                self.scalar_vert_diffusion_coeff > 0):
            from . import diffusion as diff
            denstend = diff.scalar_diffusion(
                self, dens, denstend, self.scalar_horiz_diffusion_coeff,
                self.scalar_vert_diffusion_coeff)
        if (self.velocity_vort_horiz_diffusion_coeff > 0 or
                self.velocity_vort_vert_diffusion_coeff > 0 or
                self.velocity_div_horiz_diffusion_coeff > 0 or
                self.velocity_div_vert_diffusion_coeff > 0):
            from . import diffusion as diff
            vtend, wtend = diff.velocity_diffusion(
                self, v, w, vtend, wtend,
                self.velocity_vort_horiz_diffusion_coeff,
                self.velocity_vort_vert_diffusion_coeff,
                self.velocity_div_horiz_diffusion_coeff,
                self.velocity_div_vert_diffusion_coeff)
        return denstend, vtend, wtend

    # ------------------------------------------------------------------
    def energy(self, dens, v, w, geop):
        """Total/kinetic/potential/internal energy per ensemble member
        (ref: ModelStats::compute, extrudedmodel.h:4599-4860). Sums finish
        with a lax.psum over active horizontal mesh axes (the MPI_Ireduce
        of extrudedmodel.h:4824-4835)."""
        from ..parallel import comm
        g, vs, th = self.geom, self.varset, self.thermo
        rho_n = vs.get_total_density(dens)
        alpha = vs.get_alpha(dens)
        sv = vs.get_entropic_var(dens)
        qd, qv, ql, qi = vs.moist_qs(dens)
        IE = comm.psum_h(rho_n * th.compute_U(alpha, sv, qd, qv, ql, qi),
                         (-2, -1))
        PE = comm.psum_h(rho_n * op.Hn1bar(geop, g), (-2, -1))
        _, _, K, _ = self.functional_derivatives(dens, v, w, geop)
        KE = comm.psum_h(op.Hn1bar(rho_n, g) * K, (-2, -1))
        return KE + PE + IE, KE, PE, IE

    def ssprk3_step(self, dens, v, w, geop, dt):
        """(ref: SSPRK.h:60-78; x1 = x - dt F(x), etc.)."""
        def rhs(d_, v_, w_):
            return self.compute_rhs(d_, v_, w_, geop, dt)

        Fd, Fv, Fw = rhs(dens, v, w)
        d1, v1, w1 = dens - dt * Fd, v - dt * Fv, w - dt * Fw
        Fd, Fv, Fw = rhs(d1, v1, w1)
        d2 = 0.75 * dens + 0.25 * d1 - 0.25 * dt * Fd
        v2 = 0.75 * v + 0.25 * v1 - 0.25 * dt * Fv
        w2 = 0.75 * w + 0.25 * w1 - 0.25 * dt * Fw
        Fd, Fv, Fw = rhs(d2, v2, w2)
        d3 = (1. / 3.) * dens + (2. / 3.) * d2 - (2. / 3.) * dt * Fd
        v3 = (1. / 3.) * v + (2. / 3.) * v2 - (2. / 3.) * dt * Fv
        w3 = (1. / 3.) * w + (2. / 3.) * w2 - (2. / 3.) * dt * Fw
        return d3, v3, w3

    def statistics(self, dens, v, w, geop):
        """Conservation statistics per ensemble member (ref:
        ModelStats::compute, extrudedmodel.h:4599-4860; MPI_Ireduce becomes
        a plain jnp reduction): density sums/min/max, energies, total PV and
        potential enstrophy."""
        from ..parallel import comm
        E, KE, PE, IE = self.energy(dens, v, w, geop)
        densstat = comm.psum_h(dens, (-2, -1))             # (ndens, nens)
        densmin = comm.pmin_h(dens, (-2, -1))
        densmax = comm.pmax_h(dens, (-2, -1))
        rho_n = self.varset.get_total_density(dens)
        hv = op.R_avg(rho_n)
        w_pad = mirror_layer(w, 1)
        zeta = op.D1_ext(v, w_pad)
        nz1 = zeta.shape[AXZ]
        k = jnp.arange(nz1)
        interior = ((k > 0) & (k < nz1 - 1))[None, :, None]
        pv = comm.psum_h(jnp.where(interior, zeta, 0.0), (-2, -1))
        pens = comm.psum_h(jnp.where(interior,
                                     0.5 * zeta * zeta /
                                     jnp.where(hv == 0, 1.0, hv), 0.0),
                           (-2, -1))
        return dict(densstat=densstat, densmin=densmin, densmax=densmax,
                    E=E, KE=KE, PE=PE, IE=IE, PV=pv, PENS=pens)
