"""SPAM extruded-model tendencies in full 3-D (PAMC_NDIMS=2: x, y + z).

Parity reference: dynamics/spam/src/models/extrudedmodel.h with ndims=2 —
the reference's 3-D compile configuration. Relative to the x-z slab
(pam_tpu.spam.tendencies) this adds:

* a second horizontal velocity component ``v[1]`` (y-edges) and the
  y-direction mass flux F[1] (kinetic_energy.h compute_he_U_and_K ndims>1),
* THREE potential-vorticity components: qhz = (qxz, qyz) at dual
  horizontal-vertical vertices (functionals.h compute_qhzfhz, with the
  ndims=2 sign flip of zeta_xz — ext_deriv.h D1_ext:700-719) and qxy
  (vertical vorticity) at dual layers (compute_qxyfxy, compute_hvxy),
* tangent fluxes FT=(Wxz_u, Wyz_u), FTW=(Wxz_w, Wyz_w) and FTxy=W2D(F)
  (wedge.h:780-1010; note Wyz_u is +, Wxz_u is −),
* Q operators with the ndims=2 signs: Qxz_w/Qxz_u flip sign vs ndims=1
  (wedge.h:154,506 ``sgn = ndims > 1 ? ∓1``), Qyz_w is +, Qyz_v is −
  (wedge.h:313-408,635-700), and the horizontal Q_EC of the layer model
  applied per level (compute_Q_EC, used at extrudedmodel.h:1816-1821),
* y-direction density/PV reconstructions and FCT fluxes.

Array layout: trailing dims are ``(nens, nz, ny, nx)``; x and y are
periodic (rolls), z uses the same mirror halos as the slab model. A
y-degenerate configuration (ny arbitrary, v[1]=0, y-invariant data)
reproduces the validated x-z slab exactly (double sign flip: zeta_xz and
the Qxz operators both negate), which is the main correctness test.

Sign convention: compute_rhs returns F with dx/dt = -F, as the reference
integrators expect (SSPRK.h:63-78).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp
import numpy as np

from ..ops import precise
from ..ops import weno
from ..parallel import comm

AXZ = -3  # z axis
AXY = -2  # y axis
AXX = -1  # x axis


def rx(a, s):
    """a shifted so result[..., i] = a[..., i+s] along x (periodic);
    explicit ppermute halo fetch inside a shard_map axis context."""
    return comm.proll(a, s, axis=AXX)


def ry(a, s):
    """a shifted so result[..., j, :] = a[..., j+s, :] along y (periodic);
    explicit ppermute halo fetch inside a shard_map axis context."""
    return comm.proll(a, s, axis=AXY)


def _flipz(a, sl):
    return jnp.flip(a[..., sl, :, :], axis=AXZ)


def mirror_layer(a, h: int):
    """Mirror-pad a layer field along z by h (exchange.h:571-585)."""
    bot = _flipz(a, slice(0, h))
    top = _flipz(a, slice(a.shape[AXZ] - h, None))
    return jnp.concatenate([bot, a, top], axis=AXZ)


def mirror_iface(a, h: int):
    """Mirror-pad an interface field along z by h (exchange.h:589-602)."""
    bot = _flipz(a, slice(1, h + 1))
    top = _flipz(a, slice(a.shape[AXZ] - 1 - h, a.shape[AXZ] - 1))
    return jnp.concatenate([bot, a, top], axis=AXZ)


def _edge_recon_h(field, tables, axis, recon_type: str = "wenofunc"):
    """WENO/CFV (left, right) edge values per cell along a periodic
    horizontal axis (recon.h compute_twisted/straight_edge_recon)."""
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tables
    ord = s2c.shape[-1]
    hs = (ord - 1) // 2
    sten = [comm.proll(field, s - hs, axis=axis) for s in range(ord)]
    if recon_type == "cfv":
        aw = weno.cfv_coefs_list(sten, s2c)
        return (weno._eval_edge_list(aw, c2g[:, 0]),
                weno._eval_edge_list(aw, c2g[:, 1]))
    # direct edge evaluation — summation order must match the slab's
    # (weno_edges_list) so the degenerate 3-D reductions stay bit-tight
    return weno.weno_edges_list(sten, s2c, wrl, tvh, tvl, idl, sigma, c2g)


def _edge_recon_z(field_padded, tables, nlev, recon_type: str = "wenofunc",
                  per_level=None):
    """(bottom, top) edge values for z-cells 0..nlev-1 from an array
    already mirror-padded by hs (tendencies._edge_recon_z, z at axis -3)."""
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tables
    ord = s2c.shape[-1]
    sl = [slice(None)] * field_padded.ndim
    sten = []
    for s in range(ord):
        ss = list(sl)
        ss[AXZ] = slice(s, s + nlev)
        sten.append(field_padded[tuple(ss)])
    if per_level is not None:
        # per-level variable-grid matrices: leading [c,s](+[i]) dims,
        # trailing (nens, nlev, 1, 1) broadcastable batch dims
        s2c = jnp.moveaxis(jnp.asarray(per_level[0], field_padded.dtype),
                           (-2, -1), (0, 1))[..., None, None]
        wrl = jnp.moveaxis(jnp.asarray(per_level[1], field_padded.dtype),
                           (-3, -2, -1), (0, 1, 2))[..., None, None]
    if recon_type == "cfv":
        aw = weno.cfv_coefs_list(sten, s2c)
        return (weno._eval_edge_list(aw, c2g[:, 0]),
                weno._eval_edge_list(aw, c2g[:, 1]))
    return weno.weno_edges_list(sten, s2c, wrl, tvh, tvl, idl, sigma, c2g)


def _upwind_h(left, right, flux, axis, utype="heaviside", coeff=250.0,
              area=None):
    """Twisted recon at the minus-side edge of each cell along a horizontal
    axis: flux>=0 selects the upwind cell's (i-1 / j-1) plus-side edge
    (recon.h upwind_recon via compute_twisted_recon)."""
    cand_L = comm.proll(right, -1, axis=axis)
    if utype == "tanh":
        p = jnp.tanh((flux / area) * coeff)
        return 0.5 * (cand_L * (1 + p) + left * (1 - p))
    return jnp.where(flux >= 0, cand_L, left)


@dataclasses.dataclass(frozen=True, eq=False)
class Tendencies3D:
    """Static config + tables for the 3-D extruded CE/MCE model."""
    geom: Any
    varset: Any
    thermo: Any
    grav: float = 9.80616
    ord: int = 5
    force_refstate_hydrostatic_balance: bool = False
    reconstruction_type: str = "wenofunc"   # "wenofunc"|"weno"|"cfv"
    dual_upwind_type: str = "heaviside"     # "heaviside"|"tanh"
    tanh_upwind_coeff: float = 250.0
    # optional constant-in-time Coriolis forms (None = f-plane off):
    # coriolis_hz: (2, nens, nz+1, ny, nx) at dual hz vertices;
    # coriolis_xy: (nens, nz, ny, nx) at dual layers
    coriolis_hz: Any = None
    coriolis_xy: Any = None
    # reference state columns (None -> zeros); shapes (ndens, nens, nz[,+1])
    refdens: Any = None
    ref_q_pi: Any = None
    ref_rho_pi: Any = None
    ref_q_di: Any = None
    ref_rho_di: Any = None
    ref_B: Any = None

    def tables(self):
        return weno.weno_tables(self.ord, dtype=self.geom.dtype)

    def vert_per_level(self):
        g = self.geom
        if g.uniform_vertical:
            return None
        from .tendencies import _VERT_TABLE_CACHE
        from ..ops import recon_matrices as rm
        key = (id(g), self.ord, "dens")
        if key not in _VERT_TABLE_CACHE:
            _VERT_TABLE_CACHE[key] = rm.mirror_recon_matrices(
                np.asarray(g.dz_d), self.ord, iface=True)
        return _VERT_TABLE_CACHE[key]

    def vert_per_level_q(self):
        g = self.geom
        if g.uniform_vertical:
            return None
        from .tendencies import _VERT_TABLE_CACHE
        from ..ops import recon_matrices as rm
        key = (id(g), self.ord, "q")
        if key not in _VERT_TABLE_CACHE:
            _VERT_TABLE_CACHE[key] = rm.mirror_recon_matrices(
                np.asarray(g.dz_p), self.ord, iface=True)
        return _VERT_TABLE_CACHE[key]

    @property
    def hs(self):
        return (self.ord - 1) // 2

    # --- diagonal Hodge stars with the 3-D areas (hodge_star_extruded.h) ---
    def _dz_d(self, dtype):
        return jnp.asarray(self.geom.dz_d, dtype)[:, :, None, None]

    def _dz_p(self, dtype):
        return jnp.asarray(self.geom.dz_p, dtype)[:, :, None, None]

    def Hn1bar(self, dens):
        """dual n-form -> 0-form: /(dx*dy*dz_d)."""
        g = self.geom
        return dens / (g.dx * g.dy * self._dz_d(dens.dtype))

    def H10(self, v):
        """primal 1-form -> dual flux: U0 = v0*dz*dy/dx, U1 = v1*dz*dx/dy."""
        g = self.geom
        dz = self._dz_d(v.dtype)
        return jnp.stack([v[0] * (dz * g.dy / g.dx),
                          v[1] * (dz * g.dx / g.dy)])

    def H01(self, w):
        """w -> UW at interior dual interfaces: w*dx*dy/dz_p; 0 at
        boundaries (rigid lid/ground)."""
        g = self.geom
        inner = w * (g.dx * g.dy / self._dz_p(w.dtype))
        z = jnp.zeros_like(inner[..., :1, :, :])
        return jnp.concatenate([z, inner, z], axis=AXZ)

    # ------------------------------------------------------------------
    def functional_derivatives(self, dens, v, w, geop):
        """F (2-comp), FW, K, B (extrudedmodel.h:1996-2084 +
        kinetic_energy.h compute_he_U_and_K, ndims=2 branches)."""
        vs, th = self.varset, self.thermo
        rho_n = vs.get_total_density(dens)
        rho0 = self.Hn1bar(rho_n)
        he0 = 0.5 * (rho0 + rx(rho0, -1))
        he1 = 0.5 * (rho0 + ry(rho0, -1))
        rho0_pad = mirror_layer(rho0, 1)
        hew = 0.5 * (rho0_pad[..., 1:, :, :] + rho0_pad[..., :-1, :, :])
        U = self.H10(v)
        uw = self.H01(w)
        F = jnp.stack([he0 * U[0], he1 * U[1]])
        FW = hew * uw
        # kinetic energy per dual cell (kinetic_energy.h:383-394, + y term)
        vu0, vu1 = v[0] * U[0], v[1] * U[1]
        Kh = 0.5 * (vu0 + rx(vu0, 1)) + 0.5 * (vu1 + ry(vu1, 1))
        w_pad = mirror_layer(w, 1)
        Kv = 0.5 * (w_pad[..., :-1, :, :] * uw[..., :-1, :, :] +
                    w_pad[..., 1:, :, :] * uw[..., 1:, :, :])
        K = 0.5 * (Kh + Kv)
        # B = dH/ddens (same columnwise thermo as the slab model)
        alpha = vs.get_alpha(dens)
        sv = vs.get_entropic_var(dens)
        qd, qv, ql, qi = vs.moist_qs(dens)
        geop0 = self.Hn1bar(geop)
        Uth = th.compute_U(alpha, sv, qd, qv, ql, qi)
        p = -th.compute_dUdalpha(alpha, sv, qd, qv, ql, qi)
        gExner = th.compute_dUdentropic_var(alpha, sv, qd, qv, ql, qi)
        B_mass = geop0 + Uth + p * alpha - sv * gExner
        if vs.variant != "CE":
            mu_d, mu_v, mu_l, mu_i = th.compute_dUdq(alpha, sv, qd, qv, ql, qi)
            B_mass = B_mass + qv * (mu_d - mu_v) + ql * (mu_d - mu_l) + \
                qi * (mu_d - mu_i)
        B_mass = B_mass + self.Hn1bar(K)
        B = jnp.stack([B_mass, gExner])
        return F, FW, K, B

    # ------------------------------------------------------------------
    def _R_avg_h(self, D, axis):
        """Dual-vertex R average of a dual-layer field onto hz vertices
        (interfaces 0..nz, boundary-weighted rows 1 and nz-1; rows 0/nz
        zero) along the given horizontal axis (functionals.h
        compute_hvxz/hvyz + _top/_bottom)."""
        Ds = D + comm.proll(D, -1, axis=axis)   # D[·] + D[·-1]
        nz = D.shape[AXZ]
        full_int = 0.25 * (Ds[..., :-1, :, :] + Ds[..., 1:, :, :])
        bot = 0.25 * Ds[..., 1:2, :, :] + 0.5 * Ds[..., 0:1, :, :]
        top = 0.25 * Ds[..., -2:-1, :, :] + 0.5 * Ds[..., -1:, :, :]
        z = jnp.zeros_like(bot)
        if nz > 2:
            mid = full_int[..., 1:-1, :, :]
            return jnp.concatenate([z, bot, mid, top, z], axis=AXZ)
        return jnp.concatenate([z, bot, top, z], axis=AXZ)

    def q_and_f(self, dens, v, w):
        """PV at dual vertices: qhz (2, nens, nz+1, ny, nx) with zero
        boundary rows, and qxy (nens, nz, ny, nx)
        (functionals.h:117-400 + D1_ext ndims=2 signs)."""
        rho_n = self.varset.get_total_density(dens)
        hv0 = self._R_avg_h(rho_n, AXX)
        hv1 = self._R_avg_h(rho_n, AXY)
        hvxy = 0.25 * (rho_n + rx(rho_n, -1) + ry(rho_n, -1) +
                       rx(ry(rho_n, -1), -1))
        w_pad = mirror_layer(w, 1)            # w_pad[k] = w[k-1]
        # vertex k: v terms at k-1/k (mirror-iface pad), w at layer k-1
        v0_pad = mirror_iface(v[0], 1)
        v1_pad = mirror_iface(v[1], 1)
        dv0 = v0_pad[..., :-1, :, :] - v0_pad[..., 1:, :, :]
        dv1 = v1_pad[..., :-1, :, :] - v1_pad[..., 1:, :, :]
        # ndims=2 signs (ext_deriv.h D1_ext:705-716): zeta_xz NEGATED
        zeta_xz = -(dv0 + (w_pad - rx(w_pad, -1)))
        zeta_yz = (w_pad - ry(w_pad, -1)) + dv1
        if self.coriolis_hz is not None:
            zeta_xz = zeta_xz + self.coriolis_hz[0]
            zeta_yz = zeta_yz + self.coriolis_hz[1]
        nz1 = zeta_xz.shape[AXZ]
        k = jnp.arange(nz1)
        interior = ((k > 0) & (k < nz1 - 1))[None, :, None, None]
        qhz0 = jnp.where(interior, zeta_xz / jnp.where(hv0 == 0, 1.0, hv0), 0.)
        qhz1 = jnp.where(interior, zeta_yz / jnp.where(hv1 == 0, 1.0, hv1), 0.)
        # vertical vorticity (compute_zetaxy: D1 of horizontal v per layer)
        zeta_xy = (v[1] - rx(v[1], -1)) - (v[0] - ry(v[0], -1))
        if self.coriolis_xy is not None:
            zeta_xy = zeta_xy + self.coriolis_xy
        qxy = zeta_xy / hvxy
        return jnp.stack([qhz0, qhz1]), qxy

    # ------------------------------------------------------------------
    def tangent_fluxes(self, F, FW):
        """FT (at v-points), FTW (at w-points), FTxy (at v-points)
        (wedge.h Wxz_u:−, Wyz_u:+, Wxz_w/Wyz_w:+, W2D:890-805)."""
        # FT0 = Wxz_u(FW): -(FW[k,i]+FW[k,i-1]+FW[k+1,i]+FW[k+1,i-1])/4
        sx = FW + rx(FW, -1)
        ft0_int = -0.25 * (sx[..., 1:-2, :, :] + sx[..., 2:-1, :, :])
        FT0 = jnp.concatenate([-0.5 * sx[..., 0:1, :, :], ft0_int,
                               -0.5 * sx[..., -1:, :, :]], axis=AXZ)
        # FT1 = Wyz_u(FW): +: (wedge.h Wyz_u:963-1010)
        sy = FW + ry(FW, -1)
        ft1_int = 0.25 * (sy[..., 1:-2, :, :] + sy[..., 2:-1, :, :])
        FT1 = jnp.concatenate([0.5 * sy[..., 0:1, :, :], ft1_int,
                               0.5 * sy[..., -1:, :, :]], axis=AXZ)
        # FTW0 = Wxz_w(F0); FTW1 = Wyz_w(F1) (both +, boundary coeff
        # 0.25); the boundary rows read the INTERIOR-shifted dual layer
        # (compute_W{x,y}z_w_bottom reads Uvar(k+1), _top reads Uvar(k) —
        # wedge.h:880-905 and the Wyz analogs; pre-round-4 rows used
        # F[0]/F[nz-1], found by tests/spam_oracle.py)
        s0 = F[0] + rx(F[0], 1)
        ftw0 = jnp.concatenate(
            [0.25 * s0[..., 1:2, :, :],
             0.25 * (s0[..., 1:-2, :, :] + s0[..., 2:-1, :, :]),
             0.25 * s0[..., -2:-1, :, :]], axis=AXZ)
        s1 = F[1] + ry(F[1], 1)
        ftw1 = jnp.concatenate(
            [0.25 * s1[..., 1:2, :, :],
             0.25 * (s1[..., 1:-2, :, :] + s1[..., 2:-1, :, :]),
             0.25 * s1[..., -2:-1, :, :]], axis=AXZ)
        # FTxy = W2D(F) per level (wedge.h compute_W:790-805)
        ftxy0 = -0.25 * (F[1] + rx(F[1], -1) + ry(F[1], 1) +
                         rx(ry(F[1], 1), -1))
        ftxy1 = 0.25 * (F[0] + rx(F[0], 1) + ry(F[0], -1) +
                        rx(ry(F[0], -1), 1))
        return (FT0, FT1), (ftw0, ftw1), (ftxy0, ftxy1)

    # ------------------------------------------------------------------
    def recons(self, dens, qhz, qxy, F, FW, FT, FTW, FTxy):
        """Upwinded reconstructions of densities and all three PV
        components (extrudedmodel.h compute_edge_reconstructions_* +
        compute_recons, ndims=2 branches)."""
        g, vs = self.geom, self.varset
        tb = self.tables()
        hs = self.hs
        ut, cf = self.dual_upwind_type, self.tanh_upwind_coeff
        rho_n = vs.get_total_density(dens)
        rho0 = self.Hn1bar(rho_n)

        if self.refdens is not None:
            dens0 = self.Hn1bar(dens - self.refdens[:, :, :, None, None])
        else:
            dens0 = self.Hn1bar(dens)

        # --- twisted density recons: x, y, z ---
        dl, dr = _edge_recon_h(dens0, tb, AXX, self.reconstruction_type)
        area_x = jnp.asarray(g.d_area_nm11(), dens.dtype)[:, :, None, None]
        densrecon0 = _upwind_h(dl, dr, F[0][None], AXX, ut, cf, area_x)
        db_, dt_ = _edge_recon_h(dens0, tb, AXY, self.reconstruction_type)
        area_y = jnp.asarray(g.d_area_nm11_y(), dens.dtype)[:, :, None, None]
        densrecon1 = _upwind_h(db_, dt_, F[1][None], AXY, ut, cf, area_y)
        he0 = 0.5 * (rho0 + rx(rho0, -1))
        he1 = 0.5 * (rho0 + ry(rho0, -1))
        if self.ref_rho_pi is not None:
            ref_pi = (self.ref_rho_pi[None, :, :, None, None] *
                      self.ref_q_pi[:, :, :, None, None])
            densrecon0 = densrecon0 + ref_pi
            densrecon1 = densrecon1 + ref_pi
        densrecon0 = densrecon0 / he0[None]
        densrecon1 = densrecon1 / he1[None]

        # --- twisted vertical density recon ---
        dens0_zpad = mirror_iface(dens0, hs)
        db, dt2 = _edge_recon_z(dens0_zpad, tb, g.nz,
                                self.reconstruction_type,
                                per_level=self.vert_per_level())
        fw_int = FW[None, :, 1:-1, :, :]
        if ut == "tanh":
            p = jnp.tanh((fw_int / g.d_area_n0()) * cf)
            vert_int = 0.5 * (dt2[..., :-1, :, :] * (1 + p) +
                              db[..., 1:, :, :] * (1 - p))
        else:
            vert_int = jnp.where(fw_int >= 0, dt2[..., :-1, :, :],
                                 db[..., 1:, :, :])
        densvertrecon = jnp.concatenate(
            [db[..., :1, :, :], vert_int, dt2[..., -1:, :, :]], axis=AXZ)
        rho0_pad = mirror_layer(rho0, 1)
        hew = 0.5 * (rho0_pad[..., 1:, :, :] + rho0_pad[..., :-1, :, :])
        if self.ref_rho_di is not None:
            densvertrecon = densvertrecon + (
                self.ref_rho_di[None, :, :, None, None] *
                self.ref_q_di[:, :, :, None, None])
        densvertrecon = densvertrecon / hew[None]

        # --- qhz recons (straight_hz: dof0 along x upw FTW0, dof1 along y
        # upw FTW1; the stencil for primal layer k is CENTERED at interface
        # k+1 — recon.h:185-197 "the +1 in k ... since twisted 0-forms have
        # extra dofs at the top and bottom") ---
        q0_w = qhz[0][..., 1:g.nz, :, :]            # interfaces 1..nz-1
        q1_w = qhz[1][..., 1:g.nz, :, :]
        ql_, qr_ = _edge_recon_h(q0_w, tb, AXX)
        qhzrecon0 = jnp.where(FTW[0] >= 0, qr_, rx(ql_, 1))
        qb_, qt_ = _edge_recon_h(q1_w, tb, AXY)
        qhzrecon1 = jnp.where(FTW[1] >= 0, qt_, ry(qb_, 1))

        # --- qhz vertical recons at v-points (straight_hz_vert: both dofs;
        # upwind flux is -FT0 for dof0 ["needs a twist"], +FT1 for dof1;
        # stencil centered at interface k+1, recon.h:236-240) ---
        def vert_q(qc, flux):
            q_pad = mirror_iface(qc, hs)[..., 1:g.nz + 2 * hs, :, :]
            qb2, qt2 = _edge_recon_z(q_pad, tb, g.nz - 1,
                                     per_level=self.vert_per_level_q())
            qt_pad = mirror_layer(qt2, 1)
            cand0 = qt_pad[..., :g.nz, :, :]
            cand1 = jnp.concatenate([qb2, qb2[..., -1:, :, :]], axis=AXZ)
            return jnp.where(flux >= 0, cand0, cand1)

        qhzvertrecon0 = vert_q(qhz[0], -FT[0])
        qhzvertrecon1 = vert_q(qhz[1], FT[1])

        # --- qxy recon (straight_recon per level: d=1 along x upw +FTxy1,
        # d=0 along y upw -FTxy0 — recon.h:444-462) ---
        xl, xr = _edge_recon_h(qxy, tb, AXX)
        qxyrecon1 = jnp.where(FTxy[1] >= 0, xr, rx(xl, 1))
        yl, yr = _edge_recon_h(qxy, tb, AXY)
        qxyrecon0 = jnp.where(-FTxy[0] >= 0, yr, ry(yl, 1))

        return ((densrecon0, densrecon1), densvertrecon,
                (qhzrecon0, qhzrecon1), (qhzvertrecon0, qhzvertrecon1),
                (qxyrecon0, qxyrecon1))

    # ------------------------------------------------------------------
    def fct(self, dens, densrecon, densvertrecon, F, FW, dt):
        """Zalesak FCT limiting of positive densities, 3-D fluxes
        (extrudedmodel.h:2331-2392 + operators/fct.h, ndims=2).

        As in the slab model (tendencies.fct): when the positive
        densities form a contiguous tail of the stack, the flux/Mf/ratio
        computation runs on that tail slice only — the masked full-stack
        form executes (then discards) the same arithmetic on the
        non-positive rows."""
        pos_list = [bool(p) for p in self.varset.dens_pos]
        densrecon0, densrecon1 = densrecon
        if not any(pos_list):
            return (densrecon0, densrecon1), densvertrecon
        k0 = next(i for i, p in enumerate(pos_list) if p)
        if all(pos_list[k0:]):
            (dr0, dr1), dvr = self._fct_all_pos(
                dens[k0:], (densrecon0[k0:], densrecon1[k0:]),
                densvertrecon[k0:], F, FW, dt)
            if k0 == 0:
                return (dr0, dr1), dvr
            return ((jnp.concatenate([densrecon0[:k0], dr0], axis=0),
                     jnp.concatenate([densrecon1[:k0], dr1], axis=0)),
                    jnp.concatenate([densvertrecon[:k0], dvr], axis=0))
        # non-contiguous positives: limiter on the full stack, per-row
        # select (bitwise equal to limiting each positive row)
        pos = jnp.asarray(self.varset.dens_pos)[:, None, None, None, None]
        (dr0, dr1), dvr = self._fct_all_pos(
            dens, (densrecon0, densrecon1), densvertrecon, F, FW, dt)
        return ((jnp.where(pos, dr0, densrecon0),
                 jnp.where(pos, dr1, densrecon1)),
                jnp.where(pos, dvr, densvertrecon))

    def _fct_all_pos(self, dens, densrecon, densvertrecon, F, FW, dt):
        """fct() limiter body: every row of the given stack is limited
        (callers slice/select for partially-positive stacks)."""
        densrecon0, densrecon1 = densrecon
        ef0 = densrecon0 * F[0][None]
        ef1 = densrecon1 * F[1][None]
        vef = densvertrecon * FW[None]
        eps = 1.0e-8
        out_x = jnp.maximum(rx(ef0, 1), 0.0) - jnp.minimum(ef0, 0.0)
        out_y = jnp.maximum(ry(ef1, 1), 0.0) - jnp.minimum(ef1, 0.0)
        out_z = jnp.maximum(vef[..., 1:, :, :], 0.0) - \
            jnp.minimum(vef[..., :-1, :, :], 0.0)
        Mf = (out_x + out_y + out_z) * dt + eps
        ratio = jnp.minimum(1.0, dens / Mf)
        phi_x = jnp.where(ef0 > 0, rx(ratio, -1), ratio)
        phi_y = jnp.where(ef1 > 0, ry(ratio, -1), ratio)
        vf = vef[..., 1:-1, :, :]
        phi_z = jnp.where(vf > 0, ratio[..., :-1, :, :], ratio[..., 1:, :, :])
        ones = jnp.ones_like(densvertrecon[..., :1, :, :])
        phi_z_full = jnp.concatenate([ones, phi_z, ones], axis=AXZ)
        return ((densrecon0 * phi_x, densrecon1 * phi_y),
                densvertrecon * phi_z_full)

    # ------------------------------------------------------------------
    def _Qxz_w(self, qr, qvr, F0, sgn):
        """Qxz_w_EC with explicit sign (wedge.h:154-230; ndims=2 -> -1)."""
        Fp = rx(F0, 1)
        qvrp = rx(qvr, 1)
        t = (F0[..., 1:-2, :, :] * (qvr[..., 1:-2, :, :] + qr[..., 1:-1, :, :]) +
             Fp[..., 1:-2, :, :] * (qvrp[..., 1:-2, :, :] + qr[..., 1:-1, :, :]) +
             F0[..., 2:-1, :, :] * (qvr[..., 2:-1, :, :] + qr[..., 1:-1, :, :]) +
             Fp[..., 2:-1, :, :] * (qvrp[..., 2:-1, :, :] + qr[..., 1:-1, :, :]))
        interior = sgn * 0.125 * t
        bot = sgn * 0.125 * (
            F0[..., 1:2, :, :] * (qvr[..., 1:2, :, :] + qr[..., 0:1, :, :]) +
            Fp[..., 1:2, :, :] * (qvrp[..., 1:2, :, :] + qr[..., 0:1, :, :]))
        top = sgn * 0.125 * (
            F0[..., -2:-1, :, :] * (qvr[..., -2:-1, :, :] + qr[..., -1:, :, :]) +
            Fp[..., -2:-1, :, :] * (qvrp[..., -2:-1, :, :] + qr[..., -1:, :, :]))
        return jnp.concatenate([bot, interior, top], axis=AXZ)

    def _Qyz_w(self, qr, qvr, F1):
        """Qyz_w_EC (+, wedge.h:313-408): x->y analog of Qxz_w."""
        Fp = ry(F1, 1)
        qvrp = ry(qvr, 1)
        t = (F1[..., 1:-2, :, :] * (qvr[..., 1:-2, :, :] + qr[..., 1:-1, :, :]) +
             Fp[..., 1:-2, :, :] * (qvrp[..., 1:-2, :, :] + qr[..., 1:-1, :, :]) +
             F1[..., 2:-1, :, :] * (qvr[..., 2:-1, :, :] + qr[..., 1:-1, :, :]) +
             Fp[..., 2:-1, :, :] * (qvrp[..., 2:-1, :, :] + qr[..., 1:-1, :, :]))
        interior = 0.125 * t
        bot = 0.125 * (
            F1[..., 1:2, :, :] * (qvr[..., 1:2, :, :] + qr[..., 0:1, :, :]) +
            Fp[..., 1:2, :, :] * (qvrp[..., 1:2, :, :] + qr[..., 0:1, :, :]))
        top = 0.125 * (
            F1[..., -2:-1, :, :] * (qvr[..., -2:-1, :, :] + qr[..., -1:, :, :]) +
            Fp[..., -2:-1, :, :] * (qvrp[..., -2:-1, :, :] + qr[..., -1:, :, :]))
        return jnp.concatenate([bot, interior, top], axis=AXZ)

    def _Qhz_u(self, qr_pad, qvr, FW, axis, sgn):
        """Qxz_u_EC (axis=x, sgn=+1 for ndims=2, wedge.h:506) /
        Qyz_v_EC (axis=y, sgn=-1, wedge.h:635) — PV flux onto v-points."""
        FWm = comm.proll(FW, -1, axis=axis)
        qrm = comm.proll(qr_pad, -1, axis=axis)
        t = (FW[..., 1:-2, :, :] * (qr_pad[..., 1:-2, :, :] + qvr[..., 1:-1, :, :]) +
             FWm[..., 1:-2, :, :] * (qrm[..., 1:-2, :, :] + qvr[..., 1:-1, :, :]) +
             FW[..., 2:-1, :, :] * (qr_pad[..., 2:-1, :, :] + qvr[..., 1:-1, :, :]) +
             FWm[..., 2:-1, :, :] * (qrm[..., 2:-1, :, :] + qvr[..., 1:-1, :, :]))
        interior = sgn * 0.125 * t
        bot = sgn * 0.5 * (FW[..., 0:1, :, :] + FWm[..., 0:1, :, :]) * \
            qvr[..., 0:1, :, :]
        top = sgn * 0.5 * (FW[..., -1:, :, :] + FWm[..., -1:, :, :]) * \
            qvr[..., -1:, :, :]
        return jnp.concatenate([bot, interior, top], axis=AXZ)

    def _Q_EC_xy(self, r0, r1, F):
        """Horizontal EC PV flux per level (wedge.h Q2D/compute_Q_EC,
        identical to the layer model's — layermodel.h:1816-1821 usage)."""
        f0s = F[1] + rx(F[1], -1) + ry(F[1], 1) + rx(ry(F[1], 1), -1)
        vel0 = -0.125 * (F[1] * r1 + rx(F[1], -1) * rx(r1, -1) +
                         ry(F[1], 1) * ry(r1, 1) +
                         rx(ry(F[1], 1), -1) * rx(ry(r1, 1), -1) +
                         f0s * r0)
        f1s = F[0] + rx(F[0], 1) + ry(F[0], -1) + rx(ry(F[0], -1), 1)
        vel1 = 0.125 * (F[0] * r0 + rx(F[0], 1) * rx(r0, 1) +
                        ry(F[0], -1) * ry(r0, -1) +
                        rx(ry(F[0], -1), 1) * rx(ry(r0, -1), 1) +
                        f1s * r1)
        return vel0, vel1

    # ------------------------------------------------------------------
    def tendencies_final(self, densrecon, densvertrecon, qhzrecon,
                         qhzvertrecon, qxyrecon, B, F, FW):
        """Assemble -d(dens,v,w)/dt (compute_tendencies,
        extrudedmodel.h:1645-1921, ndims=2 branches)."""
        vs = self.varset
        nact = vs.ndensity_active
        densrecon0, densrecon1 = densrecon
        qr0, qr1 = qhzrecon
        qvr0, qvr1 = qhzvertrecon
        qxyr0, qxyr1 = qxyrecon
        # Wtend (w-points, primal layers)
        dBz = B[:, :, 1:, :, :] - B[:, :, :-1, :, :]
        wtend = precise.einsum('lekyx,lekyx->ekyx',
                           densvertrecon[:nact, :, 1:-1, :, :], dBz)
        if self.force_refstate_hydrostatic_balance:
            dB_ref = self.ref_B[:, :, 1:] - self.ref_B[:, :, :-1]
            wtend = wtend + precise.einsum(
                'lek,lek->ek', self.ref_q_di[:nact, :, 1:-1],
                dB_ref)[..., None, None]
        wtend = wtend + self._Qxz_w(qr0, qvr0, F[0], -1.0)  # ndims=2: sgn -1
        wtend = wtend + self._Qyz_w(qr1, qvr1, F[1])
        # Vtend x-component
        dB0 = B - rx(B, -1)
        vtend0 = precise.einsum('lekyx,lekyx->ekyx', densrecon0[:nact], dB0)
        vtend0 = vtend0 + self._Qhz_u(mirror_layer(qr0, 1), qvr0, FW,
                                      AXX, 1.0)              # ndims=2: sgn +1
        # Vtend y-component
        dB1 = B - ry(B, -1)
        vtend1 = precise.einsum('lekyx,lekyx->ekyx', densrecon1[:nact], dB1)
        vtend1 = vtend1 + self._Qhz_u(mirror_layer(qr1, 1), qvr1, FW,
                                      AXY, -1.0)             # Qyz_v: sgn -1
        # horizontal (xy) PV flux per level
        qv0, qv1 = self._Q_EC_xy(qxyr0, qxyr1, F)
        vtend0 = vtend0 + qv0
        vtend1 = vtend1 + qv1
        vtend = jnp.stack([vtend0, vtend1])
        # dens tendencies (wDnm1bar + vert)
        fx = densrecon0 * F[0][None]
        fy = densrecon1 * F[1][None]
        fz = densvertrecon * FW[None]
        denstend = (rx(fx, 1) - fx) + (ry(fy, 1) - fy) + \
            (fz[..., 1:, :, :] - fz[..., :-1, :, :])
        return denstend, vtend, wtend

    # ------------------------------------------------------------------
    def apply_symplectic(self, dens, v, w, F, FW, B, dt, F_recon=None,
                         FW_recon=None):
        """(extrudedmodel.h apply_symplectic:2173-2486, ndims=2).
        F_recon/FW_recon: the needs_to_recompute_F=true midpoint fluxes
        driving FT/FTW + recon upwinding (see SpamTendencies)."""
        if F_recon is None:
            F_recon, FW_recon = F, FW
        FT, FTW, FTxy = self.tangent_fluxes(F_recon, FW_recon)
        qhz, qxy = self.q_and_f(dens, v, w)
        densrecon, densvertrecon, qhzrecon, qhzvertrecon, qxyrecon = \
            self.recons(dens, qhz, qxy, F_recon, FW_recon, FT, FTW, FTxy)
        densrecon, densvertrecon = self.fct(dens, densrecon, densvertrecon,
                                            F, FW, dt)
        return self.tendencies_final(densrecon, densvertrecon, qhzrecon,
                                     qhzvertrecon, qxyrecon, B, F, FW)

    def compute_rhs(self, dens, v, w, geop, dt):
        """d(dens, v, w)/dt = -(returned tendencies)."""
        F, FW, K, B = self.functional_derivatives(dens, v, w, geop)
        return self.apply_symplectic(dens, v, w, F, FW, B, dt)

    # ------------------------------------------------------------------
    def energy(self, dens, v, w, geop):
        """(KE+PE+IE, KE, PE, IE) per ensemble member."""
        vs, th = self.varset, self.thermo
        rho_n = vs.get_total_density(dens)
        alpha = vs.get_alpha(dens)
        sv = vs.get_entropic_var(dens)
        qd, qv, ql, qi = vs.moist_qs(dens)
        IE = jnp.sum(rho_n * th.compute_U(alpha, sv, qd, qv, ql, qi),
                     axis=(-3, -2, -1))
        PE = jnp.sum(rho_n * self.Hn1bar(geop), axis=(-3, -2, -1))
        _, _, K, _ = self.functional_derivatives(dens, v, w, geop)
        KE = jnp.sum(self.Hn1bar(rho_n) * K, axis=(-3, -2, -1))
        return KE + PE + IE, KE, PE, IE

    def statistics(self, dens, v, w, geop):
        """Conservation stats: densities, energies, 3 PV components
        (ModelStats::compute, ndims=2 -> PV stat has 3 dofs,
        extrudedmodel.h:4621)."""
        E, KE, PE, IE = self.energy(dens, v, w, geop)
        densstat = jnp.sum(dens, axis=(-3, -2, -1))
        densmin = jnp.min(dens, axis=(-3, -2, -1))
        densmax = jnp.max(dens, axis=(-3, -2, -1))
        qhz, qxy = self.q_and_f(dens, v, w)
        rho_n = self.varset.get_total_density(dens)
        hv0 = self._R_avg_h(rho_n, AXX)
        hv1 = self._R_avg_h(rho_n, AXY)
        nz1 = qhz.shape[AXZ]
        k = jnp.arange(nz1)
        interior = ((k > 0) & (k < nz1 - 1))[None, :, None, None]
        pv_xz = jnp.sum(jnp.where(interior, qhz[0] * hv0, 0.0),
                        axis=(-3, -2, -1))
        pv_yz = jnp.sum(jnp.where(interior, qhz[1] * hv1, 0.0),
                        axis=(-3, -2, -1))
        hvxy = 0.25 * (rho_n + rx(rho_n, -1) + ry(rho_n, -1) +
                       rx(ry(rho_n, -1), -1))
        pv_xy = jnp.sum(qxy * hvxy, axis=(-3, -2, -1))
        return dict(densstat=densstat, densmin=densmin, densmax=densmax,
                    E=E, KE=KE, PE=PE, IE=IE,
                    PV=jnp.stack([pv_xz, pv_yz, pv_xy]))

    def ssprk3_step(self, dens, v, w, geop, dt):
        """(SSPRK.h:60-78)."""
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
