"""AWFL ("PAM-A") finite-volume dycore.

Compressible Euler on an A-grid with characteristic acoustic/advective upwind
WENO reconstruction, FCT tracer positivity, SSPRK3 time stepping and dynamic
acoustic sub-cycling. Functional parity target: dynamics/awfl/Dycore.h
("SSPRK3+WENO+FV A-grid", Dycore.h:1544).

Design decisions vs the reference CUDA/YAKL implementation:

* One fused, fully data-parallel flux evaluation per direction instead of a
  per-(cell,face) thread loop: stencil windows are stacked views, the WENO
  limiter is unrolled elementwise arithmetic (pam_tpu.ops.weno), upwinding
  is an elementwise select on stacked stencils (no divergent branches).
* FCT is re-derived without atomics/benign races (Dycore.h:521-550): cell
  limiter factors are computed in one pass and scattered to faces with masked
  selects — mathematically identical because a face flux is only ever limited
  by the single cell it exits (the reference's own race-freedom argument).
* The data-dependent sub-cycle count (Dycore.h:144) runs as a
  ``lax.while_loop`` under jit.
* Internal state layout is ``(nvar, nens, ny, nz, nx)`` — ensemble-leading
  for sharding, and the two minor dims are (nz, nx), so the contiguous
  extent of every array is nz*nx even when ny == 1 (the flagship MMF
  config). Coupler arrays stay (nens, nz, ny, nx); the converters
  transpose.

All reconstruction matrices are derived at setup with numpy
(pam_tpu.ops.recon_matrices), including per-level variable-grid vertical
matrices (analog of Dycore.h:897-940).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import precise
from ..core.coupler import Coupler, hmean
from ..core import profiles
from ..ops import recon_matrices as rm
from ..ops import weno
from ..parallel import comm

# State-vector variable ids (ref: Dycore.h:27-31)
ID_R, ID_U, ID_V, ID_W, ID_T = 0, 1, 2, 3, 4
NUM_STATE = 5

# array axes of stacked fields (nvar, nens, ny, nz, nx)
AX_E, AX_Y, AX_Z, AX_X = 1, 2, 3, 4

_CS = 350.0  # frozen acoustic characteristic speed (ref: Dycore.h:335)


def _pad_periodic(a, axis, h):
    """Periodic halo pad along a horizontal axis (h cells each side).
    Inside a shard_map axis context this is an explicit ppermute halo
    exchange (comm.halo_pad) — one message per side per stage, replacing
    the reference's MPI halo exchange (exchange.h:341-391)."""
    kind = "x" if axis == AX_X else "y"
    return comm.halo_pad(a, h, axis=axis, kind=kind)


@dataclasses.dataclass(frozen=True, eq=False)
class AwflDycore:
    """Holds static config and precomputed tables; all methods are pure."""
    coupler: Coupler
    ord: int = 5
    cfl: float = 0.8
    grav_balance: bool = False  # ref option "balance_hydrostasis_with_gravity"
    # filled by `build`
    tables: Any = None
    vert_s2c: Any = None   # (ord, ord, nens, nz+2, 1, 1) — leading [c,s]
    vert_wrl: Any = None   # (hs, hs, hs, nens, nz+2, 1, 1) — leading [i,s,c]

    # ------------------------------------------------------------------ setup
    @staticmethod
    def build(coupler: Coupler, dz, ord: int = 5, cfl: float = 0.8,
              grav_balance: bool = False) -> "AwflDycore":
        """dz: (nz,) or (nens, nz) static vertical spacings (numpy)."""
        dz = np.asarray(dz, np.float64)
        if dz.ndim == 1:
            dz = np.broadcast_to(dz, (coupler.nens, coupler.nz))
        tables = weno.weno_tables(ord, dtype=coupler.dtype)
        s2c, wrl = rm.vertical_recon_matrices(dz, ord)
        hs = (ord + 1) // 2
        # LEADING matrix dims + trailing batch (pam_tpu.ops.weno docstring):
        # batch dims (nens, 1[y], nz+2, 1[x]) aligning with the internal
        # (..., ny, nz, nx) layout; level axis is -2
        vs2c = jnp.moveaxis(jnp.asarray(s2c, coupler.dtype),
                            (2, 3), (0, 1))[:, :, :, None, :, None]
        vwrl = jnp.moveaxis(jnp.asarray(wrl, coupler.dtype),
                            (2, 3, 4), (0, 1, 2))[:, :, :, :, None, :, None]
        assert vs2c.shape == (ord, ord, coupler.nens, 1, coupler.nz + 2, 1)
        assert vwrl.shape == (hs, hs, hs, coupler.nens, 1, coupler.nz + 2, 1)

        return AwflDycore(coupler=coupler, ord=ord, cfl=cfl,
                          grav_balance=grav_balance, tables=tables,
                          vert_s2c=vs2c, vert_wrl=vwrl)

    @property
    def hs(self) -> int:
        return (self.ord + 1) // 2

    @property
    def name(self) -> str:
        return "SSPRK3+WENO+FV A-grid"  # ref: Dycore.h:1544

    # ---------------------------------------------------- coupler conversions
    def coupler_to_dynamics(self, state):
        """Coupler (rho_d, u, v, w, T, named tracers) -> conserved dycore vars
        (rho, rho*u, rho*v, rho*w, rho*theta) + stacked tracers.
        Ref: convert_coupler_to_dynamics, Dycore.h:1336-1388."""
        cpl, c = self.coupler, self.coupler.const
        rho_d = state["density_dry"]
        rho_v = state["water_vapor"]
        temp = state["temp"]
        press = rho_d * c.R_d * temp + rho_v * c.R_v * temp
        tracers = cpl.stack_tracers(state)
        adds = jnp.asarray(cpl.tracer_adds_mass)
        rho = rho_d + precise.einsum('t,t...->...', adds.astype(rho_d.dtype), tracers)
        theta = (press / c.C0) ** (1.0 / c.gamma_d) / rho
        dyn = jnp.stack([rho, rho * state["uvel"], rho * state["vvel"],
                         rho * state["wvel"], rho * theta])
        # coupler (.., nz, ny, nx) -> internal (.., ny, nz, nx) layout
        return jnp.swapaxes(dyn, 2, 3), jnp.swapaxes(tracers, 2, 3)

    def dynamics_to_coupler(self, state, dyn, tracers):
        """Inverse conversion. Ref: convert_dynamics_to_coupler,
        Dycore.h:1281-1331."""
        cpl, c = self.coupler, self.coupler.const
        # internal (.., ny, nz, nx) -> coupler (.., nz, ny, nx) layout
        dyn = jnp.swapaxes(dyn, 2, 3)
        tracers = jnp.swapaxes(tracers, 2, 3)
        rho = dyn[ID_R]
        press = c.C0 * dyn[ID_T] ** c.gamma_d
        adds = jnp.asarray(cpl.tracer_adds_mass)
        rho_d = rho - precise.einsum('t,t...->...', adds.astype(rho.dtype), tracers)
        rho_v = tracers[cpl.idWV]
        temp = press / (rho_d * c.R_d + rho_v * c.R_v)
        out = dict(state)
        out["density_dry"] = rho_d
        out["uvel"] = dyn[ID_U] / rho
        out["vvel"] = dyn[ID_V] / rho
        out["wvel"] = dyn[ID_W] / rho
        out["temp"] = temp
        return cpl.unstack_tracers(out, tracers)

    # ------------------------------------------------------------------- CFL
    def compute_time_step(self, state):
        """Max stable dt from conservative wind+sound speed estimates.
        Ref: compute_time_step, Dycore.h:65-102."""
        cpl, c = self.coupler, self.coupler.const
        rho_d = state["density_dry"]
        rho_v = state["water_vapor"]
        rho = rho_d + rho_v
        p = (rho_d * c.R_d + rho_v * c.R_v) * state["temp"]
        cs = jnp.sqrt(c.gamma_d * p / rho)
        dz = state["vertical_cell_dz"][:, :, None, None]
        dtx = self.cfl * cpl.dx / (jnp.abs(state["uvel"]) + cs)
        dty = self.cfl * cpl.dy / (jnp.abs(state["vvel"]) + cs)
        dtz = self.cfl * dz / (jnp.abs(state["wvel"]) + cs)
        # global min: pmin over active mesh axes (ref: yakl minval +
        # implicit per-rank locality, Dycore.h:101)
        return comm.pmin_h(jnp.minimum(jnp.minimum(dtx, dty), dtz))

    # ----------------------------------------------------------- halo + BCs
    def _pad_all(self, dyn, tracers, pressure, dz):
        """Periodic x/y halos + vertical BC halos.

        ``dyn`` holds de-densitized (u, v, w, theta) and rho; returns padded
        (dyn, tracers, pressure) with hs cells per side in z, y (if 3-D), x.
        Ref: halo_exchange, Dycore.h:608-711.
        """
        cpl, c = self.coupler, self.coupler.const
        hs = self.hs
        ntr = tracers.shape[0]
        grav, gamma, C0 = c.grav, c.gamma_d, c.C0

        # one stacked array -> single periodic-x (and y) pad for all fields
        allf = jnp.concatenate([dyn, tracers, pressure[None]], axis=0)
        allf = _pad_periodic(allf, AX_X, hs)
        if not cpl.sim2d:
            allf = _pad_periodic(allf, AX_Y, hs)
        else:
            pw = [(0, 0)] * allf.ndim
            pw[AX_Y] = (hs, hs)
            allf = jnp.pad(allf, pw, mode='edge')

        rho, th = allf[0], allf[4]
        pressure = allf[-1]

        # vertical halo blocks (nfields, nens, ny, hs, nx), assembled once:
        # u/v/theta/tracers: zero-gradient; w: zero (rigid lid/ground,
        # ref: Dycore.h:662-677); rho: hydrostatic extrapolation
        # (ref: Dycore.h:682-709); pressure: edge copy (or halo rho*theta
        # under grav_balance, Dycore.h:691-693,705-707)
        edge_b = jnp.broadcast_to(allf[:, :, :, :1],
                                  allf.shape[:3] + (hs,) + allf.shape[4:])
        edge_t = jnp.broadcast_to(allf[:, :, :, -1:], edge_b.shape)

        rho0_b, th0_b = rho[:, :, :1], th[:, :, :1]
        rho0_t, th0_t = rho[:, :, -1:], th[:, :, -1:]
        dz_b = dz[:, None, :1, None]   # (nens,1,1,1)
        dz_t = dz[:, None, -1:, None]
        gm1 = gamma - 1.0

        def hydro_halo(rho0, th0, dzb, sign):
            # rho_halo(k) = (rho0^(g-1) + sign*g*(g-1)*dz0*k/(gamma*C0*th0^g))
            #               ^(1/(g-1)); k ordered nearest-first
            base = rho0 ** gm1
            fac = grav * gm1 * dzb / (gamma * C0 * th0 ** gamma)
            return [(base + sign * fac * k) ** (1.0 / gm1)
                    for k in np.arange(1, hs + 1)]

        halos_b = hydro_halo(rho0_b, th0_b, dz_b, +1.0)  # below ground: denser
        halos_t = hydro_halo(rho0_t, th0_t, dz_t, -1.0)
        rho_bot = jnp.concatenate(list(reversed(halos_b)), axis=2)
        rho_top = jnp.concatenate(halos_t, axis=2)

        zeros_w = jnp.zeros_like(edge_b[0])
        bot = list(edge_b)
        top = list(edge_t)
        bot[0], top[0] = rho_bot, rho_top
        bot[3], top[3] = zeros_w, zeros_w
        if self.grav_balance:
            bot[-1] = C0 * (rho_bot * bot[4]) ** gamma
            top[-1] = C0 * (rho_top * top[4]) ** gamma
        allp = jnp.concatenate([jnp.stack(bot), allf, jnp.stack(top)],
                               axis=AX_Z)
        return allp[:NUM_STATE], allp[NUM_STATE:NUM_STATE + ntr], allp[-1]

    # ------------------------------------------------------------ tendencies
    def tendencies(self, dyn, tracers, tracers_start, dt, state):
        """Semi-discrete RHS for state and tracers.
        Ref: compute_tendencies, Dycore.h:262-586."""
        cpl, c = self.coupler, self.coupler.const
        hs, ord = self.hs, self.ord
        # local extents from the operand (inside a manual-sharding region
        # the horizontal extents are per-device blocks, not cpl.nx/ny)
        nens_l, ny, nz, nx = dyn.shape[1:]
        dx, dy = cpl.dx, cpl.dy
        dz = state["vertical_cell_dz"]  # (nens, nz)
        dz4 = dz[:, None, :, None]      # broadcast over (nens, ny, nz, nx)
        gamma, C0, grav = c.gamma_d, c.C0, c.grav
        tpos = self.coupler.tracer_positive

        rho = dyn[ID_R]
        # pressure (perturbation unless grav_balance) and de-densitized vars
        # (ref: Dycore.h:310-321)
        p_full = C0 * dyn[ID_T] ** gamma
        if self.grav_balance:
            pressure = p_full
        else:
            pressure = p_full - state["hy_pressure_cells"][:, None, :, None]
        prim = dyn.at[1:].divide(rho[None])
        trac_prim = tracers / rho[None]

        dyn_p, trac_p, pres_p = self._pad_all(prim, trac_prim, pressure, dz)
        rho_pz = dyn_p[ID_R]

        tb = self.tables
        per_lev = (self.vert_s2c, self.vert_wrl)

        def direction(axis):
            """Fluxes for one direction. Returns (state_flux (5, ..faces..),
            tracer_flux (ntr, ..faces..))."""
            # slices selecting interior in the *other* two directions
            sl = [slice(None)] * 5
            for a in (AX_Z, AX_Y, AX_X):
                if a != axis:
                    sl[a] = slice(hs, -hs)
            sl = tuple(sl)
            dyn_d = dyn_p[sl]
            trac_d = trac_p[sl]
            pres_d = pres_p[sl[1:]]
            rho_d = dyn_d[ID_R]
            mom_id = {AX_X: ID_U, AX_Y: ID_V, AX_Z: ID_W}[axis]
            ru_fld = rho_d * dyn_d[mom_id]  # rho*velocity product field

            pl = per_lev if axis == AX_Z else None
            # candidates for acoustic quantities (both sides)
            ruL, ruR = weno.reconstruct_faces_both(ru_fld[None], axis, tb,
                                                   per_level=pl,
                                                   per_level_axis=-2)
            ppL, ppR = weno.reconstruct_faces_both(pres_d[None], axis, tb,
                                                   per_level=pl,
                                                   per_level_axis=-2)
            ruL, ruR, ppL, ppR = ruL[0], ruR[0], ppL[0], ppR[0]
            if axis == AX_Z:
                # rigid lid/ground: zero acoustic mass flux at top/bottom
                # faces (ref: Dycore.h:477-496)
                mask = jnp.zeros((nz + 1,), bool).at[0].set(True).at[-1].set(True)
                mask = mask[None, None, :, None]
                ruL = jnp.where(mask, 0.0, ruL)
                ruR = jnp.where(mask, 0.0, ruR)
            w1 = 0.5 * (ppR - _CS * ruR)
            w2 = 0.5 * (ppL + _CS * ruL)
            pp = w1 + w2
            ru = (w2 - w1) / _CS
            if axis == AX_Z:
                ru = jnp.where(mask, 0.0, ru)
            upw = ru > 0

            # advective quantities: u, v, w, theta + all tracers, one batched
            # upwind-selected reconstruction
            q = jnp.concatenate([dyn_d[1:], trac_d], axis=0)
            vals = weno.reconstruct_faces_upwind(q, axis, tb, upw[None],
                                                 per_level=pl,
                                                 per_level_axis=-2)
            flux_q = ru[None] * vals
            # add pressure to the normal momentum flux
            flux_q = flux_q.at[mom_id - 1].add(pp)
            state_flux = jnp.concatenate([ru[None], flux_q[:NUM_STATE - 1]])
            tracer_flux = flux_q[NUM_STATE - 1:]
            return state_flux, tracer_flux

        sfx, tfx = direction(AX_X)
        if cpl.sim2d:
            sfy = jnp.zeros((NUM_STATE, nens_l, 2, nz, nx), dyn.dtype)
            tfy = jnp.zeros((cpl.num_tracers, nens_l, 2, nz, nx), dyn.dtype)
        else:
            sfy, tfy = direction(AX_Y)
        sfz, tfz = direction(AX_Z)

        # ---- FCT positivity limiting for positive tracers ----
        # (ref: Dycore.h:525-550, re-derived data-parallel; see module doc)
        if tpos.any():
            vol = dx * dy * dz4
            mass_avail = jnp.maximum(tracers_start, 0.0) * vol
            fxp = jnp.maximum(tfx[:, :, :, :, 1:], 0.0)
            fxm = jnp.minimum(tfx[:, :, :, :, :-1], 0.0)
            fyp = jnp.maximum(tfy[:, :, 1:, :, :], 0.0)
            fym = jnp.minimum(tfy[:, :, :-1, :, :], 0.0)
            fzp = jnp.maximum(tfz[:, :, :, 1:], 0.0)
            fzm = jnp.minimum(tfz[:, :, :, :-1], 0.0)
            flux_out = (fxp - fxm) / dx + (fyp - fym) / dy + (fzp - fzm) / dz4
            mass_out = flux_out * dt * vol
            mult = jnp.where(mass_out > mass_avail,
                             mass_avail / jnp.where(mass_out == 0, 1.0, mass_out),
                             1.0)
            pos = jnp.asarray(tpos)[:, None, None, None, None]
            mult = jnp.where(pos, mult, 1.0)

            def limit(flux, ax, periodic):
                # A face flux > 0 exits the cell on its minus side; < 0 exits
                # the cell on its plus side — only the exiting cell's
                # multiplier applies (the reference's race-freedom argument,
                # Dycore.h:521-524). Horizontal axes wrap periodically so the
                # duplicated wrap faces receive identical scaling (this
                # replaces the reference's post-hoc min() reconciliation at
                # the seam, Dycore.h:574-579, with the uniform interior rule
                # — required for sharding-invariant results). Vertical axis
                # pads with 1 (rigid boundaries).
                pw = [(0, 0)] * 5
                if periodic:
                    padded = _pad_periodic(mult, ax, 1)
                    sl_ml = [slice(None)] * 5
                    sl_mr = [slice(None)] * 5
                    sl_ml[ax] = slice(0, -1)
                    sl_mr[ax] = slice(1, None)
                    ml = padded[tuple(sl_ml)]
                    mr = padded[tuple(sl_mr)]
                else:
                    pw[ax] = (1, 0)
                    ml = jnp.pad(mult, pw, constant_values=1.0)
                    pw[ax] = (0, 1)
                    mr = jnp.pad(mult, pw, constant_values=1.0)
                return flux * jnp.where(flux > 0, ml, jnp.where(flux < 0, mr, 1.0))

            tfx = limit(tfx, AX_X, True)
            if not cpl.sim2d:
                tfy = limit(tfy, AX_Y, True)
            tfz = limit(tfz, AX_Z, False)

        # ---- flux divergence + gravity source ---- (ref: Dycore.h:553-584)
        def div(f, ax, d):
            sl_hi = [slice(None)] * 5
            sl_lo = [slice(None)] * 5
            sl_hi[ax] = slice(1, None)
            sl_lo[ax] = slice(0, -1)
            return (f[tuple(sl_hi)] - f[tuple(sl_lo)]) / d

        s_tend = -(div(sfx, AX_X, dx) + div(sfy, AX_Y, dy) + div(sfz, AX_Z, dz4))
        if self.grav_balance:
            gsrc = -state["variable_gravity"][:, None, :, None] * rho
        else:
            gsrc = -grav * (rho - state["hy_dens_cells"][:, None, :, None])
        s_tend = s_tend.at[ID_W].add(gsrc)
        if cpl.sim2d:
            s_tend = s_tend.at[ID_V].set(0.0)

        t_tend = -(div(tfx, AX_X, dx) + div(tfy, AX_Y, dy) + div(tfz, AX_Z, dz4))
        return s_tend, t_tend

    # ------------------------------------------------------------- time step
    def _ssprk3_cycle(self, dyn, tracers, dt, state):
        """One SSPRK3 step of length dt (ref: Dycore.h:147-222)."""
        pos = jnp.asarray(self.coupler.tracer_positive)[:, None, None, None, None]

        def clamp(tr):
            return jnp.where(pos, jnp.maximum(tr, 0.0), tr)

        # Stage 1
        start1 = tracers
        st, tt = self.tendencies(dyn, tracers, start1, dt, state)
        dyn1 = dyn + dt * st
        trac1 = clamp(tracers + dt * tt)
        # Stage 2
        start2 = 0.75 * tracers + 0.25 * trac1
        st, tt = self.tendencies(dyn1, trac1, start2, 0.25 * dt, state)
        dyn2 = 0.75 * dyn + 0.25 * dyn1 + 0.25 * dt * st
        trac2 = clamp(0.75 * tracers + 0.25 * trac1 + 0.25 * dt * tt)
        # Stage 3
        start3 = (1.0 / 3.0) * tracers + (2.0 / 3.0) * trac2
        st, tt = self.tendencies(dyn2, trac2, start3, (2.0 / 3.0) * dt, state)
        dyn3 = (1.0 / 3.0) * dyn + (2.0 / 3.0) * dyn2 + (2.0 / 3.0) * dt * st
        trac3 = clamp((1.0 / 3.0) * tracers + (2.0 / 3.0) * trac2 +
                      (2.0 / 3.0) * dt * tt)
        return dyn3, trac3

    def timestep(self, state, dt_phys):
        """Advance the coupler state by dt_phys (sub-cycled SSPRK3).
        Ref: Dycore::timeStep, Dycore.h:107-255. Jittable."""
        dyn, tracers = self.coupler_to_dynamics(state)
        pos = jnp.asarray(self.coupler.tracer_positive)[:, None, None, None, None]
        tracers = jnp.where(pos, jnp.maximum(tracers, 0.0), tracers)

        dt_dyn = self.compute_time_step(state)
        ncycles = jnp.ceil(dt_phys / dt_dyn).astype(jnp.int32)
        dt_cyc = dt_phys / ncycles.astype(dyn.dtype)

        def body(carry):
            i, dyn, tracers = carry
            dyn, tracers = self._ssprk3_cycle(dyn, tracers, dt_cyc, state)
            return i + 1, dyn, tracers

        _, dyn, tracers = jax.lax.while_loop(
            lambda c: c[0] < ncycles, body, (jnp.int32(0), dyn, tracers))
        return self.dynamics_to_coupler(state, dyn, tracers)

    # --------------------------------------------------------- hydrostatics
    def declare_current_profile_as_hydrostatic(self, state):
        """Record the current horizontal-mean profile as the hydrostatic
        background (ref: Dycore.h:1392-1504). Returns updated state with
        hy_dens_cells / hy_pressure_cells (classic mode) or variable_gravity
        (grav_balance mode)."""
        c = self.coupler.const
        dyn, tracers = self.coupler_to_dynamics(state)
        # back to coupler layout for horizontal means
        to_cpl = lambda a: jnp.swapaxes(a, 1, 2)
        out = dict(state)
        if not self.grav_balance:
            press = c.C0 * dyn[ID_T] ** c.gamma_d
            out["hy_pressure_cells"] = hmean(to_cpl(press))
            out["hy_dens_cells"] = hmean(to_cpl(dyn[ID_R]))
            return out
        # grav-balance mode: discrete interface pressures by the same vertical
        # reconstruction the solver uses, averaged L/R (ref: Dycore.h:1449-1488)
        dz = state["vertical_cell_dz"]
        rho = dyn[ID_R]
        pressure = c.C0 * dyn[ID_T] ** c.gamma_d
        prim = dyn.at[1:].divide(rho[None])
        dyn_p, trac_p, pres_p = self._pad_all(prim, tracers / rho[None],
                                              pressure, dz)
        hs = self.hs
        pres_d = pres_p[:, hs:-hs, :, hs:-hs]   # y/x interior, z padded
        pL, pR = weno.reconstruct_faces_both(
            pres_d[None], AX_Z, self.tables,
            per_level=(self.vert_s2c, self.vert_wrl), per_level_axis=-2)
        pint = 0.5 * (pL[0] + pR[0])  # (nens, ny, nz+1, nx)
        gvar = hmean(to_cpl(-(pint[:, :, 1:] - pint[:, :, :-1]) /
                            (rho * dz[:, None, :, None])))
        out["variable_gravity"] = gvar
        return out
