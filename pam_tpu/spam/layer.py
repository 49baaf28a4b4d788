"""SPAM layer models: (thermal) shallow water on the doubly periodic plane.

Parity reference: dynamics/spam/src/models/layermodel.h (ModelTendencies,
SWETestCase, DoubleVortex :1272-1360) + hamiltonians/layer_models.h
(Hamiltonian_SWE_Hs :138-236, Hamiltonian_TSWE_Hs :8-137) +
hamiltonians/functionals.h Functional_PVPE (:10-75) + the 2D wedge ops
(operators/wedge.h Q2D/W2D :4-45, 790-805) and layer exterior derivatives
(operators/ext_deriv.h D1 :714-736).

Design: the reference's ~15 staged kernels per tendency
evaluation collapse into one fused jittable function over
``(ndof, nens, ny, nx)`` arrays; periodic shifts are ``jnp.roll``; the
per-thread WENO edge recon is the batched limiter of pam_tpu.ops.weno.

2D indexing quirks transcribed verbatim:
* straight (primal) reconstructions enumerate dims REVERSED — component
  d=1 reconstructs along x, d=0 along y, and the d=0 upwind flux is
  negated ("corrects for twist", recon.h:444-448).
* Q2D / W2D carry the (-x, +y) perpendicular signs (wedge.h:4-30).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import precise
from ..ops import weno
from ..parallel import comm


def shift(a, dj, di):
    """result[..., j, i] = a[..., j+dj, i+di] (doubly periodic); explicit
    ppermute halo fetches inside a shard_map axis context."""
    out = comm.proll(a, di, axis=-1) if di else a
    return comm.proll(out, dj, axis=-2) if dj else out


def _edge_recon(field, tables, axis):
    """WENO left/right edge values per cell along the given trailing axis
    (-1 = x, -2 = y), periodic. field: (..., ny, nx)."""
    s2c, wrl, tvh, tvl, c2g, idl, sigma = tables
    ord = s2c.shape[-1]
    hs = (ord - 1) // 2
    sten = [comm.proll(field, s - hs, axis=axis) for s in range(ord)]
    aw = weno.weno_coefs_list(sten, s2c, wrl, tvh, tvl, idl, sigma)
    left = weno._eval_edge_list(aw, c2g[:, 0])
    right = weno._eval_edge_list(aw, c2g[:, 1])
    return left, right


@dataclasses.dataclass(frozen=True, eq=False)
class LayerModel:
    """SWE ("swe") or thermal SWE ("tswe") on a uniform periodic plane.

    Fields: dens (ndens, nens, ny, nx) dual 2-forms
    (SWE: [h(, tracers...)]; TSWE: [h, S(, tracers...)]);
    v (2, nens, ny, nx) primal 1-forms (v[0]=x-edge, v[1]=y-edge);
    hs: surface height 2-form (nens, ny, nx); coriolis: primal 2-form.
    """
    nx: int
    ny: int
    nens: int
    Lx: float
    Ly: float
    g: float
    variant: str = "swe"          # "swe" | "tswe"
    ndens: int = 1
    ord: int = 5
    dtype: Any = jnp.float64

    @property
    def dx(self):
        return self.Lx / self.nx

    @property
    def dy(self):
        return self.Ly / self.ny

    def tables(self):
        return weno.weno_tables(self.ord, dtype=self.dtype)

    # -------------------------------------------------------------- operators
    def H2bar(self, a):
        """dual 2-form -> primal 0-form (diagonal, diff_ord=2)."""
        return a / (self.dx * self.dy)

    def H1(self, v):
        """primal 1-form -> dual 1-form (diagonal): U0 = v0*dy/dx,
        U1 = v1*dx/dy (hodge_star.h H1 2D diagonal)."""
        return jnp.stack([v[0] * (self.dy / self.dx),
                          v[1] * (self.dx / self.dy)])

    def q0f0(self, dens, v, coriolis):
        """PV/Coriolis at primal vertices (functionals.h:43-52):
        hv = R(h) 4-pt average; zeta = D1(v)."""
        h = dens[0]
        hv = 0.25 * (h + shift(h, 0, -1) + shift(h, -1, 0) +
                     shift(h, -1, -1))
        zeta = v[1] - v[0] - shift(v[1], 0, -1) + shift(v[0], -1, 0)
        return zeta / hv, coriolis / hv, hv, zeta

    # ---------------------------------------------------- functional derivs
    def functional_derivatives(self, dens, v, hs):
        """F, K, he, B (layermodel.h compute_functional_derivatives:475-520:
        F_and_K + B via Hs.compute_dHsdx + Hk.compute_dKddens)."""
        dens0 = self.H2bar(dens)
        h0 = dens0[0]
        U = self.H1(v)
        he = jnp.stack([0.5 * (h0 + shift(h0, 0, -1)),
                        0.5 * (h0 + shift(h0, -1, 0))])
        F = he * U
        # K = 0.5 * phiT(U, v) per dual cell (kinetic_energy.h:122-124)
        K = 0.5 * (0.5 * (U[0] * v[0] + shift(U[0] * v[0], 0, 1)) +
                   0.5 * (U[1] * v[1] + shift(U[1] * v[1], 1, 0)))
        K0 = self.H2bar(K)
        hs0 = self.H2bar(hs)
        g = self.g
        nd = self.ndens
        B = [None] * nd
        if self.variant == "swe":
            # layer_models.h Hamiltonian_SWE_Hs:181-236
            Bm = g * hs0 + g * h0
            for l in range(1, nd):
                Bm = Bm + 0.5 * dens0[l]
            B[0] = Bm + K0
            for l in range(1, nd):
                B[l] = 0.5 * h0
        else:
            # layer_models.h Hamiltonian_TSWE_Hs:45-135 (dens1 = S)
            Bm = 0.5 * dens0[1]
            for l in range(2, nd):
                Bm = Bm + 0.5 * dens0[l]
            B[0] = Bm + K0
            B[1] = hs0 + 0.5 * h0
            for l in range(2, nd):
                B[l] = 0.5 * h0
        return F, K, he, jnp.stack(B)

    # ------------------------------------------------------------- recons
    def recons(self, dens, q0, f0, F, he):
        """Upwinded WENO reconstructions (layermodel.h:304-423)."""
        tb = self.tables()
        dens0 = self.H2bar(dens)
        # twisted (dual) dens recon: d=0 along x, d=1 along y; upwind by F
        dl, dr = _edge_recon(dens0, tb, -1)
        dens_rx = jnp.where(F[0] >= 0, shift(dr, 0, -1), dl)
        db, dt_ = _edge_recon(dens0, tb, -2)
        dens_ry = jnp.where(F[1] >= 0, shift(dt_, -1, 0), db)
        densrecon = jnp.stack([dens_rx / he[0], dens_ry / he[1]])
        # FT = W(F) (wedge.h compute_W:790-805)
        ft0 = -0.25 * (F[1] + shift(F[1], 0, -1) + shift(F[1], 1, 0) +
                       shift(F[1], 1, -1))
        ft1 = 0.25 * (F[0] + shift(F[0], 0, 1) + shift(F[0], -1, 0) +
                      shift(F[0], -1, 1))
        # straight (primal) q/f recons; REVERSED dim enumeration
        # (recon.h:444-462): component d=1 along x upwinded by ft1,
        # d=0 along y upwinded by -ft0

        def straight(q):
            ql_, qr_ = _edge_recon(q, tb, -1)
            rx = jnp.where(ft1 >= 0, qr_, shift(ql_, 0, 1))
            qb_, qt_ = _edge_recon(q, tb, -2)
            ry = jnp.where(-ft0 >= 0, qt_, shift(qb_, 1, 0))
            return ry, rx      # (d=0, d=1)

        q_r0, q_r1 = straight(q0)
        f_r0, f_r1 = straight(f0)
        return densrecon, jnp.stack([q_r0, q_r1]), jnp.stack([f_r0, f_r1])

    # ---------------------------------------------------------- tendencies
    def _Q_EC(self, recon, F):
        """Energy-conserving PV flux (wedge.h Q2D/compute_Q_EC:4-90)."""
        r0, r1 = recon[0], recon[1]
        f0 = (F[1] + shift(F[1], 0, -1) + shift(F[1], 1, 0) +
              shift(F[1], 1, -1))
        vel0 = -0.125 * (F[1] * r1 + shift(F[1], 0, -1) * shift(r1, 0, -1) +
                         shift(F[1], 1, 0) * shift(r1, 1, 0) +
                         shift(F[1], 1, -1) * shift(r1, 1, -1) +
                         f0 * r0)
        f1 = (F[0] + shift(F[0], 0, 1) + shift(F[0], -1, 0) +
              shift(F[0], -1, 1))
        vel1 = 0.125 * (F[0] * r0 + shift(F[0], 0, 1) * shift(r0, 0, 1) +
                        shift(F[0], -1, 0) * shift(r0, -1, 0) +
                        shift(F[0], -1, 1) * shift(r0, -1, 1) +
                        f1 * r1)
        return jnp.stack([vel0, vel1])

    def compute_rhs(self, dens, v, hs, coriolis):
        """One tendency evaluation; dx/dt = -(denstend, vtend)
        (layermodel.h compute_tendencies:424-474 + apply_symplectic)."""
        F, K, he, B = self.functional_derivatives(dens, v, hs)
        q0, f0, _, _ = self.q0f0(dens, v, coriolis)
        densrecon, qrecon, frecon = self.recons(dens, q0, f0, F, he)
        # v tendency: wD0 (x/y gradients of B weighted by active dens recon;
        # densrecon is (2[dir], ndens, nens, ny, nx))
        nact = 1 if self.variant == "swe" else 2
        dBx = B - shift(B, 0, -1)
        dBy = B - shift(B, -1, 0)
        vtend0 = precise.einsum('l...,l...->...', densrecon[0][:nact],
                            dBx[:nact])
        vtend1 = precise.einsum('l...,l...->...', densrecon[1][:nact],
                            dBy[:nact])
        vtend = jnp.stack([vtend0, vtend1])
        vtend = vtend + self._Q_EC(qrecon, F) + self._Q_EC(frecon, F)
        # dens tendency: wDnm1bar (2D divergence with recon weights)
        fx = densrecon[0] * F[0][None]
        fy = densrecon[1] * F[1][None]
        denstend = (shift(fx, 0, 1) - fx) + (shift(fy, 1, 0) - fy)
        return denstend, vtend

    def ssprk3_step(self, dens, v, hs, coriolis, dt):
        """(SSPRK.h:60-78, x - dt*F form as in the extruded port)."""
        fd, fv = self.compute_rhs(dens, v, hs, coriolis)
        d1, v1 = dens - dt * fd, v - dt * fv
        fd, fv = self.compute_rhs(d1, v1, hs, coriolis)
        d2 = 0.75 * dens + 0.25 * (d1 - dt * fd)
        v2 = 0.75 * v + 0.25 * (v1 - dt * fv)
        fd, fv = self.compute_rhs(d2, v2, hs, coriolis)
        dens3 = dens / 3.0 + (2.0 / 3.0) * (d2 - dt * fd)
        v3 = v / 3.0 + (2.0 / 3.0) * (v2 - dt * fv)
        return dens3, v3

    # ------------------------------------------------------------- stats
    def statistics(self, dens, v, hs, coriolis):
        """Mass, PV, total energy (layermodel.h ModelStats:901-1205)."""
        F, K, he, B = self.functional_derivatives(dens, v, hs)
        U = self.H1(v)
        KE = 0.5 * jnp.sum(he * U * v, axis=(0, -2, -1))
        dens0 = self.H2bar(dens)
        h0 = dens0[0]
        hs0 = self.H2bar(hs)
        if self.variant == "swe":
            PE = jnp.sum(self.g * hs0 * dens[0] + 0.5 * self.g * h0 * dens[0],
                         axis=(-2, -1))
        else:
            PE = jnp.sum(hs0 * dens[1] + 0.5 * h0 * dens[1], axis=(-2, -1))
        _, _, hv, zeta = self.q0f0(dens, v, coriolis)
        return dict(mass=jnp.sum(dens, axis=(-2, -1)),
                    pv=jnp.sum(zeta + coriolis, axis=(-2, -1)),
                    E=KE + PE, KE=KE, PE=PE)


# ---------------------------------------------------------------- testcase
@dataclasses.dataclass(frozen=True)
class DoubleVortex:
    """(layermodel.h:1272-1360)."""
    g: float = 9.80616
    Lx: float = 5000000.0
    Ly: float = 5000000.0
    coriolis: float = 0.00006147
    H0: float = 750.0
    ox: float = 0.1
    oy: float = 0.1
    dh: float = 75.0
    c: float = 0.05
    a: float = 1.0 / 3.0

    @property
    def sigmax(self):
        return 3.0 / 40.0 * self.Lx

    @property
    def sigmay(self):
        return 3.0 / 40.0 * self.Ly

    def _primes(self, x, y, xc, yc):
        sx, sy = self.sigmax, self.sigmay
        xp = self.Lx / (np.pi * sx) * np.sin(np.pi / self.Lx * (x - xc))
        yp = self.Ly / (np.pi * sy) * np.sin(np.pi / self.Ly * (y - yc))
        xpp = self.Lx / (2 * np.pi * sx) * np.sin(
            2 * np.pi / self.Lx * (x - xc))
        ypp = self.Ly / (2 * np.pi * sy) * np.sin(
            2 * np.pi / self.Ly * (y - yc))
        return xp, yp, xpp, ypp

    def _centers(self):
        xc1 = (0.5 - self.ox) * self.Lx
        yc1 = (0.5 - self.oy) * self.Ly
        xc2 = (0.5 + self.ox) * self.Lx
        yc2 = (0.5 + self.oy) * self.Ly
        return xc1, yc1, xc2, yc2

    def h_f(self, x, y):
        xc1, yc1, xc2, yc2 = self._centers()
        xp1, yp1, _, _ = self._primes(x, y, xc1, yc1)
        xp2, yp2, _, _ = self._primes(x, y, xc2, yc2)
        sx, sy = self.sigmax, self.sigmay
        return self.H0 - self.dh * (
            np.exp(-0.5 * (xp1 ** 2 + yp1 ** 2)) +
            np.exp(-0.5 * (xp2 ** 2 + yp2 ** 2)) -
            4.0 * np.pi * sx * sy / self.Lx / self.Ly)

    def v_f(self, x, y):
        xc1, yc1, xc2, yc2 = self._centers()
        xp1, yp1, xpp1, ypp1 = self._primes(x, y, xc1, yc1)
        xp2, yp2, xpp2, ypp2 = self._primes(x, y, xc2, yc2)
        e1 = np.exp(-0.5 * (xp1 ** 2 + yp1 ** 2))
        e2 = np.exp(-0.5 * (xp2 ** 2 + yp2 ** 2))
        u = -self.g * self.dh / self.coriolis / self.sigmay * \
            (ypp1 * e1 + ypp2 * e2)
        vv = self.g * self.dh / self.coriolis / self.sigmax * \
            (xpp1 * e1 + xpp2 * e2)
        return u, vv

    def S_f(self, x, y):
        xc, yc = 0.5 * self.Lx, 0.5 * self.Ly
        D = 0.5 * self.Lx
        sval = self.g * (1.0 + self.c * np.exp(
            -((x - xc) ** 2 + (y - yc) ** 2) / (self.a ** 2 * D ** 2)))
        return sval * self.h_f(x, y)


@dataclasses.dataclass(frozen=True)
class BickleyJet:
    """Unstable Bickley jet with sinusoidal perturbation
    (ref: layermodel.h:1362-1393). Nondimensional domain 4*pi x 4*pi,
    no Coriolis; TSWE bouyancy S = g*h."""
    g: float = 9.80616
    Lx: float = 4.0 * np.pi
    Ly: float = 4.0 * np.pi
    eps: float = 0.1
    l: float = 0.5
    k: float = 0.5
    coriolis: float = 0.0

    def h_f(self, x, y):
        return np.ones_like(x + y)

    def v_f(self, x, y):
        # domain is centered at (xc, yc) = 0 in the reference; our grid
        # spans [0, L), so shift to [-L/2, L/2)
        x = x - 0.5 * self.Lx
        y = y - 0.5 * self.Ly
        U = np.cosh(y) ** -2
        psi = (np.exp(-(y + self.l / 10.0) ** 2 / (2 * self.l ** 2)) *
               np.cos(self.k * x) * np.cos(self.k * y))
        u = psi * (self.k * np.tan(self.k * y) + y / self.l ** 2)
        v = -psi * self.k * np.tan(self.k * x)
        return U + self.eps * u, self.eps * v

    def S_f(self, x, y):
        return self.g * self.h_f(x, y)


def setup_double_vortex(model: LayerModel, tc, nquad: int = 5):
    """Initial (dens, v, hs, coriolis) via Gauss quadrature projections
    (SWETestCase::set_initial_conditions, layermodel.h:1207-1264)."""
    qp, qw = np.polynomial.legendre.leggauss(nquad)
    qp = 0.5 * (qp + 1.0)
    qw = 0.5 * qw
    nx, ny = model.nx, model.ny
    dx, dy = model.dx, model.dy
    xe = np.arange(nx) * dx
    ye = np.arange(ny) * dy

    def cell_avg2(f):
        acc = 0.0
        for px, wx in zip(qp, qw):
            for py, wy in zip(qp, qw):
                acc = acc + wx * wy * f(xe[None, :] + px * dx,
                                        ye[:, None] + py * dy)
        return acc

    h = cell_avg2(tc.h_f) * dx * dy
    fields = [h]
    if model.variant == "tswe":
        fields.append(cell_avg2(tc.S_f) * dx * dy)
    while len(fields) < model.ndens:
        fields.append(np.zeros_like(h))
    dens = jnp.asarray(np.stack(fields), model.dtype)[:, None]
    dens = jnp.repeat(dens, model.nens, axis=1)

    # v: 1-form line integrals along primal edges (quadrature of components)
    def edge_int(f, comp, along_x):
        acc = 0.0
        for p, w in zip(qp, qw):
            if along_x:
                acc = acc + w * f(xe[None, :] + p * dx, ye[:, None])[comp]
            else:
                acc = acc + w * f(xe[None, :], ye[:, None] + p * dy)[comp]
        return acc * (dx if along_x else dy)

    vf = lambda x, y: tc.v_f(x, y)
    v0 = edge_int(vf, 0, True)
    v1 = edge_int(vf, 1, False)
    v = jnp.asarray(np.stack([v0, v1]), model.dtype)[:, None]
    v = jnp.repeat(v, model.nens, axis=1)

    hs = jnp.zeros((model.nens, ny, nx), model.dtype)
    cor = jnp.full((model.nens, ny, nx), tc.coriolis * dx * dy, model.dtype)
    return dens, v, hs, cor
