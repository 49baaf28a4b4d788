"""WENO limited polynomial reconstruction as batched JAX ops.

Re-design of the reference's per-thread WENO routine
(dynamics/awfl/WenoLimiter.h:98-181 ``compute_weno_coefs`` and
dynamics/awfl/Dycore.h:591-604 ``reconstruct``): instead of a scalar loop per
(cell, face), every stage here is a batched elementwise op / tiny einsum over
LEADING stencil axes. Stencil/coefficient axes live at the FRONT of the
arrays so the trailing (spatial) dims stay contiguous; a length-5 stencil
axis minor-most would make every intermediate a strided gather.

All matrices come from :mod:`pam_tpu.ops.recon_matrices` (derived with numpy,
not copied from the reference's generated tables).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp

from . import recon_matrices as rm

_EPS = 1.0e-20


@functools.cache
def weno_tables(ord: int, dtype=jnp.float64):
    """Static tables for a given order: (s2c, wrl, tv_hi, tv_lo, c2g, idl,
    sigma). Cached as NUMPY arrays — caching jnp arrays would capture
    tracers when first invoked inside a jit trace."""
    s2c = rm.sten_to_coefs(ord)
    wrl = rm.weno_lower_sten_to_coefs(ord)
    tv_hi = rm.tv_quadform(ord)
    hs = (ord + 1) // 2
    tv_lo = rm.tv_quadform(hs)
    c2g = rm.coefs_to_gll_lower(ord)
    idl, sigma = rm.weno_ideal_weights(ord)
    import numpy as np
    to = lambda x: np.asarray(x, dtype=np.dtype(dtype))
    return to(s2c), to(wrl), to(tv_hi), to(tv_lo), to(c2g), to(idl), float(sigma)


def _msum(terms):
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _weno_candidates_and_weights(u, s2c, wrl, tv_hi_M, tv_lo_M, idl,
                                 sigma):
    """Candidate polynomials (a_lo list-of-lists, bridge a_br) and the
    mapped nonlinear weights w — the shared core of WENO limiting
    (WenoLimiter.h compute_weno_coefs:98-181 through map_weights)."""
    import numpy as np
    ord = len(u)
    hs = (ord + 1) // 2  # number and size of low-order sub-stencils
    idl = np.asarray(idl, np.float64)
    # Low-order polynomial coefficients a_lo[i][c]
    a_lo = [[_msum([wrl[i, s, c] * u[i + s] for s in range(hs)])
             for c in range(hs)] for i in range(hs)]
    # High-order coefficients a_hi[c]
    a_hi = [_msum([s2c[c, s] * u[s] for s in range(ord)])
            for c in range(ord)]
    # Bridge polynomial: (a_hi - sum_i idl[i]*a_lo[i]) / idl[hs]
    inv_idl_hi = 1.0 / float(idl[hs])
    a_br = []
    for c in range(ord):
        acc = a_hi[c]
        if c < hs:
            acc = acc - _msum([float(idl[i]) * a_lo[i][c] for i in range(hs)])
        a_br.append(acc * inv_idl_hi)

    def quadform(a, M):
        n = len(a)
        terms = []
        for ci in range(n):
            if M[ci, ci] != 0.0:
                terms.append(float(M[ci, ci]) * a[ci] * a[ci])
            for d in range(ci + 1, n):
                if M[ci, d] + M[d, ci] != 0.0:
                    terms.append(float(M[ci, d] + M[d, ci]) * a[ci] * a[d])
        return _msum(terms)

    tv_lo = [quadform(a_lo[i], np.asarray(tv_lo_M)) for i in range(hs)]
    tv_br = quadform(a_br, np.asarray(tv_hi_M))
    lo_avg = _msum(tv_lo) * (1.0 / hs)
    tv_br = lo_avg + (tv_br - lo_avg) * float(sigma)
    tv = tv_lo + [tv_br]
    # Nonlinear weights: idl/(tv^2+eps) -> convexify -> map -> convexify
    w = [float(idl[i]) / (tv[i] * tv[i] + _EPS) for i in range(hs + 1)]
    wsum = _msum(w) + _EPS
    w = [wi / wsum for wi in w]
    w = [wi * (float(idl[i]) + float(idl[i]) ** 2 - 3.0 * float(idl[i]) * wi +
               wi * wi) /
         (float(idl[i]) ** 2 + wi * (1.0 - 2.0 * float(idl[i])))
         for i, wi in enumerate(w)]
    wsum = _msum(w) + _EPS
    w = [wi / wsum for wi in w]
    return a_lo, a_br, w, hs, ord


def weno_coefs_list(u, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma):
    """WENO-limited monomial coefficients — fully unrolled elementwise form.

    The hot-path formulation: every tiny stencil/coefficient contraction is
    unrolled into scalar-constant multiply-adds over the batch-shaped
    arrays, so XLA fuses the whole limiter into a handful of elementwise
    kernels instead of materializing (ord, ...)-stacked intermediates and
    tiny dot_generals.

    Args:
      u: sequence of ``ord`` arrays (cell averages along the stencil).
      s2c: (ord, ord) numpy [c, s] (constants -> folded), or a jnp array
        with leading [c, s] dims and trailing batch dims broadcastable to
        the u arrays (variable vertical grids).
      wrl: (hs, hs, hs) numpy [i, s, c] or jnp with leading dims likewise.
      tv_hi_M/tv_lo_M: numpy smoothness quadratic forms; idl/sigma: numpy
        limiter tuning.
    Returns:
      list of ``ord`` limited-coefficient arrays.

    Parity reference: WenoLimiter.h compute_weno_coefs incl. the
    weight-mapping step (map_weights, WenoLimiter.h:12-19).
    """
    a_lo, a_br, w, hs, ord = _weno_candidates_and_weights(
        u, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma)
    # Weighted combination of candidates
    out = []
    for c in range(ord):
        acc = w[hs] * a_br[c]
        if c < hs:
            acc = acc + _msum([w[i] * a_lo[i][c] for i in range(hs)])
        out.append(acc)
    return out


def weno_edges_list(u, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma, c2g):
    """Both limited edge values (left, right) WITHOUT materializing the
    blended coefficient arrays.

    Algebraically identical to ``weno_coefs_list`` followed by
    ``_eval_edge_list`` (sum reassociated: edge = sum_i w_i * e_i with
    e_i the candidate polynomial evaluated at the edge, instead of
    sum_c g_c * (sum_i w_i a_ic)) — but the traced graph emits TWO
    edge arrays per call instead of ``ord`` coefficient arrays. On the
    bench config the 12-density recon fusion previously materialized 14
    full-size tuple outputs (~280 MB per SI evaluation, ~40% of its
    runtime in output writes, PERF_optable round 4); candidates' edge
    evaluations fold into the same fusion at no extra VPU cost (the
    per-candidate g.a contractions replace the g.aw one).
    """
    import numpy as np
    a_lo, a_br, w, hs, ord = _weno_candidates_and_weights(
        u, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma)
    gl = np.asarray(c2g)[:, 0]
    gr = np.asarray(c2g)[:, 1]
    outs = []
    for g in (gl, gr):
        e_cands = [_msum([float(g[c]) * a_lo[i][c] for c in range(hs)])
                   for i in range(hs)]
        e_cands.append(_msum([float(g[c]) * a_br[c] for c in range(ord)]))
        outs.append(_msum([w[i] * e_cands[i] for i in range(hs + 1)]))
    return outs[0], outs[1]


def cfv_coefs_list(u, s2c):
    """Centered finite-volume (CFV) polynomial coefficients: the full-order
    stencil-to-coefficient map with NO nonlinear limiting (the a_hi branch
    alone). Parity: operators/cfv_recon.h (RECONSTRUCTION_TYPE::CFV,
    common.h:72)."""
    ord = len(u)
    return [_msum([s2c[c, s] * u[s] for s in range(ord)])
            for c in range(ord)]


def weno_coefs(u, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma):
    """Stacked-array wrapper over :func:`weno_coefs_list`: u has the stencil
    axis LEADING; returns (ord, ...) with the coefficient axis leading."""
    ord = u.shape[0]
    coefs = weno_coefs_list([u[s] for s in range(ord)], s2c, wrl,
                            tv_hi_M, tv_lo_M, idl, sigma)
    return jnp.stack(coefs, axis=0)


def windows(a, ord: int, axis: int):
    """Stack ``ord`` shifted views of ``a`` along a NEW LEADING axis:
    ``windows(a)[s, ..., j, ...] = a[..., j+s, ...]``. Length along ``axis``
    shrinks by ord-1."""
    n = a.shape[axis] - ord + 1
    sl = [slice(None)] * a.ndim
    parts = []
    for s in range(ord):
        sl[axis] = slice(s, s + n)
        parts.append(a[tuple(sl)])
    return jnp.stack(parts, axis=0)


def _face_shift_views(u_halo, ord, axis):
    """The ord+1 shifted views of u_halo needed for both one-sided face
    candidates: view s has length nfaces along ``axis``. stenL = views[0:ord]
    (stencil of the left cell of each face), stenR = views[1:ord+1]
    (cf. Dycore.h:346-351 stencil indexing). Plain slices — no stacking —
    so XLA fuses them into the consumers."""
    nfaces = u_halo.shape[axis] - ord
    views = []
    for s in range(ord + 1):
        sl = [slice(None)] * u_halo.ndim
        sl[axis] = slice(s, s + nfaces)
        views.append(u_halo[tuple(sl)])
    return views


def _eval_edge_list(a, g):
    """Evaluate monomial coefficient list at an edge via c2g column g
    (numpy, (ord,))."""
    import numpy as np
    g = np.asarray(g)
    return _msum([float(g[c]) * a[c] for c in range(len(a))])


def reconstruct_faces_both(u_halo, axis, tables, per_level=None,
                           per_level_axis=-3):
    """Both one-sided face reconstructions (valL, valR) along ``axis``.

    valL = left cell's right-edge value; valR = right cell's left-edge value.

    per_level: optional (s2c_lev, wrl_lev) variable-grid matrix stacks with
    LEADING matrix dims — shapes (ord, ord, nens, nlev, 1, 1) and
    (hs, hs, hs, nens, nlev, 1, 1) with nlev = nfaces+1 positioned so the
    trailing batch dims broadcast against the stencil arrays; matrix f+k_upw
    serves face f exactly as the reference indexes vert_sten_to_coefs
    (Dycore.h:456-469). The level axis is -3.
    """
    s2c, wrl, tv_hi_M, tv_lo_M, c2g, idl, sigma = tables
    ord = s2c.shape[-1] if s2c.ndim == 2 else s2c.shape[0]
    views = _face_shift_views(u_halo, ord, axis)
    stenL, stenR = views[:ord], views[1:]
    if per_level is None:
        s2cL = s2cR = s2c
        wrlL = wrlR = wrl
    else:
        s2c_lev, wrl_lev = per_level
        nfaces = stenL[0].shape[axis]
        lev = per_level_axis
        s2cL = jnp.take(s2c_lev, jnp.arange(0, nfaces), axis=lev)
        s2cR = jnp.take(s2c_lev, jnp.arange(1, nfaces + 1), axis=lev)
        wrlL = jnp.take(wrl_lev, jnp.arange(0, nfaces), axis=lev)
        wrlR = jnp.take(wrl_lev, jnp.arange(1, nfaces + 1), axis=lev)
    aL = weno_coefs_list(stenL, s2cL, wrlL, tv_hi_M, tv_lo_M, idl, sigma)
    aR = weno_coefs_list(stenR, s2cR, wrlR, tv_hi_M, tv_lo_M, idl, sigma)
    valL = _eval_edge_list(aL, c2g[:, 1])
    valR = _eval_edge_list(aR, c2g[:, 0])
    return valL, valR


def reconstruct_faces_upwind(u_halo, axis, tables, upw, per_level=None,
                             per_level_axis=-3):
    """Single upwind-selected face reconstruction along ``axis``.

    ``upw`` is boolean, broadcastable to the face shape: True selects the left
    cell's stencil evaluated at its right edge (flow toward +axis), False the
    right cell's stencil at its left edge. On the uniform-matrix path the
    selection happens on the stacked stencil windows before the limiter, so
    only one WENO evaluation is paid per (face, quantity) — same op count as
    the reference's branchy upwinding (Dycore.h:368-385) but fully
    data-parallel. On the per-level (variable vertical grid) path both
    candidates are evaluated and the RESULT selected: selecting matrices
    pointwise would materialize (ord^2 x spatial) intermediates.
    """
    s2c, wrl, tv_hi_M, tv_lo_M, c2g, idl, sigma = tables
    ord = s2c.shape[-1] if s2c.ndim == 2 else s2c.shape[0]
    views = _face_shift_views(u_halo, ord, axis)
    stenL, stenR = views[:ord], views[1:]
    if per_level is None:
        sten = [jnp.where(upw, l, r) for l, r in zip(stenL, stenR)]
        a = weno_coefs_list(sten, s2c, wrl, tv_hi_M, tv_lo_M, idl, sigma)
        return jnp.where(upw, _eval_edge_list(a, c2g[:, 1]),
                         _eval_edge_list(a, c2g[:, 0]))
    s2c_lev, wrl_lev = per_level
    nfaces = stenL[0].shape[axis]
    lev = per_level_axis
    s2cL = jnp.take(s2c_lev, jnp.arange(0, nfaces), axis=lev)
    s2cR = jnp.take(s2c_lev, jnp.arange(1, nfaces + 1), axis=lev)
    wrlL = jnp.take(wrl_lev, jnp.arange(0, nfaces), axis=lev)
    wrlR = jnp.take(wrl_lev, jnp.arange(1, nfaces + 1), axis=lev)
    aL = weno_coefs_list(stenL, s2cL, wrlL, tv_hi_M, tv_lo_M, idl, sigma)
    aR = weno_coefs_list(stenR, s2cR, wrlR, tv_hi_M, tv_lo_M, idl, sigma)
    return jnp.where(upw, _eval_edge_list(aL, c2g[:, 1]),
                     _eval_edge_list(aR, c2g[:, 0]))
