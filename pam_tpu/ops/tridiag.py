"""Shared tridiagonal solvers: sequential Thomas vs parallel cyclic
reduction (PCR).

The reference solves its vertical tridiagonal systems with a per-column
Thomas recurrence (spam extrudedmodel.h:3025-3050, shoc.F90
vd_shoc_decomp/solve:3504-3643). A ``lax.scan`` Thomas runs ~nz sequential
steps; PCR does ceil(log2 n) data-parallel elementwise sweeps — more
flops, no serialization — and is stable for the diagonally-dominant
(I + dt*L) systems PAM builds.

``PAM_TRIDIAG=thomas|pcr|auto`` (auto: PCR on accelerators, Thomas on
CPU, where the scan is cheap and bitwise matches the Fortran oracles);
``solver(mode)`` forces a mode for the steps traced inside it.
On an H100 (700 W) the production P3+SHOC step at nens=512 (65x1x50,
f32) takes 39.975 ms per CRM step with PCR and 45.227 ms with Thomas
(medians of four rounds, tools/step_ab.py), so accelerators keep PCR.
"""

from __future__ import annotations

import contextlib
import os as _os

import jax
import jax.numpy as jnp

_TRIDIAG_MODE = _os.environ.get("PAM_TRIDIAG", "auto")


@contextlib.contextmanager
def solver(mode: str):
    """Force ``"thomas"``, ``"pcr"`` or ``"auto"`` while tracing inside the
    block. The choice is made at trace time, so a function jitted and
    traced before the block keeps the solver it was traced with."""
    global _TRIDIAG_MODE
    if mode not in ("thomas", "pcr", "auto"):
        raise ValueError(f"unknown tridiagonal solver {mode!r}")
    old, _TRIDIAG_MODE = _TRIDIAG_MODE, mode
    try:
        yield
    finally:
        _TRIDIAG_MODE = old


def _platform(x) -> str:
    """Platform that ``x`` lives on; for a tracer, the platform the traced
    computation is placed on (``jax.default_device`` if set, part of the
    jit key, else the default backend)."""
    try:
        return list(x.devices())[0].platform
    except Exception:
        dev = jax.config.jax_default_device
        if dev is None:
            return jax.default_backend()
        return dev if isinstance(dev, str) else dev.platform


def use_pcr(x) -> bool:
    """True when the PCR path should be used for array ``x``."""
    if _TRIDIAG_MODE == "pcr":
        return True
    if _TRIDIAG_MODE == "thomas":
        return False
    return _platform(x) != "cpu"


def shift0(a, off, fill=0.0):
    """a[i + off] along axis 0, filling out-of-range with ``fill``."""
    n = a.shape[0]
    if off == 0:
        return a
    pad = jnp.full((abs(off),) + a.shape[1:], fill, a.dtype)
    if off > 0:
        return jnp.concatenate([a[off:], pad], axis=0)
    return jnp.concatenate([pad, a[:off]], axis=0)


def pcr(L, D, U, R):
    """Parallel cyclic reduction of a tridiagonal system along axis 0.

    L/D/U/R: (n, ...) with L[0] and U[n-1] ignored/zero. L/D/U may carry a
    trailing broadcast dim of 1 against a stacked R (n, ..., m). Returns x
    with R's shape."""
    n = L.shape[0]
    k = 1
    while k < n:
        Dm = shift0(D, -k, 1.0)
        Dp = shift0(D, k, 1.0)
        alpha = -L / Dm
        beta = -U / Dp
        newD = D + alpha * shift0(U, -k) + beta * shift0(L, k)
        newR = R + alpha * shift0(R, -k) + beta * shift0(R, k)
        newL = alpha * shift0(L, -k)
        newU = beta * shift0(U, k)
        L, D, U, R = newL, newD, newU, newR
        k *= 2
    return R / D
