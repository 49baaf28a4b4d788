"""Matmul-based DFTs for the semi-implicit spectral solves.

The reference computes its SI solves with pocketfft-style FFTs along x
(yakl::RealFFT1D, extrudedmodel.h:2533-2592). Here CRM-sized transforms
(nx = 65 in the production MMF config) are explicit DFT matmuls:

* GSPMD partitions a contraction over batch dims trivially, while the
  ``fft`` HLO is unpartitionable on batch-sharded operands — XLA inserts
  an all-gather over the ensemble dim per FFT call (24 all-gathers per
  SPAM+SI step at ensemble sharding, counted in the compiled HLO), which
  would serialize the embarrassingly-parallel ensemble axis;
* under x-sharding the forward transform becomes a local contraction and
  one psum (below);
* O(n^2) vs O(n log n) is irrelevant at n <= a few hundred. (The GPU
  time of either form: not measured.)

Every contraction runs at Precision.HIGHEST (pam_tpu.ops.precise): at
default precision an f32 matmul on a GPU may use TF32 (~3 digits).
For large n, fall back to ``jnp.fft`` (threshold PAM_DFT_MATMUL_MAX,
default 1024).

All transforms are along a given axis with numpy-compatible conventions
(fft/ifft/rfft/irfft). Matrices are built in float64 numpy at trace time
and cast to the input dtype.
"""

from __future__ import annotations

import os
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
from . import precise

_MATMUL_MAX = int(os.environ.get("PAM_DFT_MATMUL_MAX", "1024"))


@lru_cache(maxsize=None)
def _dft_mats(n: int):
    """(cos, sin) with cos[k, j] = cos(2*pi*k*j/n), sin likewise."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    ang = 2.0 * np.pi * (k * j % n) / n
    return np.cos(ang), np.sin(ang)


def _contract(a, m, axis):
    """sum_j a[..., j, ...] m[k, j] -> out[..., k, ...] along axis."""
    a = jnp.moveaxis(a, axis, -1)
    out = precise.einsum('...j,kj->...k', a, jnp.asarray(m, a.dtype),
                     optimize=True)
    return jnp.moveaxis(out, -1, axis)


def _use_matmul(n: int) -> bool:
    return n <= _MATMUL_MAX


def fft(a, axis: int = -1):
    """numpy-convention DFT: A[k] = sum_j a[j] exp(-2i pi jk/n)."""
    n = a.shape[axis]
    if not _use_matmul(n):
        return jnp.fft.fft(a, axis=axis)
    cos, sin = _dft_mats(n)
    if jnp.iscomplexobj(a):
        re, im = jnp.real(a), jnp.imag(a)
        out_re = _contract(re, cos, axis) + _contract(im, sin, axis)
        out_im = _contract(im, cos, axis) - _contract(re, sin, axis)
    else:
        out_re = _contract(a, cos, axis)
        out_im = -_contract(a, sin, axis)
    return out_re + 1j * out_im


def ifft(a, axis: int = -1):
    """Inverse DFT (with 1/n normalization)."""
    n = a.shape[axis]
    if not _use_matmul(n):
        return jnp.fft.ifft(a, axis=axis)
    cos, sin = _dft_mats(n)
    re, im = jnp.real(a), jnp.imag(a)
    out_re = (_contract(re, cos, axis) - _contract(im, sin, axis)) / n
    out_im = (_contract(im, cos, axis) + _contract(re, sin, axis)) / n
    return out_re + 1j * out_im


def ifft_real(a, axis: int = -1):
    """real(ifft(a)) without forming the imaginary part."""
    n = a.shape[axis]
    if not _use_matmul(n):
        return jnp.real(jnp.fft.ifft(a, axis=axis))
    cos, sin = _dft_mats(n)
    re, im = jnp.real(a), jnp.imag(a)
    return (_contract(re, cos, axis) - _contract(im, sin, axis)) / n


# ---------------------------------------------------------------------------
# x-sharding-aware transforms for the SI spectral solves
# ---------------------------------------------------------------------------
#
# Under manual x-sharding (pam_tpu.parallel.comm axis context), the forward
# DFT along x is computed as a LOCAL contraction of the device's x block
# against the matching columns of the DFT matrix, followed by one
# ``lax.psum`` over the x mesh axis — so spectral space comes out fully
# replicated on every x device (device-invariant). The vertical tridiagonal
# solve then runs redundantly per device (cheap: nx is small, z-scan cost
# ~(nens nz nx)/chip), and the INVERSE transform needs zero communication:
# each device contracts full spectral space against its own rows of the
# inverse matrix. Net comm per solve = one k-space psum per forward
# transform; compare MPI rank-local FFTs in the reference, which cannot
# shard x at all (extrudedmodel.h:2948).

def _psum_contract_x(a, m):
    """sum_j a[..., j] m[k, j] with j possibly x-sharded -> replicated k."""
    from ..parallel import comm
    name = comm.active_x_axis()
    if name is None:
        return precise.einsum('...j,kj->...k', a, jnp.asarray(m, a.dtype),
                          optimize=True)
    mloc = comm.local_xslice(jnp.asarray(m, a.dtype), x_dim=-1)
    part = precise.einsum('...j,kj->...k', a, mloc, optimize=True)
    from jax import lax
    return lax.psum(part, name)


def _rowslice_contract_x(A, m):
    """out[..., j_local] = sum_k A[..., k] m[j, k] with j x-sharded rows."""
    from ..parallel import comm
    name = comm.active_x_axis()
    mm = jnp.asarray(m, A.dtype)
    if name is not None:
        mm = comm.local_xslice(mm, x_dim=0)
    return precise.einsum('...k,jk->...j', A, mm, optimize=True)


def fft_sh(a, axis: int = -1):
    """Real-input full DFT along a (possibly x-sharded) trailing axis;
    returns replicated-in-x spectral coefficients."""
    from ..parallel import comm
    if comm.x_shards() == 1:
        return fft(a, axis=axis)
    n_total = a.shape[axis] * comm.x_shards()
    assert axis in (-1, a.ndim - 1), "sharded DFT is along the last axis"
    cos, sin = _dft_mats(n_total)
    out_re = _psum_contract_x(a, cos)
    out_im = -_psum_contract_x(a, sin)
    return out_re + 1j * out_im


def ifft_real_sh(a, axis: int = -1):
    """real(ifft) back to the LOCAL x block (rows sliced; no comm)."""
    from ..parallel import comm
    if comm.x_shards() == 1:
        return ifft_real(a, axis=axis)
    n = a.shape[axis]
    assert axis in (-1, a.ndim - 1), "sharded DFT is along the last axis"
    cos, sin = _dft_mats(n)
    re, im = jnp.real(a), jnp.imag(a)
    return (_rowslice_contract_x(re, cos.T) -
            _rowslice_contract_x(im, sin.T)) / n


def rfft_sh(a, axis: int = -1):
    """Real-input rfft along a (possibly x-sharded) trailing axis."""
    from ..parallel import comm
    if comm.x_shards() == 1:
        return rfft(a, axis=axis)
    n_total = a.shape[axis] * comm.x_shards()
    assert axis in (-1, a.ndim - 1), "sharded DFT is along the last axis"
    cos, sin = _dft_mats(n_total)
    nr = n_total // 2 + 1
    out_re = _psum_contract_x(a, cos[:nr])
    out_im = -_psum_contract_x(a, sin[:nr])
    return out_re + 1j * out_im


def irfft_sh(a, n: int, axis: int = -1):
    """Inverse rfft back to the LOCAL x block (no comm)."""
    from ..parallel import comm
    if comm.x_shards() == 1:
        return irfft(a, n, axis=axis)
    assert axis in (-1, a.ndim - 1), "sharded DFT is along the last axis"
    cos, sin = _dft_mats(n)
    nr = n // 2 + 1
    w = np.full(nr, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    re, im = jnp.real(a), jnp.imag(a)
    out = _rowslice_contract_x(re, (w[:, None] * cos[:nr]).T) - \
        _rowslice_contract_x(im, (w[:, None] * sin[:nr]).T)
    return out / n


def rfft(a, axis: int = -1):
    """Real-input DFT, first n//2+1 bins (numpy rfft convention)."""
    n = a.shape[axis]
    if not _use_matmul(n):
        return jnp.fft.rfft(a, axis=axis)
    cos, sin = _dft_mats(n)
    nr = n // 2 + 1
    out_re = _contract(a, cos[:nr], axis)
    out_im = -_contract(a, sin[:nr], axis)
    return out_re + 1j * out_im


def irfft(a, n: int, axis: int = -1):
    """Inverse of rfft back to length n (numpy irfft convention)."""
    if not _use_matmul(n):
        return jnp.fft.irfft(a, n=n, axis=axis)
    cos, sin = _dft_mats(n)
    nr = n // 2 + 1
    # weights for hermitian expansion: bins 1..ceil(n/2)-1 count twice
    w = np.full(nr, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    re, im = jnp.real(a), jnp.imag(a)
    # x[j] = (1/n) sum_k w_k (re_k cos(2pi jk/n) - im_k sin(2pi jk/n))
    out = _contract(re, (w[:, None] * cos[:nr]).T, axis) - \
        _contract(im, (w[:, None] * sin[:nr]).T, axis)
    return out / n
