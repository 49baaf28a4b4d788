"""P3 lookup tables: ice process table (read from the shipped data file) and
generated rain fallspeed/ventilation tables.

Parity reference: micro_p3.F90 p3_init_a (table file parsing, :134-206) and
p3_init_b (numerical generation of vn/vm/revap tables, :236-361). The data
file ``tables/p3_lookup_table_1.dat-v4`` is the reference's published
scientific dataset of precomputed ice-PSD integrals (shipped unmodified).

Batched multilinear interpolation replaces the scalar access_lookup_table /
access_lookup_table_coll routines (micro_p3.F90:1508-1615).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import jax.numpy as jnp

from ...ops import precise
from .constants import (ISIZE, DENSIZE, RIMSIZE, RCOLLSIZE, ICE_TABLE_SIZE,
                        COLLECT_TABLE_SIZE, MU_R_CONSTANT, CONST,
                        LOOKUP_TABLE_1A_DUM1_C)

_TABLE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tables", "p3_lookup_table_1.dat-v4")


@functools.cache
def load_ice_tables():
    """Parse the ice lookup table file -> (ice_table, collect_table) numpy.

    ice_table: (DENSIZE, RIMSIZE, ISIZE, 12); collect_table:
    (DENSIZE, RIMSIZE, ISIZE, RCOLLSIZE, 2) with log10 applied to the
    collection entries (p3_init_a:178-195).
    """
    ice = np.zeros((DENSIZE, RIMSIZE, ISIZE, ICE_TABLE_SIZE))
    coll = np.zeros((DENSIZE, RIMSIZE, ISIZE, RCOLLSIZE, COLLECT_TABLE_SIZE))
    with open(_TABLE_FILE) as f:
        lines = (ln for ln in f if ln.strip() and not
                 ln.lstrip().startswith("VERSION"))
        for jj in range(DENSIZE):
            for ii in range(RIMSIZE):
                for i in range(ISIZE):
                    nums = [float(v) for v in next(lines).split()[2:]]
                    # row: dum,dum,k1..k8,dum,k9..k12  (p3_init_a:181-184)
                    ice[jj, ii, i, 0:8] = nums[2:10]
                    ice[jj, ii, i, 8:12] = nums[11:15]
                for i in range(ISIZE):
                    for j in range(RCOLLSIZE):
                        nums = [float(v) for v in next(lines).split()[2:]]
                        coll[jj, ii, i, j, 0] = np.log10(max(nums[3], 1e-300))
                        coll[jj, ii, i, j, 1] = np.log10(max(nums[4], 1e-300))
    return ice, coll


@functools.cache
def build_rain_tables():
    """Generate rain fallspeed/ventilation tables by PSD integration
    (p3_init_b:288-358). Returns (vn, vm, revap): each (300, 10) numpy."""
    mu_r = MU_R_CONSTANT
    jjs = np.arange(1, 301)
    dm = np.where(jjs <= 20, (jjs * 10.0 - 5.0) * 1e-6,
                  ((jjs - 20) * 30.0 + 195.0) * 1e-6)
    lamr = (mu_r + 1.0) / dm                       # (300,)
    kk = np.arange(1, 10001)
    dd = 2.0
    dia = (kk * dd - dd * 0.5) * 1e-6              # (10000,)
    amg = (np.pi / 6.0) * 997.0 * dia ** 3 * 1000.0  # grams
    vt = np.where(dia * 1e6 <= 134.43, 4.5795e3 * amg ** (2.0 / 3.0),
                  np.where(dia * 1e6 < 1511.64, 4.962e1 * amg ** (1.0 / 3.0),
                           np.where(dia * 1e6 < 3477.84,
                                    1.732e1 * amg ** (1.0 / 6.0), 9.17)))
    ex = np.exp(-lamr[:, None] * dia[None, :])     # (300, 10000)
    w_n = 10.0 ** (mu_r * np.log10(dia) + 4.0 * mu_r)[None, :] * ex * dd * 1e-6
    w_m = 10.0 ** ((mu_r + 3.0) * np.log10(dia) + 4.0 * mu_r)[None, :] * ex * dd * 1e-6
    w_v = ((vt * dia) ** 0.5 *
           10.0 ** ((mu_r + 1.0) * np.log10(dia) + 3.0 * mu_r))[None, :] * ex * dd * 1e-6
    dum1 = (vt[None, :] * w_n).sum(1)
    dum2 = np.maximum(w_n.sum(1), 1e-30)
    dum3 = (vt[None, :] * w_m).sum(1)
    dum4 = np.maximum(w_m.sum(1), 1e-30)
    dum5 = np.maximum(w_v.sum(1), 1e-30)
    vn_col = dum1 / dum2
    vm_col = dum3 / dum4
    revap_col = 10.0 ** (np.log10(dum5) + (mu_r + 1.0) * np.log10(lamr) -
                         3.0 * mu_r)
    # constant mu_r -> all 10 mu columns identical (p3_init_b mu_r_loop)
    vn = np.repeat(vn_col[:, None], 10, axis=1)
    vm = np.repeat(vm_col[:, None], 10, axis=1)
    revap = np.repeat(revap_col[:, None], 10, axis=1)
    return vn, vm, revap


# ---------------------------------------------------------------------------
# index computation + batched interpolation
# ---------------------------------------------------------------------------

def indices_1a(qi, ni, qm, rhop):
    """Ice-table fractional indices (find_lookupTable_indices_1a,
    micro_p3.F90:1620-1677). Returns (dumi, dumjj, dumii, dum1, dum4, dum5)
    with integer indices ZERO-based."""
    dum1 = (jnp.log10(qi / jnp.maximum(ni, 1e-300)) + 18.0) * \
        LOOKUP_TABLE_1A_DUM1_C - 10.0
    dumi = jnp.floor(dum1).astype(jnp.int32)
    dum1 = jnp.clip(dum1, 1.0, float(ISIZE))
    dumi = jnp.clip(dumi, 1, ISIZE - 1)
    dum4 = (qm / jnp.maximum(qi, 1e-300)) * 3.0 + 1.0
    dumii = jnp.floor(dum4).astype(jnp.int32)
    dum4 = jnp.clip(dum4, 1.0, float(RIMSIZE))
    dumii = jnp.clip(dumii, 1, RIMSIZE - 1)
    dum5 = jnp.where(rhop <= 650.0, (rhop - 50.0) * 0.005 + 1.0,
                     (rhop - 650.0) * 0.004 + 4.0)
    dumjj = jnp.floor(dum5).astype(jnp.int32)
    dum5 = jnp.clip(dum5, 1.0, float(DENSIZE))
    dumjj = jnp.clip(dumjj, 1, DENSIZE - 1)
    return dumi - 1, dumjj - 1, dumii - 1, dum1 - 1, dum4 - 1, dum5 - 1


def indices_1b(qr, nr):
    """Rain-collection fractional index (find_lookupTable_indices_1b,
    :1681-1720). Zero-based."""
    active = (qr >= 1e-14) & (nr > 0.0)
    dumlr = jnp.cbrt(qr / (np.pi * CONST.rho_h2o * jnp.maximum(nr, 1e-300)))
    dum3 = (jnp.log10(jnp.maximum(dumlr, 1e-300)) + 5.0) * 10.70415
    dumj = jnp.floor(dum3).astype(jnp.int32)
    dum3 = jnp.clip(dum3, 1.0, float(RCOLLSIZE))
    dumj = jnp.clip(dumj, 1, RCOLLSIZE - 1)
    dumj = jnp.where(active, dumj, 1)
    dum3 = jnp.where(active, dum3, 1.0)
    return dumj - 1, dum3 - 1


def indices_3(mu_r, lamr):
    """Rain-table fractional indices (find_lookupTable_indices_3,
    :1725-1770). Zero-based."""
    dum1 = (mu_r + 1.0) / jnp.maximum(lamr, 1e-300)
    small = dum1 <= 195.0e-6
    rdumii_s = jnp.clip((dum1 * 1e6 + 5.0) * 0.1, 1.0, 20.0)
    rdumii_l = jnp.clip((dum1 * 1e6 - 195.0) / 30.0 + 20.0, 20.0, 300.0)
    rdumii = jnp.where(small, rdumii_s, rdumii_l)
    dumii = jnp.floor(rdumii).astype(jnp.int32)
    dumii = jnp.where(small, jnp.clip(dumii, 1, 20), jnp.clip(dumii, 20, 299))
    rdumjj = jnp.clip(mu_r + 1.0, 1.0, 10.0)
    dumjj = jnp.clip(jnp.floor(rdumjj).astype(jnp.int32), 1, 9)
    return dumii - 1, dumjj - 1, rdumii - 1, rdumjj - 1


# ---------------------------------------------------------------------------
# Table interpolation as hat-weight contractions instead of gathers.
#
# The reference interpolates per-thread with scalar loads
# (access_lookup_table, micro_p3.F90:1508-1615). Since every fractional
# index x satisfies floor-index <= x <= floor-index+1 (the indices_*
# functions clip them that way), linear interpolation along an axis of
# length n is EXACTLY a contraction with the dense hat weights
# w[k] = max(0, 1 - |k - x|), so the whole multilinear interpolation is a
# few small contractions. Algebraically identical to the nested-lerp form
# (same two nonzero weights per axis). The contractions run at full
# precision (pam_tpu.ops.precise).
# ---------------------------------------------------------------------------

def _hat(n, x):
    """(..., n) dense linear-interp weights for fractional position x."""
    k = jnp.arange(n, dtype=x.dtype)
    return jnp.maximum(0.0, 1.0 - jnp.abs(k - x[..., None]))


def access_ice_table(tab, dumjj, dumii, dumi, index, dum1, dum4, dum5):
    """Trilinear interpolation in (density, rime fraction, size)
    (access_lookup_table, micro_p3.F90:1508-1545). ``index`` is zero-based
    and static; dumjj/dumii/dumi are accepted for signature parity (the
    hat weights encode them via the fractional positions)."""
    t = jnp.asarray(tab[..., index], dum1.dtype)   # (DENSIZE, RIMSIZE, ISIZE)
    wi = _hat(t.shape[2], dum1)
    wii = _hat(t.shape[1], dum4)
    wjj = _hat(t.shape[0], dum5)
    T1 = precise.einsum('...i,jki->...jk', wi, t)  # (P,ISIZE)x(ISIZE,20)
    T2 = precise.einsum('...k,...jk->...j', wii, T1)
    return precise.einsum('...j,...j->...', wjj, T2)


def access_ice_table_multi(tab, indices, dum1, dum4, dum5):
    """Trilinear interpolation of SEVERAL static table indices sharing one
    set of fractional positions — the common case in p3_main_part2/part3
    and ice sedimentation, where ~4-7 quantities are read at the same
    (dum1, dum4, dum5). One batched contraction replaces K separate
    access_lookup_table calls (micro_p3.F90:1508-1545): the (P, ISIZE) /
    (P, RIMSIZE) / (P, DENSIZE) hat-weight arrays are read ONCE from HBM
    instead of K times, and the K dots merge into one matmul.
    Returns a tuple of K arrays in the order of ``indices``."""
    t = jnp.asarray(tab[..., list(indices)], dum1.dtype)  # (5, 4, ISIZE, K)
    wi = _hat(t.shape[2], dum1)
    wii = _hat(t.shape[1], dum4)
    wjj = _hat(t.shape[0], dum5)
    T1 = precise.einsum('...i,jkie->...jke', wi, t)   # (P,ISIZE)x(ISIZE,20K)
    T2 = precise.einsum('...k,...jke->...je', wii, T1)
    out = precise.einsum('...j,...je->...e', wjj, T2)
    return tuple(out[..., n] for n in range(len(indices)))


def access_collect_table(tab, dumjj, dumii, dumj, dumi, index, dum1, dum3,
                         dum4, dum5):
    """Quadrilinear interpolation incl. the rain-size axis
    (access_lookup_table_coll, :1548-1615), as hat-weight contractions."""
    t = jnp.asarray(tab[..., index], dum1.dtype)   # (5, 4, ISIZE, RCOLLSIZE)
    wi = _hat(t.shape[2], dum1)
    wj = _hat(t.shape[3], dum3)
    wii = _hat(t.shape[1], dum4)
    wjj = _hat(t.shape[0], dum5)
    # contract the two large axes in one step
    T1 = precise.einsum('...i,...j,abij->...ab', wi, wj, t)
    T2 = precise.einsum('...b,...ab->...a', wii, T1)
    return precise.einsum('...a,...a->...', wjj, T2)


def access_collect_table_multi(tab, indices, dum1, dum3, dum4, dum5):
    """Quadrilinear interpolation of several collection-table entries
    sharing one set of fractional positions (both entries of
    access_lookup_table_coll, :1548-1615, are always read together in
    part2). One joint contraction over the two large axes halves the
    hat-weight HBM reads and merges the two big reduce fusions.
    Returns a tuple in the order of ``indices``."""
    t = jnp.asarray(tab[..., list(indices)], dum1.dtype)  # (5,4,I,J,K)
    wi = _hat(t.shape[2], dum1)
    wj = _hat(t.shape[3], dum3)
    wii = _hat(t.shape[1], dum4)
    wjj = _hat(t.shape[0], dum5)
    T1 = precise.einsum('...i,...j,abije->...abe', wi, wj, t)
    T2 = precise.einsum('...b,...abe->...ae', wii, T1)
    out = precise.einsum('...a,...ae->...e', wjj, T2)
    return tuple(out[..., n] for n in range(len(indices)))


def access_rain_table(tab, dumii, dumjj, rdumii, rdumjj):
    """Bilinear interpolation in the rain (size, mu) tables
    (compute_rain_fall_velocity, :3893-3907), as hat-weight contractions."""
    t = jnp.asarray(tab, rdumii.dtype)             # (300, 10)
    wi = _hat(t.shape[0], rdumii)
    wj = _hat(t.shape[1], rdumjj)
    T1 = precise.einsum('...i,ij->...j', wi, t)       # (P,300)x(300,10)
    return precise.einsum('...j,...j->...', wj, T1)


def access_rain_table_multi(tabs, rdumii, rdumjj):
    """Bilinear interpolation of several rain tables (vn + vm are always
    read at the same fractional position in sedimentation,
    compute_rain_fall_velocity :3893-3907) in one batched contraction.
    ``tabs``: sequence of (300, 10) arrays. Returns a tuple."""
    t = jnp.stack([jnp.asarray(a, rdumii.dtype) for a in tabs],
                  axis=-1)                          # (300, 10, K)
    wi = _hat(t.shape[0], rdumii)
    wj = _hat(t.shape[1], rdumjj)
    T1 = precise.einsum('...i,ije->...je', wi, t)     # (P,300)x(300,10K)
    return tuple(precise.einsum('...j,...j->...', wj, T1[..., n])
                 for n in range(t.shape[-1]))
