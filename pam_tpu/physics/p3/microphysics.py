"""P3 microphysics coupler wrapper.

Parity reference: physics/micro/p3/Microphysics.h — registers the 9 P3
tracers (:119-127), converts coupler densities to dry mixing ratios, builds
exner/theta/dpres_dry inputs (:344-385), runs the column scheme, and maps
results back with the constant-volume cv/cp temperature correction
(:676-704).

Orientation note: the scheme (pam_tpu.physics.p3.main) works top-down
(k=0 = top), so columns are flipped on the way in and out — matching the
reference's C++ (P3_CXX) path (`k_p3 = nz-1-k`, Microphysics.h:463).

State carried across calls (q_prev as a density, t_prev, Microphysics.h:
700-703) lives in the coupler state dict; ``init_state`` seeds it.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ...core.coupler import Coupler
from ...modules.saturation import compute_adjusted_state
from .constants import CONST
from .main import p3_main

C = CONST

TRACER_NAMES = ("cloud_water", "cloud_water_num", "rain", "rain_num", "ice",
                "ice_num", "ice_rime", "ice_rime_vol", "water_vapor")


def register(coupler: Coupler) -> Coupler:
    """Add P3's 9 tracers (ref: Microphysics::init, Microphysics.h:119-127).
    Number concentrations and rime fields carry no mass (rime mass is a
    subset of ice mass)."""
    cpl = coupler
    cpl = cpl.add_tracer("cloud_water", "Cloud Water Mass", True, True)
    cpl = cpl.add_tracer("cloud_water_num", "Cloud Water Number", True, False)
    cpl = cpl.add_tracer("rain", "Rain Water Mass", True, True)
    cpl = cpl.add_tracer("rain_num", "Rain Water Number", True, False)
    cpl = cpl.add_tracer("ice", "Ice Mass", True, True)
    cpl = cpl.add_tracer("ice_num", "Ice Number", True, False)
    cpl = cpl.add_tracer("ice_rime", "Ice-Rime Mass", True, False)
    cpl = cpl.add_tracer("ice_rime_vol", "Ice-Rime Volume", True, False)
    cpl = cpl.add_tracer("water_vapor", "Water Vapor", True, True)
    return cpl.with_options(micro="p3")


def init_state(coupler: Coupler, state):
    """Seed persistent fields (ref: Microphysics.h:135-143 registration and
    the first_step branch :379-381). Call AFTER water_vapor/temp are set."""
    cpl = coupler
    out = dict(state)
    shape = (cpl.nens, cpl.nz, cpl.ny, cpl.nx)
    z = lambda: jnp.zeros(shape, cpl.dtype)
    out.setdefault("q_prev", jnp.asarray(state["water_vapor"]))
    out.setdefault("t_prev", jnp.asarray(state["temp"]))
    for name in ("nc_nuceat_tend", "nccn_prescribed", "ni_activated",
                 "liq_ice_exchange_out", "vap_liq_exchange_out",
                 "vap_ice_exchange_out"):
        out.setdefault(name, z())
    out.setdefault("inv_qc_relvar", jnp.ones(shape, cpl.dtype))
    out.setdefault("precip_liq_surf_out",
                   jnp.zeros((cpl.nens, cpl.ny, cpl.nx), cpl.dtype))
    out.setdefault("precip_ice_surf_out",
                   jnp.zeros((cpl.nens, cpl.ny, cpl.nx), cpl.dtype))
    return out


def _to_cols(a, nz):
    """(nens, nz, ny, nx) -> (nz, ny*nx, nens) with k flipped to top-down.

    z-major / ensemble-minor column layout (the Kessler precedent): the
    transpose from the dycore's (nens, nz, ny, nx) is a layout RELABEL of
    the z-major/ens-minor physical layout XLA already assigns those
    fields, and the ensemble axis is the contiguous one. The ensemble stays its OWN (trailing) array axis — never
    merged into a flattened column dim — so ensemble sharding remains
    representable without all-gathers (GSPMD cannot shard the minor
    component of a merged dimension; caught by
    tools/comm_volume.py + tests/test_halo.py)."""
    return jnp.transpose(a, (1, 2, 3, 0)).reshape(nz, -1, a.shape[0])[::-1]


def _from_cols(a, shape):
    nens, nz, ny, nx = shape
    return jnp.transpose(a[::-1].reshape(nz, ny, nx, nens), (3, 0, 1, 2))


def _to_cols_batch(arrays, nz):
    """Convert many (nens, nz, ny, nx) fields at once: ONE stacked
    transpose + flip kernel instead of one per field (the per-field form
    costs ~2 layout kernels each; the unstacking slices fuse into the
    consumers)."""
    st = jnp.stack(arrays)                     # (F, nens, nz, ny, nx)
    c = jnp.transpose(st, (0, 2, 3, 4, 1)).reshape(
        st.shape[0], nz, -1, st.shape[1])
    c = c[:, ::-1]
    return [c[i] for i in range(st.shape[0])]


def _from_cols_batch(arrays, shape):
    """Inverse of :func:`_to_cols_batch` for many (nz, nyx, nens)."""
    nens, nz, ny, nx = shape
    st = jnp.stack(arrays)                     # (F, nz, nyx, nens)
    r = jnp.transpose(st[:, ::-1].reshape(st.shape[0], nz, ny, nx, nens),
                      (0, 4, 1, 2, 3))
    return [r[i] for i in range(st.shape[0])]


@dataclasses.dataclass(frozen=True)
class P3Micro:
    """Coupler-facing wrapper (analog of Microphysics::timeStep,
    Microphysics.h:225-722)."""
    coupler: Coupler
    sgs_shoc: bool = False

    @property
    def name(self) -> str:
        return "p3"

    def timestep(self, state, dt):
        cpl = self.coupler
        # derive shapes from the arrays, NOT the coupler dims: under a
        # shard_map the local x/y extents are the per-device shards
        shape = state["temp"].shape
        nens, nz, ny, nx = shape
        out = dict(state)

        rho_d = state["density_dry"]
        temp = state["temp"]
        rho_v = state["water_vapor"]
        rho_c = state["cloud_water"]

        if not self.sgs_shoc:
            # saturation adjustment replaces a macrophysics scheme
            # (Microphysics.h:344-348)
            rho_v, rho_c, temp = compute_adjusted_state(
                rho_d + rho_v, rho_d, rho_v, rho_c, temp,
                C.rv, C.cp, 1859.0, C.cpw)

        # dry mixing ratios + thermodynamic inputs (Microphysics.h:349-374)
        dens = {"qc": rho_c, "qv": rho_v}
        for key, name in (("nc", "cloud_water_num"), ("qr", "rain"),
                          ("nr", "rain_num"), ("qi", "ice"),
                          ("ni", "ice_num"), ("qm", "ice_rime"),
                          ("bm", "ice_rime_vol")):
            dens[key] = state[name]

        pressure = C.rd * rho_d * temp + C.rv * rho_v * temp
        exner = (pressure / 1.0e5) ** (C.rd / C.cp)
        inv_exner = 1.0 / exner
        theta = temp * inv_exner
        zint = state["vertical_interface_height"]      # (nens, nz+1)
        dz = (zint[:, 1:] - zint[:, :-1])[:, :, None, None] * \
            jnp.ones(shape, cpl.dtype)
        pres_dry = C.rd * rho_d * temp
        dpres_dry = rho_d * C.g * dz

        # all inputs through ONE batched layout conversion
        # (q_prev carried as a density -> mixing ratio, Microphysics.h:382-384)
        qkeys = list(dens.keys())
        fields = [dens[k] / rho_d for k in qkeys] + [
            theta, pres_dry, dz, state["nc_nuceat_tend"],
            state["ni_activated"], state["inv_qc_relvar"], dpres_dry,
            inv_exner, state["q_prev"] / rho_d, state["t_prev"],
            state["nccn_prescribed"]]
        cols = _to_cols_batch(fields, nz)
        q = dict(zip(qkeys, cols[:len(qkeys)]))
        (th_c, pres_c, dz_c, nuceat_c, niact_c, relvar_c, dpres_c,
         invex_c, q_prev, t_prev, nccn_c) = cols[len(qkeys):]
        ones = jnp.ones_like(q["qc"])

        st, diag = p3_main(
            qc=q["qc"], nc=q["nc"], qr=q["qr"], nr=q["nr"], qv=q["qv"],
            th=th_c, qi=q["qi"], qm=q["qm"], ni=q["ni"],
            bm=q["bm"], pres=pres_c, dz=dz_c,
            nc_nuceat_tend=nuceat_c, ni_activated=niact_c,
            inv_qc_relvar=relvar_c, dt=dt,
            dpres=dpres_c, inv_exner=invex_c,
            qv_prev=q_prev, t_prev=t_prev, cld_frac_i=ones, cld_frac_l=ones,
            cld_frac_r=ones, nccn_prescribed=nccn_c)

        # post-process (Microphysics.h:676-704); one batched conversion back
        out_keys = ("qc", "nc", "qr", "nr", "qi", "ni", "qm", "bm", "qv")
        backs = _from_cols_batch(
            [st[k] for k in out_keys] + [st["th"], diag["liq_ice_exchange"],
                                         diag["vap_liq_exchange"],
                                         diag["vap_ice_exchange"]], shape)
        for key, name in zip(out_keys,
                             ("cloud_water", "cloud_water_num", "rain",
                              "rain_num", "ice", "ice_num", "ice_rime",
                              "ice_rime_vol", "water_vapor")):
            out[name] = jnp.maximum(backs[out_keys.index(key)] * rho_d, 0.0)
        # constant-volume correction: scale dT by cv/cp (Microphysics.h:
        # 692-698); theta defined wrt the pre-micro exner
        temp_new = backs[len(out_keys)] * exner
        out["temp"] = temp + (temp_new - temp) * (C.cp - C.rd) / C.cp
        out["q_prev"] = out["water_vapor"]
        out["t_prev"] = out["temp"]
        out["liq_ice_exchange_out"] = backs[len(out_keys) + 1]
        out["vap_liq_exchange_out"] = backs[len(out_keys) + 2]
        out["vap_ice_exchange_out"] = backs[len(out_keys) + 3]
        def _sfc(a):
            # (nyx, nens) -> (nens, ny, nx)
            return jnp.transpose(a.reshape(ny, nx, nens), (2, 0, 1))
        out["precip_liq_surf_out"] = _sfc(st["precip_liq_surf"])
        out["precip_ice_surf_out"] = _sfc(st["precip_ice_surf"])
        return out
