"""MMF standalone driver: GCM loop × CRM physics loop.

Parity reference: standalone/mmf_simplified/driver.cpp:237-272 — per GCM
step compute forcing tendencies, then per CRM step apply forcing → dycore →
sponge → sgs → micro. Here the whole CRM physics step is one jitted pure
function over the state pytree; the GCM loop stays in Python (it is the
host-coupling boundary in real MMF use).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..core.coupler import Coupler
from ..dycore.awfl import AwflDycore
from ..modules import gcm_forcing, sponge
from ..modules.broadcast import broadcast_initial_gcm_column
from ..modules.perturb import perturb_temperature
from . import supercell_column


def pick_ens_chunk(nx: int, ny: int, nz: int, dtype=jnp.float32,
                   nens_total: int = None) -> int:
    """Ensemble chunk for ``ens_chunk: auto``: the whole ensemble.

    On an H100 (700 W) the production P3+SHOC step at nens=512 (65x1x50,
    f32) takes 39.975 ms per CRM step in one piece against 41.496 ms as
    four host-dispatched chunks of 128 (medians of four rounds,
    tools/step_ab.py); the card has no small on-chip memory for chunks to
    fit in. One piece compiles slower (85 s against 66 s). An explicit
    ``ens_chunk: <int>`` still chunks. The grid arguments are kept for
    callers; without ``nens_total`` the answer is 1."""
    del nx, ny, nz, dtype
    return max(1, nens_total or 1)


@functools.partial(jax.jit, static_argnums=1)
def _split_ens(state, n_chunks):
    """Split every state leaf into n_chunks along the ensemble axis —
    ONE dispatch (returns a tuple of chunk states)."""
    def leaf(a):
        c = a.shape[0] // n_chunks
        return tuple(a[i * c:(i + 1) * c] for i in range(n_chunks))
    per_leaf = {k: leaf(v) for k, v in state.items()}
    return tuple({k: v[i] for k, v in per_leaf.items()}
                 for i in range(n_chunks))


@jax.jit
def _join_ens(chunks):
    """Concatenate chunk states back to the full ensemble — ONE dispatch."""
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *chunks)


@dataclasses.dataclass(eq=False)
class MmfDriver:
    """Composes dycore + physics into jitted GCM/CRM step functions."""
    coupler: Coupler
    dycore: Any
    micro: Any = None
    sgs: Any = None
    rad: Any = None
    apply_sponge: bool = True
    apply_gcm_forcing: bool = True
    dt_gcm: float = 900.0
    dt_crm_phys: float = 20.0
    # micro-batch routing of :meth:`run` when the state carries more
    # members than the driver was built with:
    #   "host"     — dispatch the single-chunk jit per chunk, state kept
    #                chunked across the GCM loop; compile stays at the
    #                single-chunk cost;
    #   "unrolled" — one jit over barrier-chained chunks (single dispatch
    #                per step, for host-sync-constrained embeddings).
    # Both give bitwise-identical results.
    mb_mode: str = "host"

    def crm_phys_step(self, state):
        """One CRM physics step (jit this).

        Auto micro-batching: if ``state`` carries MORE ensemble members
        than the driver was built with (an exact multiple), the step
        routes through :meth:`crm_phys_step_microbatched` with
        n_chunks = total/built, so a driver sized at the chunk
        (:func:`pick_ens_chunk`) takes any larger ensemble. Shapes are
        static under jit, so the routing is trace-time."""
        total = int(state["temp"].shape[0])
        built = int(self.coupler.nens)
        if total != built:
            if total % built != 0:
                raise ValueError(
                    f"state carries nens={total} but the driver was built "
                    f"with nens={built}; micro-batching needs an exact "
                    f"multiple")
            return self.crm_phys_step_microbatched(state, total // built)
        return self._crm_phys_step_single(state)

    def _crm_phys_step_single(self, state):
        cpl = self.coupler
        if self.apply_gcm_forcing:
            state = gcm_forcing.apply_gcm_forcing_tendencies(
                cpl, state, self.dt_crm_phys, self.dt_gcm)
        state = self.dycore.timestep(state, self.dt_crm_phys)
        if self.apply_sponge:
            state = sponge.sponge_layer(cpl, state, self.dt_crm_phys)
        if self.sgs is not None:
            state = self.sgs.timestep(state, self.dt_crm_phys)
        if self.micro is not None:
            state = self.micro.timestep(state, self.dt_crm_phys)
        if self.rad is not None:
            state = self.rad.timestep(state, self.dt_crm_phys)
        return state

    def gcm_step(self, state):
        """One full GCM step: forcing tendencies + n CRM steps (jit this).

        Single-dispatch convenience for host-sync-constrained embeddings;
        :meth:`run` dispatches per CRM step instead (the scanned form's
        speed on the GPU: not measured)."""
        cpl = self.coupler
        if self.apply_gcm_forcing:
            state = gcm_forcing.compute_gcm_forcing_tendencies(
                cpl, state, self.dt_gcm)
        nsteps = int(round(self.dt_gcm / self.dt_crm_phys))

        def body(s, _):
            return self.crm_phys_step(s), None

        state, _ = jax.lax.scan(body, state, None, length=nsteps)
        return state

    def crm_phys_step_microbatched(self, state, n_chunks: int):
        """crm_phys_step over the ensemble in ``n_chunks`` sequential
        micro-batches (unrolled for small n_chunks; ``lax.map`` beyond).

        Ensemble members are independent CRMs, so chunks can run
        back-to-back in one program. This driver must have been built with nens = total/n_chunks (the reference
        columns baked into the dycore are chunk-sized); ``state`` carries
        the full ensemble. The only cross-member coupling in a step is
        Kessler's batched rainsplit min, which becomes per-chunk (the same
        documented deviation as KesslerMicro.ens_chunk)."""
        nens = self.coupler.nens * n_chunks
        for k, v in state.items():
            if hasattr(v, "shape") and (v.ndim == 0 or
                                        v.shape[0] != nens):
                raise ValueError(
                    f"crm_phys_step_microbatched: state[{k!r}] has shape "
                    f"{getattr(v, 'shape', ())}; every leaf must carry the "
                    f"full ensemble (leading axis {nens} = driver nens "
                    f"{self.coupler.nens} x n_chunks {n_chunks})")

        def split(a):
            return a.reshape((n_chunks, a.shape[0] // n_chunks) +
                             a.shape[1:])

        def join(a):
            return a.reshape((-1,) + a.shape[2:])

        if n_chunks <= 8:
            # UNROLL small chunk counts: static slices let XLA assign
            # layouts globally across the chunk bodies, where the lax.map
            # loop boundary forces per-chunk relabel copies and
            # dynamic-update-slice result stitching
            import os
            serialize = os.environ.get("PAM_MB_SERIALIZE", "1") != "0"
            outs = []
            for i in range(n_chunks):
                chunk = jax.tree.map(
                    lambda a: a[i * (a.shape[0] // n_chunks):
                                (i + 1) * (a.shape[0] // n_chunks)], state)
                if serialize and outs:
                    # barrier-chain the chunks so XLA runs them one after
                    # another instead of interleaving their schedules (the
                    # barrier only constrains the schedule, results are
                    # identical). PAM_MB_SERIALIZE=0 disables it.
                    chunk, _ = jax.lax.optimization_barrier(
                        (chunk, outs[-1]))
                outs.append(self._crm_phys_step_single(chunk))
            return jax.tree.map(
                lambda *xs: jnp.concatenate(xs, axis=0), *outs)
        chunked = jax.tree.map(split, state)
        out = jax.lax.map(self._crm_phys_step_single, chunked)
        return jax.tree.map(join, out)

    def _jitted_single(self):
        """The singly-compiled chunk-step executable (cached)."""
        if self.__dict__.get("_jit_single_cache") is None:
            self._jit_single_cache = jax.jit(self._crm_phys_step_single)
        return self._jit_single_cache

    def _jitted_forcing(self):
        """The compiled GCM-forcing computation (cached, so repeated
        :meth:`run` calls do not recompile it)."""
        if self.__dict__.get("_jit_forcing_cache") is None:
            self._jit_forcing_cache = jax.jit(
                lambda s: gcm_forcing.compute_gcm_forcing_tendencies(
                    self.coupler, s, self.dt_gcm))
        return self._jit_forcing_cache

    def crm_phys_step_hostchunked(self, state):
        """Ensemble micro-batching by HOST dispatch: the single-chunk jit
        is dispatched once per chunk instead of unrolling all chunks into
        one program (:meth:`crm_phys_step_microbatched`).

        Do NOT wrap this in ``jax.jit`` — the chunk loop must stay on the
        host. The device executes the queued chunk programs in dispatch
        order, and compile time stays at the SINGLE-chunk cost whatever
        n_chunks is. Results are bitwise identical to the unrolled path
        (both run the same chunk program over the same chunk slices). The
        costs are one split + one join dispatch (two extra full-state
        copies) and one host dispatch per chunk. :meth:`run` keeps the state chunked across the whole GCM loop,
        paying the split/join only once per run."""
        total = int(state["temp"].shape[0])
        built = int(self.coupler.nens)
        if total % built != 0:
            raise ValueError(
                f"state carries nens={total} but the driver was built "
                f"with nens={built}; micro-batching needs an exact "
                f"multiple")
        n_chunks = total // built
        step = self._jitted_single()
        if n_chunks == 1:
            return step(state)
        chunks = _split_ens(state, n_chunks)
        return _join_ens(tuple(step(c) for c in chunks))

    def run(self, state, sim_time: float, callback: Callable = None):
        """Python-level GCM loop (ref: driver.cpp:237-272).

        Dispatches the CRM step once per CRM step from the host rather
        than one jitted ``gcm_step`` per GCM step. With ``mb_mode="host"``
        (or a single chunk) the state is split once into driver-sized
        chunks (forcing is per-member, so it chunks too), each chunk is
        stepped by the singly-compiled chunk step, and the chunks are
        joined only for callbacks and at the end; compile cost is that of
        one chunk whatever the ensemble size. Otherwise each step is one
        jit of :meth:`crm_phys_step`, which micro-batches in-program."""
        nsteps_gcm = int(np.ceil(sim_time / self.dt_gcm))
        ncrm = int(round(self.dt_gcm / self.dt_crm_phys))
        forcing = self._jitted_forcing() if self.apply_gcm_forcing else None
        total = int(state["temp"].shape[0])
        built = int(self.coupler.nens)
        if total % built != 0:
            # same guard as crm_phys_step / crm_phys_step_hostchunked —
            # without it the host split below would silently TRUNCATE a
            # non-multiple ensemble (5 members / built 2 -> 2 chunks of
            # 2, member 4 dropped)
            raise ValueError(
                f"state carries nens={total} but the driver was built "
                f"with nens={built}; micro-batching needs an exact "
                f"multiple")
        n_chunks = total // built
        if self.mb_mode == "host" or n_chunks == 1:
            step = self._jitted_single()
            chunks = ([state] if n_chunks == 1
                      else list(_split_ens(state, n_chunks)))

            def joined():
                return chunks[0] if n_chunks == 1 else _join_ens(tuple(chunks))
        else:
            step = jax.jit(self.crm_phys_step)
            chunks = [state]

            def joined():
                return chunks[0]
        etime = 0.0
        for n in range(nsteps_gcm):
            if forcing is not None:
                chunks = [forcing(c) for c in chunks]
            for _ in range(ncrm):
                chunks = [step(c) for c in chunks]
            etime += self.dt_gcm
            if callback is not None:
                callback(joined(), etime)
        return joined()


def setup_supercell_mmf(nx=65, ny=1, nz=50, nens=1, xlen=128000.0,
                        ylen=64000.0, zlen=20000.0, dtype=jnp.float64,
                        micro="kessler", sgs="none", dt_gcm=900.0,
                        dt_crm_phys=20.0, perturb_seeds=None,
                        dycore="awfl", crm_per_phys=1,
                        zint=None, dycore_kwargs=None, micro_kwargs=None,
                        state_only=False):
    """Build the full MMF configuration mirroring inputs/input_pamc.yaml
    (65x1x50 cells, 128 km x 64 km, 20 km top) with supercell column init.
    dycore="awfl" (PAM-A) or "spam" (PAM-C: MCE_rho + semi-implicit with
    dt_si = dt_crm_phys/crm_per_phys, the reference coupled defaults,
    core/params.h:120-165). Returns (driver, state).

    ``state_only=True`` skips the expensive module construction that does
    not contribute to the initial state (the SPAM semi-implicit
    linear-system build) and returns ``(None, state)`` — the state is
    identical to the full setup's. Used by the micro-batching callers
    (standalone ens_chunk, bench large-nens rows) that build the DRIVER
    at chunk size and only need the full-ensemble STATE here."""
    cpl = Coupler(nz=nz, ny=ny, nx=nx, nens=nens, xlen=xlen, ylen=ylen,
                  dtype=dtype)
    if micro == "kessler":
        from ..physics import kessler as kess
        cpl = kess.register(cpl)
    elif micro == "p3":
        from ..physics import p3 as p3mod
        cpl = p3mod.register(cpl)
    elif micro != "none":
        raise ValueError(f"unknown micro scheme {micro!r}")
    if sgs == "shoc":
        from ..physics.sgs import shoc as shoc_mod
        cpl = shoc_mod.register(cpl)
    elif sgs != "none":
        raise ValueError(f"unknown sgs scheme {sgs!r}")

    # vertical interfaces: caller-provided (stretched vcoords grids,
    # driver.cpp:135-170) or uniform
    if zint is None:
        zint = np.linspace(0.0, zlen, nz + 1)
    else:
        zint = np.asarray(zint, np.float64)
        assert len(zint) == nz + 1
    state = cpl.allocate_state(zint)
    state = supercell_column.initialize_from_supercell_column(cpl, state, zint)
    state = broadcast_initial_gcm_column(cpl, state)
    seeds = perturb_seeds if perturb_seeds is not None else np.arange(nens)
    state = perturb_temperature(cpl, state, np.asarray(seeds))

    if dycore == "awfl":
        # built even under state_only: the hydrostatic declaration is
        # part of the initial state (cheap — recon matrices only)
        dyc = AwflDycore.build(cpl, np.diff(zint), **(dycore_kwargs or {}))
        state = dyc.declare_current_profile_as_hydrostatic(state)
    elif dycore == "spam":
        if state_only:
            dyc = None  # build_coupled does not touch the state
        else:
            from ..spam.dycore import SpamDycore
            dyc = SpamDycore.build_coupled(cpl, state, zint,
                                           dt_si=dt_crm_phys / crm_per_phys,
                                           **(dycore_kwargs or {}))
    else:
        raise ValueError(f"unknown dycore {dycore!r}")

    micro_obj = None
    if micro == "kessler":
        from ..physics.kessler import KesslerMicro, init_state
        state = init_state(cpl, state)
        micro_obj = KesslerMicro(cpl, **(micro_kwargs or {}))
    elif micro == "p3":
        from ..physics import p3 as p3mod
        state = p3mod.init_state(cpl, state)
        micro_obj = p3mod.P3Micro(cpl, sgs_shoc=(sgs == "shoc"),
                                  **(micro_kwargs or {}))

    sgs_obj = None
    if sgs == "shoc":
        from ..physics.sgs import shoc as shoc_mod
        state = shoc_mod.init_state(cpl, state)
        # reference pressures for the PBL depth cap (SGS.h:169-178 uses
        # the hydrostatic ref profile); hy_pressure_cells is top-down
        # after the flip inside the wrapper
        pref = np.asarray(state["hy_pressure_cells"])[0, ::-1]
        sgs_obj = shoc_mod.ShocSgs.build(cpl, pref_mid=pref)

    if state_only:
        return None, state
    drv = MmfDriver(coupler=cpl, dycore=dyc, micro=micro_obj, sgs=sgs_obj,
                    dt_gcm=dt_gcm, dt_crm_phys=dt_crm_phys)
    return drv, state
