"""Explicit shard_map wrappers for the CRM step: manual spatial sharding.

This is the JAX analog of the reference's MPI domain decomposition
(dynamics/spam/src/core/{params.h finalize_parallel, exchange.h}): the
horizontal x (and, for 3-D runs, y) axes are sharded MANUALLY over the
device mesh — every halo fetch is a hand-placed ``jax.lax.ppermute``, every
horizontal reduction a ``lax.psum/pmean``, and the semi-implicit spectral
solves run through an ``all_to_all`` transpose (pam_tpu.parallel.comm).
The ensemble axis stays OUTSIDE the manual region: ``shard_map`` is given
``axis_names={x[,y]}`` only, so GSPMD auto-partitions the (embarrassingly
parallel) ens axis from the arrays' own shardings — zero communication,
exactly the reference's nens-per-rank batching.

Three execution modes for the same step code (stencils are written once
against ``comm.proll``):

1. unsharded            — proll == jnp.roll (exchange_direct fast path)
2. GSPMD auto           — jit with sharded inputs, no shard_map; XLA
                          chooses the collectives (round-1 behavior)
3. explicit (this file) — shard_map manual x/y; we choose the collectives

Modes 2 and 3 are asserted bit-identical to mode 1 in tests/test_halo.py.
"""

from __future__ import annotations

import jax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import comm
from .mesh import ENS_AXIS, X_AXIS, Y_AXIS


def state_specs(state, x_axis: str = X_AXIS, y_axis: str = None):
    """Manual-axis PartitionSpecs for a coupler state dict: 4-D
    (nens, nz, ny, nx) fields sharded over x (and y); columns and scalars
    replicated across the manual axes (specs must not mention auto axes —
    the ens sharding rides on the arrays themselves)."""
    def spec(v):
        nd = getattr(v, "ndim", 0)
        if nd == 4:                       # (nens, nz, ny, nx)
            return P(None, None, y_axis, x_axis)
        if nd == 3:                       # (nens, ny, nx) surface field
            return P(None, y_axis, x_axis)
        return P()
    return {k: spec(v) for k, v in state.items()}


def sharded_crm_step(drv, mesh: Mesh, x_axis: str = X_AXIS,
                     y_axis: str = None):
    """Wrap ``drv.crm_phys_step`` in a manual-x[/y] shard_map.

    Returns ``(step_fn, place)``: ``step_fn`` is jitted; ``place(state)``
    device_puts a state dict with ens sharded over ENS_AXIS (when present
    in the mesh) and x/y sharded over the given axes."""
    axis_names = {x_axis} | ({y_axis} if y_axis else set())
    # size-1 manual axes: shard_map adds nothing (and trips an XLA SPMD
    # RET_CHECK when an auto-axis reduction meets a trivial manual
    # subgroup) — fall back to the plain jitted step, which is identical
    # (proll degrades to jnp.roll; the exchange_direct fast path)
    trivial = all(mesh.shape[a] == 1 for a in axis_names)

    def place(state):
        ens = ENS_AXIS if ENS_AXIS in mesh.axis_names else None

        def sh(v):
            nd = getattr(v, "ndim", 0)
            if nd == 4:
                return NamedSharding(mesh, P(ens, None, y_axis, x_axis))
            if nd == 3:
                return NamedSharding(mesh, P(ens, y_axis, x_axis))
            if nd >= 1:
                return NamedSharding(mesh, P(ens))
            return NamedSharding(mesh, P())
        return {k: jax.device_put(v, sh(v)) for k, v in state.items()}

    def _make(state):
        specs = state_specs(state, x_axis, y_axis)

        def body(s):
            with comm.axis_ctx(x_axis=x_axis, y_axis=y_axis):
                return drv.crm_phys_step(s)

        return shard_map(body, mesh=mesh, in_specs=(specs,),
                         out_specs=specs, axis_names=axis_names)

    def step(state):
        if trivial:
            return drv.crm_phys_step(state)
        return _make(state)(state)

    return jax.jit(step), place


def sharded_dycore_step(dycore, mesh: Mesh, dt_phys: float,
                        x_axis: str = X_AXIS, y_axis: str = None):
    """shard_map just the dycore timestep (state dict in/out)."""
    axis_names = {x_axis} | ({y_axis} if y_axis else set())
    # same size-1 fallback as sharded_crm_step: trivial manual axes add
    # nothing and can trip the XLA SPMD RET_CHECK
    trivial = all(mesh.shape[a] == 1 for a in axis_names)

    def step(state):
        if trivial:
            return dycore.timestep(state, dt_phys)
        specs = state_specs(state, x_axis, y_axis)

        def body(s):
            with comm.axis_ctx(x_axis=x_axis, y_axis=y_axis):
                return dycore.timestep(s, dt_phys)

        return shard_map(body, mesh=mesh, in_specs=(specs,),
                         out_specs=specs, axis_names=axis_names)(state)

    return jax.jit(step)
