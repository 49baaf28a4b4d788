"""Explicit device communication primitives for spatially-sharded stencils.

This is the JAX replacement for the reference's MPI halo-exchange
backend (dynamics/spam/src/core/exchange.h:190-631: device pack ->
host-staged MPI_Isend/Irecv/Waitall -> unpack, with a single-process
periodic fast path at exchange.h:434). Here the same three roles are
played by:

* ``proll``            -- periodic shift along a (possibly sharded)
                          horizontal axis.  Outside ``shard_map`` it is a
                          plain ``jnp.roll`` (the single-device fast path,
                          mirroring ``Exchange::exchange_direct``).  Inside
                          ``shard_map`` with that axis mapped to a mesh
                          axis, the wrapped columns are fetched from the
                          neighbor device with ``jax.lax.ppermute`` -- a
                          collective-permute over NVLink, with no host staging.
* ``pmean_h/psum_h/…`` -- horizontal reductions that finish with
                          ``lax.pmean``/``psum`` over the active mesh axes
                          (the reference's MPI_(I)reduce, extrudedmodel.h:4824).
* ``transpose_to_x_local`` -- ``lax.all_to_all`` re-layout trading ensemble
                          locality for a full x extent, so per-column FFT /
                          tridiagonal solves (the semi-implicit pressure
                          solve, extrudedmodel.h:3402-3477) run chip-local
                          under x-sharding.  This is the "transpose-based
                          sharded FFT" of SURVEY.md §7.

The active mesh-axis names are carried in a context (set by
``pam_tpu.parallel.sharded_step`` around the shard_mapped step body), so the
whole stencil codebase is written once against ``proll`` and runs unchanged
in three modes: unsharded, GSPMD-auto-sharded (context inactive -> XLA
partitions the rolls itself), and explicit shard_map (context active ->
hand-placed collectives).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import jax
import jax.numpy as jnp
from jax import lax


@dataclasses.dataclass
class _AxisCtx:
    ens_axis: str = None
    x_axis: str = None
    y_axis: str = None
    # set while inside x_local(): the mesh axis x was transposed away to,
    # for slicing per-ensemble coefficient tables (local_ens_xblock)
    transposed_x_axis: str = None


_tls = threading.local()


def _ctx() -> _AxisCtx:
    ctx = getattr(_tls, "ctx", None)
    return ctx if ctx is not None else _AxisCtx()


@contextlib.contextmanager
def axis_ctx(ens_axis: str = None, x_axis: str = None, y_axis: str = None):
    """Declare the mesh-axis names the surrounding shard_map mapped the
    (ens, x, y) array dimensions onto. Tracing-time only (the context is
    consulted while JAX traces the step body, never at runtime)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = _AxisCtx(ens_axis=ens_axis, x_axis=x_axis, y_axis=y_axis)
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


@contextlib.contextmanager
def x_local():
    """Temporarily mark x as device-local (inside a transposed solve):
    rolls along x become plain local rolls, and per-ensemble coefficient
    tables are sliced to the x-device's ensemble block via
    ``local_ens_xblock``."""
    prev = getattr(_tls, "ctx", None)
    cur = _ctx()
    _tls.ctx = dataclasses.replace(cur, x_axis=None,
                                   transposed_x_axis=cur.x_axis)
    try:
        yield
    finally:
        _tls.ctx = prev


def active_x_axis():
    return _ctx().x_axis


def active_y_axis():
    return _ctx().y_axis


def active_ens_axis():
    return _ctx().ens_axis


def _axis_size(name: str) -> int:
    return lax.axis_size(name)


def _ring_perm(n: int, shift: int):
    """Source->dest pairs sending each device's data ``shift`` steps up the
    ring (dest = src + shift mod n)."""
    return [(i, (i + shift) % n) for i in range(n)]


def _sharded_roll(a, s: int, axis: int, axis_name: str):
    """result[i] = a[i + s] along a sharded periodic axis: local shift plus
    a ppermute fetching the |s| wrapped columns from the neighbor.

    This is the halo exchange: for s > 0 the last s local columns come from
    the next device's first s columns (message size = |s| x everything
    else -- the same shell the reference packs in exchange.h:190-263)."""
    if s == 0:
        return a
    n = _axis_size(axis_name)
    if n == 1:
        return jnp.roll(a, -s, axis=axis)
    nloc = a.shape[axis]
    assert abs(s) <= nloc, (
        f"proll shift {s} exceeds local extent {nloc} on axis "
        f"{axis_name!r}; use fewer shards or a halo-pad path")
    idx = [slice(None)] * a.ndim
    if s > 0:
        # need neighbor-right's first s columns appended at the end
        idx[axis] = slice(0, s)
        edge = a[tuple(idx)]
        # data travels right->left: device i receives from device i+1,
        # i.e. device i sends its edge to device i-1
        recv = lax.ppermute(edge, axis_name, _ring_perm(n, -1))
        idx[axis] = slice(s, None)
        return jnp.concatenate([a[tuple(idx)], recv], axis=axis)
    # s < 0: need neighbor-left's last |s| columns prepended
    idx[axis] = slice(nloc + s, None)
    edge = a[tuple(idx)]
    recv = lax.ppermute(edge, axis_name, _ring_perm(n, 1))
    idx[axis] = slice(0, nloc + s)
    return jnp.concatenate([recv, a[tuple(idx)]], axis=axis)


def _axis_name_for(ax: int, kind: str):
    ctx = _ctx()
    if kind == "x" or (kind is None and ax == -1):
        return ctx.x_axis
    if kind == "y" or (kind is None and ax == -2):
        return ctx.y_axis
    return None


def proll(a, s: int, axis: int = -1, kind: str = None):
    """Periodic shift: result[i] = a[i + s] along ``axis`` (x by default).

    Unsharded / GSPMD mode: ``jnp.roll(a, -s)``. Inside an ``axis_ctx``
    with the x (or y) axis active, the wrap becomes an explicit
    ``ppermute`` halo fetch. ``kind`` ("x"/"y") names which physical axis
    this is when it is not in the default trailing position (-1 = x,
    -2 = y)."""
    nd = a.ndim
    ax = axis % nd - nd  # normalize to negative
    name = _axis_name_for(ax, kind)
    if name is None:
        return jnp.roll(a, -s, axis=axis)
    return _sharded_roll(a, int(s), ax, name)


def proll_y(a, s: int):
    """Periodic shift along the y axis (second-to-last)."""
    return proll(a, s, axis=-2)


def halo_pad(a, h: int, axis: int = -1, kind: str = None):
    """Gather an h-wide periodic halo on each side of ``axis``:
    returns an array extended by 2h, with [0:h] = left neighbor's right
    edge and [-h:] = right neighbor's left edge. One exchange serving a
    whole stencil stage (the reference's per-stage Exchange granularity,
    but one message per side instead of one per field)."""
    nd = a.ndim
    ax = axis % nd - nd
    name = _axis_name_for(ax, kind)

    def edge(width, side):
        """My first (side='l') / last (side='r') ``width`` columns."""
        sl = [slice(None)] * a.ndim
        sl[ax] = (slice(0, width) if side == "l"
                  else slice(a.shape[ax] - width, None))
        return a[tuple(sl)]

    if name is None or _axis_size(name) == 1:
        assert h <= a.shape[ax], \
            f"halo_pad h={h} exceeds axis extent {a.shape[ax]}"
        return jnp.concatenate([edge(h, "r"), a, edge(h, "l")], axis=ax)
    n = _axis_size(name)
    nloc = a.shape[ax]
    if h > nloc:
        # halo wider than one shard (tiny-grid many-shard tests): fetch
        # from neighbors-of-neighbors hop by hop — whole shards for the
        # near hops, only the needed remainder from the farthest one
        import math
        hops = math.ceil(h / nloc)
        assert hops < n, (
            f"halo_pad h={h} needs {hops} shards but axis {name!r} has "
            f"only {n}")
        w_far = h - (hops - 1) * nloc
        lparts, rparts = [], []
        for d in range(1, hops + 1):
            send_l = edge(w_far, "r") if d == hops else a
            send_r = edge(w_far, "l") if d == hops else a
            lparts.append(lax.ppermute(send_l, name, _ring_perm(n, d)))
            rparts.append(lax.ppermute(send_r, name, _ring_perm(n, -d)))
        # farthest-first on the left, farthest-last on the right: each
        # halo is exactly h wide by construction
        return jnp.concatenate(
            lparts[::-1] + [a] + rparts, axis=ax)
    from_left = lax.ppermute(edge(h, "r"), name, _ring_perm(n, 1))
    from_right = lax.ppermute(edge(h, "l"), name, _ring_perm(n, -1))
    return jnp.concatenate([from_left, a, from_right], axis=ax)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _finish(val, op):
    """Apply the collective over whichever horizontal axes are active."""
    ctx = _ctx()
    for name in (ctx.x_axis, ctx.y_axis):
        if name is not None:
            val = op(val, name)
    return val


def psum_h(x, axes):
    """Sum over local axes then psum over active horizontal mesh axes."""
    return _finish(jnp.sum(x, axis=axes), lax.psum)


def pmean_h(x, axes):
    return _finish(jnp.mean(x, axis=axes), lax.pmean)


def pmax_h(x, axes=None):
    v = jnp.max(x, axis=axes) if axes is not None else jnp.max(x)
    return _finish(v, lax.pmax)


def pmin_h(x, axes=None):
    v = jnp.min(x, axis=axes) if axes is not None else jnp.min(x)
    return _finish(v, lax.pmin)


# ---------------------------------------------------------------------------
# all_to_all transpose: x-sharded <-> x-local (ens-subsharded)
# ---------------------------------------------------------------------------

def x_shards() -> int:
    """Number of x shards in the active context (1 when inactive)."""
    name = _ctx().x_axis
    return 1 if name is None else _axis_size(name)


def transpose_to_x_local(a, ens_dim: int, x_dim: int):
    """Re-layout an x-sharded array so x is fully local, splitting the
    ensemble dim across the x mesh axis instead (lax.all_to_all).

    With the outer sharding P(ens -> 'ens', x -> 'x') this yields the same
    layout as P(ens -> ('ens','x')): ens chunked contiguously row-major
    over (ens, x) device coordinates — so static per-ens coefficient
    tables can be fed in pre-sharded with that spec and line up exactly."""
    name = _ctx().x_axis
    if name is None or _axis_size(name) == 1:
        return a
    n = _axis_size(name)
    assert a.shape[ens_dim] % n == 0, (
        f"ensemble extent {a.shape[ens_dim]} not divisible by x shards {n};"
        " choose nens so each device's ensemble block splits across x")
    return lax.all_to_all(a, name, split_axis=ens_dim, concat_axis=x_dim,
                          tiled=True)


def transpose_from_x_local(a, ens_dim: int, x_dim: int):
    """Inverse of transpose_to_x_local."""
    name = _ctx().x_axis
    if name is None or _axis_size(name) == 1:
        return a
    return lax.all_to_all(a, name, split_axis=x_dim, concat_axis=ens_dim,
                          tiled=True)


def local_xslice(a, x_dim: int = -1):
    """Slice a closed-over constant with a full-extent x dim down to this
    device's x block inside a manual-x shard_map region (no-op outside)."""
    name = _ctx().x_axis
    if name is None or _axis_size(name) == 1:
        return a
    n = _axis_size(name)
    assert a.shape[x_dim] % n == 0, (a.shape, x_dim, n)
    block = a.shape[x_dim] // n
    off = lax.axis_index(name) * block
    return lax.dynamic_slice_in_dim(jnp.asarray(a), off, block, axis=x_dim)


def local_ens_xblock(table, ens_dim: int = 0):
    """Inside ``x_local()`` (i.e. after ``transpose_to_x_local``): slice a
    coefficient table with a leading global-ensemble dim down to this
    x-device's ensemble block. ``tiled`` all_to_all assigns ensemble chunk
    p (contiguous) to x-device p, so the offset is axis_index * block."""
    name = _ctx().transposed_x_axis
    if name is None or _axis_size(name) == 1:
        return table
    n = _axis_size(name)
    assert table.shape[ens_dim] % n == 0, (table.shape, ens_dim, n)
    block = table.shape[ens_dim] // n
    off = lax.axis_index(name) * block
    return lax.dynamic_slice_in_dim(jnp.asarray(table), off, block,
                                    axis=ens_dim)
