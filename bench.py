"""Benchmark: supercell CRM throughput (grid-points·steps/s) on one GPU.

Runs the reference's production MMF grid (65x1x50 cells per CRM,
inputs/input_pamc.yaml) batched over an ensemble, f32, and times the CRM
physics step. Rows, one JSON line each, printed as each finishes:
  1. P3 + SHOC, SPAM + semi-implicit, nens=128 (the reference CI stack,
     inputs/ci/input_pamc.yaml);
  2. the same at nens=512 and 3. nens=1024, each with ``ens_chunk: auto``
     (driver/mmf.py pick_ens_chunk);
  4. Kessler at nens=512, ``ens_chunk: auto``;
  5. the AWFL (PAM-A) dycore with Kessler, nens=128;
  6. Kessler, SPAM + semi-implicit, nens=128.
Setting any of PAM_BENCH_MICRO / PAM_BENCH_SGS / PAM_BENCH_DYCORE runs that
one configuration (with PAM_BENCH_NENS and PAM_BENCH_CHUNK).

Each row carries the device as JAX reports it and the card's name and
power limit (nvidia-smi), the best and median wall ms per CRM step over
PAM_BENCH_REPS repetitions of PAM_BENCH_STEPS steps, compile + first step
seconds, and the device-busy ms per step from a profiler trace
(tools/trace_ops.py; "not measured" if the trace has no GPU events).
Without a GPU it exits non-zero.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
NX, NY, NZ = 65, 1, 50


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card():
    """'name, power limit' of the first card, read without JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_busy_ms(step, state, nsteps, sync):
    """Device-busy ms per step from a profiler trace of ``nsteps`` steps,
    or None if the trace holds no GPU events."""
    import shutil
    import jax
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from trace_ops import gpu_busy
    tdir = tempfile.mkdtemp(prefix="pam_bench_trace_")
    try:
        jax.profiler.start_trace(tdir)
        try:
            for _ in range(nsteps):
                state = step(state)
            sync(state)
        finally:
            jax.profiler.stop_trace()
        busy = gpu_busy(tdir)
        return None if busy is None else busy["busy_ns"] / nsteps / 1e6
    finally:
        shutil.rmtree(tdir, ignore_errors=True)


def build(micro, sgs, dycore, nens, chunk=None):
    """Compiled step of one configuration over its host-dispatched chunks.

    Returns ``(step, state, sync, compile_s, chunk)``: ``step`` maps the
    tuple of chunk states one CRM step on, ``sync`` waits for it, and
    ``compile_s`` is the time of the first (compiling) step."""
    import jax
    import jax.numpy as jnp
    from pam_tpu.driver.mmf import (setup_supercell_mmf, pick_ens_chunk,
                                    _split_ens)
    from pam_tpu.modules import gcm_forcing

    if chunk == "auto":
        chunk = pick_ens_chunk(NX, NY, NZ, jnp.float32, nens)
    drv_nens = chunk or nens
    kw = dict(nx=NX, ny=NY, nz=NZ, xlen=128000.0, ylen=64000.0,
              zlen=20000.0, micro=micro, sgs=sgs, dt_gcm=900.0,
              dt_crm_phys=20.0, dycore=dycore, dtype=jnp.float32)
    drv, state = setup_supercell_mmf(nens=drv_nens, **kw)
    if drv_nens != nens:
        # chunk-sized driver + full-ensemble state, stepped chunk by chunk
        # from the host as MmfDriver.run does
        _, state = setup_supercell_mmf(nens=nens, state_only=True, **kw)
    state = gcm_forcing.compute_gcm_forcing_tendencies(
        drv.coupler, state, drv.dt_gcm)
    inner = drv._jitted_single()
    state = _split_ens(state, nens // drv_nens)

    def step(cs):
        return tuple(inner(c) for c in cs)

    def sync(cs):
        jax.block_until_ready(cs[-1]["temp"])

    t0 = time.perf_counter()
    state = step(state)
    sync(state)
    return step, state, sync, time.perf_counter() - t0, drv_nens


def time_steps(step, state, sync, steps):
    """(ms per step, state) over ``steps`` steps, wall clock."""
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state)
    sync(state)
    return (time.perf_counter() - t0) / steps * 1e3, state


def run_config(micro, sgs, dycore, nens, chunk=None, steps=60, reps=3,
               trace_steps=10):
    import numpy as np
    from pam_tpu.driver.mmf import _join_ens
    step, state, sync, compile_s, drv_nens = build(micro, sgs, dycore, nens,
                                                   chunk)
    _, state = time_steps(step, state, sync, 3)
    ms = []
    for _ in range(reps):
        m, state = time_steps(step, state, sync, steps)
        ms.append(m)
    if not bool(np.isfinite(np.asarray(_join_ens(state)["temp"])).all()):
        raise SystemExit("non-finite state after the benchmark run")
    busy = device_busy_ms(step, state, trace_steps, sync)
    return dict(ms=ms, compile_s=compile_s, busy=busy, chunk=drv_nens)


def emit(r, micro, sgs, dycore, nens, card_name):
    import jax
    dev = jax.devices()[0]
    best = min(r["ms"])
    rec = {
        "metric": "supercell CRM grid-points*steps/s",
        "value": NX * NY * NZ * nens / best * 1e3,
        "unit": "gridpoint-steps/s",
        "config": f"micro={micro},sgs={sgs},dycore={dycore},nens={nens},"
                  f"ens_chunk={r['chunk']}",
        "ms_per_step": best,
        "ms_per_step_median": statistics.median(r["ms"]),
        "reps": len(r["ms"]),
        "compile_first_step_s": r["compile_s"],
        "device_busy_ms_per_step": ("not measured" if r["busy"] is None
                                    else r["busy"]),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_name,
    }
    print(json.dumps(rec), flush=True)


def main():
    import jax
    if jax.devices()[0].platform != "gpu":
        log(f"bench.py needs a GPU; JAX found {jax.devices()[0].platform}")
        return 2
    sys.path.insert(0, REPO)
    from pam_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    card_name = card()
    log(f"devices: {jax.devices()}; card: {card_name}")
    env = os.environ
    opts = dict(steps=int(env.get("PAM_BENCH_STEPS", "60")),
                reps=max(1, int(env.get("PAM_BENCH_REPS", "3"))),
                trace_steps=int(env.get("PAM_BENCH_TRACE_STEPS", "10")))
    if any(k in env for k in ("PAM_BENCH_MICRO", "PAM_BENCH_SGS",
                              "PAM_BENCH_DYCORE")):
        chunk = env.get("PAM_BENCH_CHUNK")
        cells = [dict(micro=env.get("PAM_BENCH_MICRO", "kessler"),
                      sgs=env.get("PAM_BENCH_SGS", "none"),
                      dycore=env.get("PAM_BENCH_DYCORE", "spam"),
                      nens=int(env.get("PAM_BENCH_NENS", "128")),
                      chunk=chunk if chunk in (None, "auto") else int(chunk))]
    else:
        cells = [
            dict(micro="p3", sgs="shoc", dycore="spam", nens=128),
            dict(micro="p3", sgs="shoc", dycore="spam", nens=512,
                 chunk="auto"),
            dict(micro="p3", sgs="shoc", dycore="spam", nens=1024,
                 chunk="auto"),
            dict(micro="kessler", sgs="none", dycore="spam", nens=512,
                 chunk="auto"),
            dict(micro="kessler", sgs="none", dycore="awfl", nens=128,
                 steps=10),
            dict(micro="kessler", sgs="none", dycore="spam", nens=128),
        ]
    for cell in cells:
        run_opts = dict(opts)
        run_opts["steps"] = cell.pop("steps", run_opts["steps"])
        r = run_config(**cell, **run_opts)
        log(f"{cell}: compile+first step {r['compile_s']:.1f} s; "
            f"ms/step {['%.3f' % m for m in r['ms']]}")
        emit(r, cell["micro"], cell["sgs"], cell["dycore"], cell["nens"],
             card_name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
