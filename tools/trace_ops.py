"""Reduce a JAX profiler trace to device-busy time and a per-op table (GPU).

``gpu_busy(trace_dir)`` reads the ``.xplane.pb`` files under ``trace_dir``
and, for the first GPU's plane, returns the union of its kernel/copy
intervals (busy time), the span from the first start to the last end
(window) and the summed duration per op name. It uses the plane's
``XLA Ops`` line when there is one and otherwise every ``Stream`` line,
so overlapping events on several streams are counted once in
``busy_ns``. It returns None when the trace has no GPU plane.

Usage (on the card):
  python tools/trace_ops.py [--micro kessler --sgs none --nens 128]
      traces 10 CRM steps of that configuration and prints busy/idle
      share and the top ops;
  python tools/trace_ops.py --dump
      also prints every plane and line of the trace with its event count.
"""

import argparse
import os
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _xplanes(trace_dir):
    from jax.profiler import ProfileData
    for root, _, files in os.walk(trace_dir):
        for f in sorted(files):
            if f.endswith(".xplane.pb"):
                yield ProfileData.from_file(os.path.join(root, f))


def gpu_busy(trace_dir, dump=False):
    for data in _xplanes(trace_dir):
        planes = list(data.planes)
        if dump:
            for plane in planes:
                for line in plane.lines:
                    print(f"plane {plane.name!r} line {line.name!r}: "
                          f"{sum(1 for _ in line.events)} events")
        gpus = sorted((p for p in planes
                       if p.name.lower().startswith("/device:gpu:")),
                      key=lambda p: p.name)
        if not gpus:
            continue
        lines = list(gpus[0].lines)
        chosen = [ln for ln in lines if ln.name == "XLA Ops"] or \
            [ln for ln in lines if ln.name.startswith("Stream")]
        spans, per_op = [], defaultdict(int)
        for line in chosen:
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_op[ev.name] += ev.duration_ns
        if not spans:
            return None
        spans.sort()
        busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        return dict(busy_ns=busy, window_ns=cur_e - spans[0][0],
                    per_op_ns=dict(per_op),
                    lines=[ln.name for ln in chosen])
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--micro", default="kessler")
    ap.add_argument("--sgs", default="none")
    ap.add_argument("--dycore", default="spam")
    ap.add_argument("--nens", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dump", action="store_true")
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    if jax.devices()[0].platform != "gpu":
        print("trace_ops: needs a GPU", file=sys.stderr)
        return 2
    from pam_tpu.compile_cache import enable_compile_cache
    from pam_tpu.driver.mmf import setup_supercell_mmf
    from pam_tpu.modules import gcm_forcing
    enable_compile_cache()
    drv, state = setup_supercell_mmf(
        nx=65, ny=1, nz=50, nens=args.nens, xlen=128000.0, ylen=64000.0,
        zlen=20000.0, micro=args.micro, sgs=args.sgs, dt_gcm=900.0,
        dt_crm_phys=20.0, dycore=args.dycore, dtype=jnp.float32)
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       drv.dt_gcm)
    step = jax.jit(drv.crm_phys_step)
    for _ in range(5):
        state = step(state)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state = step(state)
    jax.block_until_ready(state)
    wall = (time.perf_counter() - t0) / args.steps * 1e3
    tdir = tempfile.mkdtemp(prefix="pam_trace_")
    jax.profiler.start_trace(tdir)
    for _ in range(args.steps):
        state = step(state)
    jax.block_until_ready(state)
    jax.profiler.stop_trace()
    r = gpu_busy(tdir, dump=args.dump)
    if r is None:
        print("no GPU events in the trace: device time not measured")
        return 1
    n = args.steps
    print(f"{args.micro}+{args.sgs} {args.dycore} nens={args.nens}: wall "
          f"{wall:.3f} ms/step (untraced); traced window "
          f"{r['window_ns'] / n / 1e6:.3f} ms/step, busy "
          f"{r['busy_ns'] / n / 1e6:.3f} ms/step, idle share "
          f"{1 - r['busy_ns'] / r['window_ns']:.3f}; lines {r['lines']}")
    top = sorted(r["per_op_ns"].items(), key=lambda kv: -kv[1])[:25]
    for name, ns in top:
        print(f"  {ns / n / 1e3:10.1f} us/step  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
