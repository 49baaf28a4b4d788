"""Smoke test of the MMF CRM step on one GPU, through the user entry points.

Usage:
    python chip_smoke.py          # phases 1-4 on the first GPU
    python chip_smoke.py --four   # only the 4-GPU sharded dry run (phase 5)

Phases (one process; the first failure ends it with a non-zero exit):
  1. configs/input_mmf_production.yaml (P3 + SHOC, SPAM + semi-implicit,
     f32, 65x1x50 per CRM, nens=512) through pam_tpu.driver.standalone for
     one GCM step (45 CRM steps): finite fields, temp in [180, 330] K,
     tracers >= 0, plus compile and per-step times.
  2. configs/input_mmf_kessler.yaml (AWFL dycore) at nens=128, f32, one
     GCM step, with the same checks.
  3. f32 precision of the DFT matmuls and the P3 table interpolations
     against numpy f64 (TF32 contractions would read ~1e-3).
  4. 10 f64 CRM steps of Kessler and P3+SHOC (SPAM+SI) at 65x1x50,
     nens=2: GPU against the host CPU backend in the same process, once
     with each tridiagonal solver, and the tests/golden trajectories
     through tools/make_golden.run_config with the goldens' own solver
     (Thomas) on the GPU and the CPU (tolerances: STEP_TOL, P3_TOL,
     GOLDEN_TOL).
  5. (--four) __graft_entry__.dryrun_multichip(4): explicit shard_map on an
     (ens=2, x=2) mesh against the unsharded run, and the 3-D (1, 2, 2)
     leg.

The last line of stdout is one JSON object: {"ok": true, "device": ...}.
There is no CPU fallback: without a GPU it exits non-zero before any phase.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# f64 after 10 steps, GPU vs CPU and vs tests/golden, the same solver on
# both sides: max|diff| / max(max|ref|, STEP_FLOOR) per field. 1e-9 is the
# CPU golden test's limit (tests/test_golden.py).
STEP_TOL = {"*": 1e-9}
STEP_FLOOR = 1e-8
# P3+SHOC carries a last-bit difference into its precipitation species
# and w: a 1e-15 relative change of the initial temp reads up to ~1.4e-6
# in rain after 10 steps, CPU against CPU (the witness leg of phase 4;
# PERF.md). The card reads up to 2.9e-6 (rain); the limits are three
# times that or more.
P3_TOL = {"rain": 1e-5, "rain_num": 1e-5, "ice": 1e-5, "ice_num": 1e-5,
          "ice_rime": 1e-5, "ice_rime_vol": 1e-5, "wvel": 1e-6,
          "cloud_water": 1e-8, "cloud_water_num": 1e-8}
# tests/golden replayed on another host than the one that wrote it: the
# GPU and that host's own CPU read the same ~1e-7 (Kessler wvel), while
# the GPU agrees with that CPU at ~1e-11 (the "config, GPU vs CPU" leg
# holds 1e-9); a host difference, not the card's (PERF.md). A decade
# above the measured 9.8e-8.
GOLDEN_TOL = 1e-6
PRECISION_TOL = 1e-5  # f32 contractions vs numpy f64


def card_line():
    """The card(s) as nvidia-smi names them, read without JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def rel_err(a, b, floor=1e-300):
    """max |a - b| / max(max |b|, floor) (the golden tests' measure)."""
    import numpy as np
    kind = (np.complex128 if np.iscomplexobj(a) or np.iscomplexobj(b)
            else np.float64)
    a, b = np.asarray(a, kind), np.asarray(b, kind)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def positive_tracers(cpl):
    return [n for n, pos in zip(cpl.tracer_names, cpl.tracer_positive)
            if pos]


def check_state(tag, state, tracer_names):
    import numpy as np
    for k, v in state.items():
        if hasattr(v, "dtype") and np.issubdtype(v.dtype, np.floating):
            check(bool(np.isfinite(np.asarray(v)).all()),
                  f"{tag}: non-finite {k}")
    t = np.asarray(state["temp"])
    check(180.0 <= t.min() and t.max() <= 330.0,
          f"{tag}: temp in [{t.min()}, {t.max()}] K")
    mins = {n: float(np.asarray(state[n]).min()) for n in tracer_names}
    check(bool(mins), f"{tag}: no positive tracers")
    check(min(mins.values()) >= 0.0, f"{tag}: negative tracer {mins}")
    print(f"  {tag}: finite; temp [{t.min():.2f}, {t.max():.2f}] K; "
          f"tracer minima >= 0", flush=True)


def phase_production(card):
    import jax
    from pam_tpu.driver import standalone
    cfg = standalone.load_config(os.path.join(
        REPO, "configs", "input_mmf_production.yaml"))
    cfg["sim_time"] = cfg["dt_gcm"]
    ncrm = int(round(cfg["dt_gcm"] / cfg["dt_crm_phys"]))
    t0 = time.perf_counter()
    state = standalone.run_mmf(cfg, verbose=False)
    jax.block_until_ready(state)
    cold = time.perf_counter() - t0
    drv, _, _ = standalone.setup_mmf(cfg)
    check_state("production", state, positive_tracers(drv.coupler))
    # warm timing of the same GCM step on a driver that setup_mmf builds
    # from the same config (run_mmf keeps its own driver to itself)
    state = drv.run(state, cfg["dt_gcm"])        # compiles (cache) + warms
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state = drv.run(state, cfg["dt_gcm"])
    jax.block_until_ready(state)
    warm = time.perf_counter() - t0
    print(f"  production nens={cfg['nens']} ens_chunk={cfg['ens_chunk']}: "
          f"first GCM step incl. compile {cold:.3f} s; "
          f"{warm / ncrm * 1e3:.3f} ms per CRM step (wall, {ncrm} steps) "
          f"[{card}]", flush=True)


def phase_awfl(card):
    import jax
    from pam_tpu.driver import standalone
    cfg = standalone.load_config(os.path.join(
        REPO, "configs", "input_mmf_kessler.yaml"))
    cfg.update(nens=128, f64=False, out_freq=-1.0)
    cfg["sim_time"] = cfg["dt_gcm"]
    drv, state0, _ = standalone.setup_mmf(cfg)
    check(drv.dycore.name.startswith("SSPRK3+WENO"), "kessler config "
          "is expected to run the AWFL dycore")
    t0 = time.perf_counter()
    state = drv.run(state0, cfg["sim_time"])
    jax.block_until_ready(state)
    print(f"  awfl nens={cfg['nens']}: one GCM "
          f"step incl. compile {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    check_state("awfl", state, positive_tracers(drv.coupler))


def phase_precision():
    import numpy as np
    import jax
    from pam_tpu.ops import dft
    from pam_tpu.physics.p3 import tables as tbl
    rng = np.random.default_rng(0)
    a = rng.standard_normal((128, 50, 65))
    ga = jax.device_put(a.astype(np.float32))
    spec = np.fft.rfft(a, axis=-1)
    gspec = jax.device_put(spec.astype(np.complex64))
    cases = {
        "dft.fft": (jax.jit(dft.fft)(ga), np.fft.fft(a, axis=-1)),
        "dft.rfft": (jax.jit(dft.rfft)(ga), spec),
        "dft.irfft": (jax.jit(lambda s: dft.irfft(s, 65))(gspec), a),
        "dft.ifft_real": (jax.jit(dft.ifft_real)(jax.device_put(
            np.fft.fft(a, axis=-1).astype(np.complex64))), a),
    }

    def hat(n, x):
        return np.maximum(0.0, 1.0 - np.abs(np.arange(n) - x[..., None]))

    pts = (128, 50)
    ice = tbl.load_ice_tables()[0]                  # (5, 4, ISIZE, K)
    coll = tbl.load_ice_tables()[1]                 # (5, 4, ISIZE, J, K)
    rain = [np.asarray(t) for t in tbl.build_rain_tables()]  # (300, 10)
    d1 = rng.uniform(0, ice.shape[2] - 1, pts)
    d3 = rng.uniform(0, coll.shape[3] - 1, pts)
    d4 = rng.uniform(0, ice.shape[1] - 1, pts)
    d5 = rng.uniform(0, ice.shape[0] - 1, pts)
    ri = rng.uniform(0, rain[0].shape[0] - 1, pts)
    rj = rng.uniform(0, rain[0].shape[1] - 1, pts)
    f32 = lambda x: jax.device_put(np.asarray(x, np.float32))
    ice_idx, coll_idx = (1, 2, 3, 4, 6, 7, 9), (0, 1)
    out = jax.jit(lambda a, b, c: tbl.access_ice_table_multi(
        ice, ice_idx, a, b, c))(f32(d1), f32(d4), f32(d5))
    ref = np.einsum("pqi,pqk,pqj,jkie->pqe", hat(ice.shape[2], d1),
                    hat(ice.shape[1], d4), hat(ice.shape[0], d5),
                    ice[..., list(ice_idx)])
    for n, o in enumerate(out):
        cases[f"ice table {ice_idx[n]}"] = (o, ref[..., n])
    out = jax.jit(lambda a, b, c, d: tbl.access_collect_table_multi(
        coll, coll_idx, a, b, c, d))(f32(d1), f32(d3), f32(d4), f32(d5))
    ref = np.einsum("pqi,pqj,pqb,pqa,abije->pqe", hat(coll.shape[2], d1),
                    hat(coll.shape[3], d3), hat(coll.shape[1], d4),
                    hat(coll.shape[0], d5), coll[..., list(coll_idx)])
    for n, o in enumerate(out):
        cases[f"collection table {coll_idx[n]}"] = (o, ref[..., n])
    out = jax.jit(lambda a, b: tbl.access_rain_table_multi(rain, a, b))(
        f32(ri), f32(rj))
    for n, (o, t) in enumerate(zip(out, rain)):
        cases[f"rain table {n}"] = (o, np.einsum(
            "pqi,pqj,ij->pq", hat(t.shape[0], ri), hat(t.shape[1], rj), t))
    worst = 0.0
    for name, (got, want) in cases.items():
        err = rel_err(got, want)
        worst = max(worst, err)
        check(err <= PRECISION_TOL,
              f"precision {name}: rel err {err:.3e} > {PRECISION_TOL}")
    print(f"  f32 DFTs (n=65, batch 128x50) and P3 table interpolations "
          f"(128x50 points) vs numpy f64: worst rel err {worst:.3e} "
          f"(tol {PRECISION_TOL}; {len(cases)} checks)", flush=True)


def ten_f64_steps(micro, sgs, solver, perturb=0.0):
    """10 f64 CRM steps at 65x1x50, nens=2, with the tridiagonal solver
    pinned; ``perturb`` scales the initial temp by (1 + perturb)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from pam_tpu.driver.mmf import setup_supercell_mmf
    from pam_tpu.modules import gcm_forcing
    from pam_tpu.ops import tridiag
    with tridiag.solver(solver):
        drv, state = setup_supercell_mmf(
            nx=65, ny=1, nz=50, nens=2, xlen=128000.0, ylen=64000.0,
            zlen=20000.0, micro=micro, sgs=sgs, dt_gcm=900.0,
            dt_crm_phys=20.0, dycore="spam", dtype=jnp.float64)
        state = gcm_forcing.compute_gcm_forcing_tendencies(
            drv.coupler, state, drv.dt_gcm)
        if perturb:
            state = dict(state, temp=state["temp"] * (1.0 + perturb))
        step = jax.jit(drv.crm_phys_step)
        for _ in range(10):
            state = step(state)
    names = ("temp", "uvel", "wvel", "density_dry") + \
        drv.coupler.tracer_names
    return {k: np.asarray(state[k]) for k in names}


def golden_run(micro, sgs):
    """tools/make_golden.run_config with the goldens' own solver."""
    import numpy as np
    from make_golden import run_config
    from pam_tpu.ops import tridiag
    with tridiag.solver("thomas"):
        return {k: np.asarray(v) for k, v in run_config(micro, sgs).items()}


def phase_f64_steps():
    """f64 GPU against the CPU backend and the goldens, one solver on
    both sides of every comparison. The 'witness' leg is CPU against CPU
    with the initial temp perturbed by 1e-15: how far the model itself
    carries a last-bit difference in 10 steps."""
    import numpy as np
    import jax
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    cpu = jax.devices("cpu")[0]
    results = []                            # (name, errs, tol per field)
    for micro, sgs, golden in (("kessler", "none", "kessler_spam_si"),
                               ("p3", "shoc", "p3_shoc_spam_si")):
        tol = STEP_TOL if micro == "kessler" else {**STEP_TOL, **P3_TOL}
        tag = f"{micro}+{sgs} f64 65x1x50 nens=2, 10 steps"
        for solver in ("thomas", "pcr"):
            gpu_out = ten_f64_steps(micro, sgs, solver)
            with jax.default_device(cpu):
                cpu_out = ten_f64_steps(micro, sgs, solver)
            results.append((f"{tag}, {solver}, GPU vs CPU", {
                k: rel_err(gpu_out[k], cpu_out[k], STEP_FLOOR)
                for k in cpu_out}, tol))
            if solver == "thomas":
                with jax.default_device(cpu):
                    pert = ten_f64_steps(micro, sgs, solver, perturb=1e-15)
                results.append((f"{tag}, thomas, witness CPU vs CPU "
                                "(temp * (1 + 1e-15))", {
                                    k: rel_err(pert[k], cpu_out[k],
                                               STEP_FLOOR)
                                    for k in cpu_out}, None))
        ref = np.load(os.path.join(REPO, "tests", "golden", golden + ".npz"))
        gpu_out = golden_run(micro, sgs)
        with jax.default_device(cpu):
            cpu_out = golden_run(micro, sgs)
        results.append((f"{golden} config, thomas, GPU vs CPU", {
            k: rel_err(gpu_out[k], cpu_out[k], STEP_FLOOR)
            for k in ref.files}, tol))
        gtol = {k: max(t, GOLDEN_TOL) for k, t in tol.items()}
        for side, out in (("GPU", gpu_out), ("CPU", cpu_out)):
            results.append((f"{golden} config, thomas, {side} vs golden", {
                k: rel_err(out[k], ref[k], STEP_FLOOR) for k in ref.files},
                gtol))
    # every comparison is printed before any is checked
    for name, errs, tol in results:
        print(f"  {name}: rel err per field " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()) +
            ("" if tol is None else f" (tol {tol['*']:g}" + "".join(
                f", {k} {t:g}" for k, t in tol.items() if k != "*") + ")"),
            flush=True)
    for name, errs, tol in results:
        if tol is None:
            continue
        bad = {k: v for k, v in errs.items() if v > tol.get(k, tol["*"])}
        check(not bad, f"{name}: over tolerance {bad}")


def main(argv):
    four = "--four" in argv
    if not four:
        # one card: JAX sees the first GPU only
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    if four and len(devices) < 4:
        print(f"chip_smoke --four: needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    import numpy
    print(f"jax {jax.__version__}, numpy {numpy.__version__}", flush=True)
    sys.path.insert(0, REPO)
    from pam_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    card0 = card.splitlines()[0]

    if four:
        phases = [("5 sharded 4-GPU dry run", lambda: __import__(
            "__graft_entry__").dryrun_multichip(4))]
    else:
        phases = [
            ("1 production MMF step", lambda: phase_production(card0)),
            ("2 AWFL step", lambda: phase_awfl(card0)),
            ("3 f32 precision", phase_precision),
            ("4 f64 step vs CPU and golden", phase_f64_steps),
        ]
    for name, run in phases:
        t0 = time.perf_counter()
        print(f"phase {name}", flush=True)
        run()
        print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
