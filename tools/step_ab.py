"""In-process A/B timings of the production P3+SHOC step on one GPU.

Compares, at the production grid (65x1x50, f32, SPAM + semi-implicit):
the whole ensemble in one step against host-dispatched chunks
(``ens_chunk``, driver/mmf.py), each with the PCR and the Thomas
tridiagonal solver (ops/tridiag.py). Every variant is compiled first;
then the rounds time them in alternating order (A B C D, D C B A, ...),
so drift of the card's clock falls on every variant alike.

Usage: python tools/step_ab.py [--nens 512] [--chunk 128] [--steps 45]
                               [--rounds 4]
"""

import argparse
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nens", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--steps", type=int, default=45)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"step_ab: needs a GPU, JAX found {jax.devices()[0].platform}",
              file=sys.stderr)
        return 2
    import bench
    from pam_tpu.compile_cache import enable_compile_cache
    from pam_tpu.ops import tridiag
    enable_compile_cache()
    card = bench.card()
    print(f"# {card}; jax {jax.__version__}; P3+SHOC SPAM+SI f32 65x1x50 "
          f"nens={args.nens}", flush=True)
    variants = {}
    for chunk in (args.chunk, None):
        for solver in ("pcr", "thomas"):
            name = (f"chunk={chunk or args.nens} "
                    f"({args.nens // (chunk or args.nens)} dispatches), "
                    f"{solver}")
            with tridiag.solver(solver):
                step, state, sync, compile_s, _ = bench.build(
                    "p3", "shoc", "spam", args.nens, chunk)
            _, state = bench.time_steps(step, state, sync, 3)
            variants[name] = [step, state, sync, []]
            print(f"{name}: compile + first step {compile_s:.3f} s",
                  flush=True)
    order = list(variants)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            v = variants[name]
            ms, v[1] = bench.time_steps(v[0], v[1], v[2], args.steps)
            v[3].append(ms)
    for name, v in variants.items():
        print(f"{name}: ms per CRM step best {min(v[3]):.3f} median "
              f"{statistics.median(v[3]):.3f} all "
              f"{['%.3f' % m for m in v[3]]} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
