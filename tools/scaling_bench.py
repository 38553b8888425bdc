#!/usr/bin/env python
"""Weak-scaling benchmark over the device mesh.

Measures grid-columns/second for 1..N devices at a fixed per-device
column count (weak scaling), reporting parallel efficiency — the
framework's version of the reference's MPI scaling story (domain
decomposition over grid points with zero kernel communication,
SURVEY §3.4, so efficiency should be ~100% minus dispatch overheads).

On a single-chip host this still exercises the full sharded path when run
with a virtual CPU mesh:

    JAX_PLATFORMS=cpu python tools/scaling_bench.py --devices 8 --percols 8192
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0, help="max devices (0 = all)")
    ap.add_argument("--percols", type=int, default=16384, help="columns per device")
    ap.add_argument("--dtype", choices=["f32", "f64"], default="f32")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--backend", choices=["xla", "pallas"], default="xla",
                    help="pallas = fused kernel SPMD-wrapped per device "
                         "(shard_map); add --interpret on the CPU")
    ap.add_argument("--variant", choices=["nl", "tlad"], default="nl",
                    help="nl = forward sweep; tlad = fused NL+TL+AD work unit")
    ap.add_argument("--interpret", action="store_true")
    args = ap.parse_args()

    import jax

    # apply JAX_PLATFORMS to the live config (same pattern as cli.py)
    plat = os.environ.get("JAX_PLATFORMS")
    if plat:
        jax.config.update("jax_platforms", plat)
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    from functools import partial

    from cloudsc2jax import dist
    from cloudsc2jax.physics.cloudsc2 import cloudsc2
    from cloudsc2jax.state import Cloudsc2State

    all_devices = jax.devices()
    nmax = args.devices or len(all_devices)
    dtype = np.float32 if args.dtype == "f32" else np.float64

    results = []
    base_rate = None
    for nd in range(1, nmax + 1):
        if len(all_devices) < nd:
            break
        mesh = dist.column_mesh(all_devices[:nd])
        ng = args.percols * nd
        state = Cloudsc2State.synthetic(ngptot=100, nlev=137)
        # device-side expansion: host never materialises ng columns
        inputs = dist.shard_inputs(
            state.device_kernel_inputs(ng, dtype=dtype), mesh
        )
        if args.variant == "tlad":
            from cloudsc2jax.drivers import run_tlad

            fn = partial(
                run_tlad, params=state.params, lregcl=True,
                backend=args.backend,
                mesh=mesh if args.backend == "pallas" else None,
                interpret=args.interpret,
            )
        elif args.backend == "pallas":
            from cloudsc2jax.pallas.cloudsc2_kernel import cloudsc2_pallas

            kfn = partial(
                cloudsc2_pallas, params=state.params,
                interpret=args.interpret,
            )
            fn = jax.jit(dist.shard_map_columns(kfn, mesh, inputs))
        else:
            fn = jax.jit(partial(cloudsc2, params=state.params))
        import jax.numpy as jnp

        from tools.kernel_ab import median_time

        # full reductions: the standard-layout outputs are assembled by
        # XLA after the kernel, so every leaf must be consumed
        scalar_step = jax.jit(
            lambda v: sum(jnp.sum(o) for o in jax.tree.leaves(fn(v))))
        dt = median_time(scalar_step, inputs, repeats=args.repeats)
        rate = ng / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        results.append(
            {"devices": nd, "ngptot": ng, "cols_per_s": round(rate, 1),
             "efficiency": round(eff, 4)}
        )
        print(json.dumps(results[-1]))
    return results


if __name__ == "__main__":
    main()
