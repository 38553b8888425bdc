#!/usr/bin/env python
"""Throughput of one work unit on one GPU: grid columns per second.

Configuration: NGPTOT=327680 (2x the README's 160k reference config,
override with CLOUDSC2_BENCH_NGPTOT), KLEV=137, f32 working precision
(the reference's -DSINGLE analogue; f64 is the validation path).

    CLOUDSC2_BENCH_VARIANT=nl|tlad|chunked|chunked_tlad python bench.py

``nl`` is the fused NL kernel (or the plain XLA scan with
CLOUDSC2_BENCH_PALLAS=0), ``tlad`` the fused NL+TL+AD work unit,
``chunked*`` the beyond-device-memory streaming runs.  Times are medians
of CLOUDSC2_BENCH_REPEATS calls after a warm-up call, each ended by
``block_until_ready``.  Prints ONE JSON record naming the platform, the
device kind and count and the card's power limit; it stops on any
platform but the GPU.  ``vs_baseline`` compares against the reference's
own per-core nominal rate derived from its ZHPM flop accounting: the
dwarf self-reports MFlop/s against ZHPM = 3 996 006 flops/100 columns
(cloudsc_driver_mod.F90:58); a strong CPU core sustains ~O(3) GFlop/s on
this kernel, i.e. ~75k columns/s/core → 4 OpenMP threads ≈ 300k cols/s
(README.md:47 config).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from tools.kernel_ab import median_time

# the reference's 4-strong-OpenMP-thread CPU estimate derived from its
# own ZHPM flop accounting (module header)
BASELINE_COLS_PER_S = 300_000.0


def device_record():
    """Platform, device kind and count, and the card's power limit."""
    import jax

    from cloudsc2jax.device import nvidia_smi

    d = jax.devices()
    return {"platform": d[0].platform, "device_kind": d[0].device_kind,
            "device_count": len(d), "power_limit": nvidia_smi("power.limit")}


def main():
    import jax
    import jax.numpy as jnp

    from cloudsc2jax.cache import enable_compile_cache
    from cloudsc2jax.state import Cloudsc2State

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; found {jax.devices()}")
    enable_compile_cache()

    ngptot = int(os.environ.get("CLOUDSC2_BENCH_NGPTOT", 327680))
    repeats = int(os.environ.get("CLOUDSC2_BENCH_REPEATS", 20))
    use_pallas = os.environ.get("CLOUDSC2_BENCH_PALLAS", "1") == "1"
    variant = os.environ.get("CLOUDSC2_BENCH_VARIANT", "nl")
    state = Cloudsc2State.synthetic(ngptot=100, nlev=137)
    record = {}

    if variant.startswith("chunked"):
        from cloudsc2jax import dist
        from cloudsc2jax.drivers import run_chunked

        inner = "tlad" if variant.endswith("tlad") else "nl"
        chunk = int(os.environ.get("CLOUDSC2_BENCH_CHUNK", 327680))
        mesh = dist.column_mesh()
        ngptot = int(os.environ.get("CLOUDSC2_BENCH_NGPTOT", 1310720))
        cols, s = run_chunked(state, ngptot, variant=inner, chunk=chunk,
                              mesh=mesh)
        assert np.isfinite(s)
        dt = median_time(
            lambda: run_chunked(state, ngptot, variant=inner, chunk=chunk,
                                mesh=mesh),
            repeats=repeats)
        ndev = int(mesh.devices.size)
        impl = "chunked"
        record.update(chunk=chunk, mesh_devices=ndev,
                      mesh_columns_per_second=cols / dt)
        cols_per_s = cols / dt / ndev
        variant, ngptot = inner, cols
    else:
        from functools import partial

        from cloudsc2jax.pallas import BLOCK_COLS

        if variant == "tlad":
            from cloudsc2jax.drivers import run_tlad

            # CLOUDSC2_BENCH_WRITE_PRIMAL=0 sheds the 8 primal output
            # streams (only δy and x̄ enter the AD driver's verification
            # norms, cloudsc_driver_ad_mod.F90:160-256); the blocked
            # kernels alone can shed them
            wp = (not use_pallas or os.environ.get(
                "CLOUDSC2_BENCH_WRITE_PRIMAL", "1") == "1")
            impl = "pallas_blocked" if use_pallas else "xla"
            fn = partial(run_tlad, params=state.params, lregcl=True,
                         backend=impl, write_primal=wp)
            if not wp:
                impl += "_noprim"
        elif use_pallas:
            from cloudsc2jax.pallas.cloudsc2_kernel import cloudsc2_pallas

            # padded levels-major inputs, raw outputs; fuse_satur folds
            # the driver's SATUR call into the sweep (the reference work
            # unit is SATUR + CLOUDSC2 per block,
            # cloudsc_driver_mod.F90:91-107)
            fn = jax.jit(partial(cloudsc2_pallas, params=state.params,
                                 blocked=True, fuse_satur=True))
            impl = "pallas_blocked"
        else:
            from cloudsc2jax.physics.cloudsc2 import cloudsc2

            fn = jax.jit(partial(cloudsc2, params=state.params))
            impl = "xla"
        inputs = state.device_kernel_inputs(
            ngptot, dtype=np.float32,
            block_multiple=BLOCK_COLS if "blocked" in impl else None,
        )
        out = fn(inputs)
        assert all(bool(jnp.all(jnp.isfinite(o)))
                   for o in jax.tree.leaves(out))
        dt = median_time(fn, inputs, repeats=repeats)
        cols_per_s = ngptot / dt
        if variant == "tlad" and use_pallas:
            from cloudsc2jax.cli import measure_f32_verdicts

            v_inputs = state.device_kernel_inputs(min(ngptot, 16384),
                                                  dtype=np.float32)
            record["f32_verdicts"] = measure_f32_verdicts(state, v_inputs)

    record = {
        "metric": f"{variant}_columns_per_second_{impl}",
        "value": cols_per_s,
        "unit": "columns/s/chip",
        "vs_baseline": cols_per_s / BASELINE_COLS_PER_S,
        "ngptot": ngptot,
        "ms_per_call": dt * 1e3,
        **device_record(),
        **record,
    }
    measured = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "BASELINE_MEASURED.json"
    )
    with open(measured) as f:
        m = json.load(f)
    # measured single-core CPU provenance of the estimate above
    # (tools/measure_baseline.py)
    record["baseline"] = {
        "estimate_cols_per_s": BASELINE_COLS_PER_S,
        "measured_numpy_port_cols_per_s": m["numpy_port_cols_per_s"],
        "measured_xla_cpu_f64_cols_per_s": m["xla_cpu_f64_cols_per_s"],
        "provenance": "tools/measure_baseline.py (single-core host)",
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
