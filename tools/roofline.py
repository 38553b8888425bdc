#!/usr/bin/env python
"""Roofline of the fused NL kernel.

Computes the per-column byte/flop budget of the fused NL kernel and turns
a measured runtime into attained fractions of the device-memory and f32
ceilings.

The kernel's cost model (per column, per level):
  - reads: 14 level fields + plu(k+1) + paph twice (plu and the upper
    paph row are the same buffers, mostly served from cache)
  - writes: 8 outputs
  - ~292 "nominal" flops (the reference's own ZHPM accounting,
    cloudsc_driver_mod.F90:58) plus ~10 transcendentals (exp/tanh/sqrt
    /pow, SURVEY §3.5), which run on the special-function units and are
    not counted against the f32 peak

Peaks come from ``--device-kind`` (a ``jax.devices()[0].device_kind``)
looked up in ``PEAKS``, or are passed in with ``--mem-gbps`` and
``--f32-tflops``; an unknown device is an error, never a default.

    python tools/roofline.py --ms 1.5 --device-kind "NVIDIA H100 80GB HBM3"
"""

import argparse
import json

NLEV = 137

READS_PER_LEVEL = 14 + 3
WRITES_PER_LEVEL = 8
FLOPS_PER_LEVEL = 292  # ZHPM / (100 cols * 137 levels)

# Published peaks (NVIDIA H100 data sheet, SXM part, dense, at the 700 W
# power limit): device memory GB/s, f32 TFLOP/s outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"mem_gbps": 3350.0, "f32_tflops": 67.0},
}


def peaks_for(device_kind=None, mem_gbps=None, f32_tflops=None):
    """(mem_gbps, f32_tflops): both passed in, or looked up by kind."""
    if mem_gbps is not None and f32_tflops is not None:
        return mem_gbps, f32_tflops
    if device_kind not in PEAKS:
        raise KeyError(
            f"no peaks for device kind {device_kind!r}: pass --mem-gbps and "
            f"--f32-tflops, or add it to PEAKS (known: {sorted(PEAKS)})"
        )
    p = PEAKS[device_kind]
    return p["mem_gbps"], p["f32_tflops"]


def roofline(ngptot, ms, mem_gbps, f32_tflops, dtype_bytes=4):
    bytes_total = (
        (READS_PER_LEVEL + WRITES_PER_LEVEL) * NLEV * ngptot * dtype_bytes
    )
    flops_total = FLOPS_PER_LEVEL * NLEV * ngptot
    t = ms * 1e-3
    mem_time = bytes_total / (mem_gbps * 1e9)
    compute_time = flops_total / (f32_tflops * 1e12)
    return {
        "measured_ms": ms,
        "cols_per_s": ngptot / t,
        "traffic_gb": bytes_total / 1e9,
        "attained_gbps": bytes_total / t / 1e9,
        "memory_floor_ms": mem_time * 1e3,
        "compute_floor_ms": compute_time * 1e3,
        "bound": "memory" if mem_time > compute_time else "compute",
        "roofline_fraction": max(mem_time, compute_time) / t,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ngptot", type=int, default=163840)
    ap.add_argument("--ms", type=float, required=True,
                    help="measured kernel ms")
    ap.add_argument("--dtype-bytes", type=int, default=4)
    ap.add_argument("--device-kind", default=None)
    ap.add_argument("--mem-gbps", type=float, default=None)
    ap.add_argument("--f32-tflops", type=float, default=None)
    args = ap.parse_args()
    mem, f32 = peaks_for(args.device_kind, args.mem_gbps, args.f32_tflops)
    print(json.dumps(roofline(args.ngptot, args.ms, mem, f32,
                              args.dtype_bytes), indent=1))


if __name__ == "__main__":
    main()
