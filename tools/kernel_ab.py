"""Each Pallas kernel against what XLA makes of the plain version.

For each hand-written sweep — NL, TL and reverse AD — runs the kernel and
the plain reference (the ``lax.scan`` of ``physics/cloudsc2.py``, under
``jax.jvp`` / ``jax.vjp`` for TL and AD) on identical f32 inputs, both on
the standard ``(ncol, nlev)`` contract.  Prints, per sweep, the largest
error relative to each field's maximum beside its tolerance, then the
median time of both (warm-up call first, every call ended by
``block_until_ready``).

    python tools/kernel_ab.py [--ncol 163840] [--repeats 10]

Exits non-zero if any error is over its tolerance.  Needs a GPU: on any
other platform it stops.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Tolerances on max|kernel - xla| / max|xla| per field, and why.  Readings
# at 163,840 columns f32 on an H100 80GB HBM3 (700 W): NL 3.1e-7 and TL
# 2.9e-7 (both tenl_i), AD 2.1e-5 (plu).
TOLERANCE_REASON = (
    "the kernels have no matrix products, so TF32 never enters: kernel and "
    "XLA differ only in their exp/tanh/pow implementations and the order "
    "of a few sums, carried down the 137-level recurrence; NL and TL read "
    "~3e-7 on the H100 and are held to 5e-6, ~16x that; AD's worst field "
    "is the plu adjoint, a sum of contributions from two levels' bodies "
    "taken in another order, at 2.1e-5 on the H100 and 5.2e-5 in interpret "
    "mode on the CPU, held to 1e-4")
TOLERANCES = {"nl": 5e-6, "tl": 5e-6, "ad": 1e-4}


def max_rel_errors(got, want):
    """{field: max|got - want| / max|want|} over two NamedTuples of
    arrays, one device program and one fetch."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def errs(a, b):
        return [jnp.max(jnp.abs(x - y)) / jnp.maximum(jnp.max(jnp.abs(y)),
                                                      1e-30)
                for x, y in zip(a, b)]

    return dict(zip(want._fields, (float(v) for v in errs(got, want))))


def median_time(fn, *args, repeats=10):
    """Median seconds of ``repeats`` calls after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def sweeps(params, inputs):
    """{sweep: (kernel_fn, xla_fn, args, compare)} on the standard
    contract; ``compare`` picks the outputs the parity is taken on."""
    import jax

    from cloudsc2jax.device import pallas_interpret
    from cloudsc2jax.drivers import DSCALE
    from cloudsc2jax.pallas.cloudsc2_kernel import cloudsc2_pallas
    from cloudsc2jax.pallas.tlad_kernel import (
        cloudsc2_pallas_ad,
        cloudsc2_pallas_tl,
    )
    from cloudsc2jax.physics.cloudsc2 import cloudsc2
    from cloudsc2jax.tlad import cloudsc2_ad, cloudsc2_tl

    interpret = pallas_interpret()
    d_inputs = jax.tree.map(lambda x: DSCALE * x, inputs)
    # the AD driver's seed: the TL image of the canonical increments
    _, seeds = jax.jit(partial(cloudsc2_tl, params=params, lregcl=True))(
        inputs, d_inputs)
    return {
        "nl": (jax.jit(partial(cloudsc2_pallas, params=params,
                               interpret=interpret)),
               jax.jit(partial(cloudsc2, params=params)),
               (inputs,), lambda r: r),
        "tl": (jax.jit(partial(cloudsc2_pallas_tl, params=params,
                               lregcl=True, interpret=interpret)),
               jax.jit(partial(cloudsc2_tl, params=params, lregcl=True)),
               (inputs, d_inputs), lambda r: r[1]),
        "ad": (jax.jit(partial(cloudsc2_pallas_ad, params=params,
                               lregcl=True, interpret=interpret)),
               jax.jit(partial(cloudsc2_ad, params=params, lregcl=True)),
               (inputs, seeds), lambda r: r[1]),
    }


def compare(params, inputs, *, repeats=10, out=print):
    """Parity and times of each sweep; returns one record per sweep."""
    records = []
    for name, (kern, xla, args, pick) in sweeps(params, inputs).items():
        errs = max_rel_errors(pick(kern(*args)), pick(xla(*args)))
        worst = max(errs, key=errs.get)
        tol = TOLERANCES[name]
        rec = {"sweep": name, "max_rel_err": errs[worst],
               "worst_field": worst, "tol": tol,
               "parity_ok": errs[worst] <= tol,
               "kernel_ms": 1e3 * median_time(kern, *args, repeats=repeats),
               "xla_ms": 1e3 * median_time(xla, *args, repeats=repeats)}
        records.append(rec)
        out(f"{name}: max rel err {errs[worst]:.3e} ({worst}; tol {tol:g})"
            f" kernel {rec['kernel_ms']:.3f} ms xla {rec['xla_ms']:.3f} ms")
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ncol", type=int, default=163840)
    p.add_argument("--repeats", type=int, default=10)
    args = p.parse_args(argv)

    import jax
    import numpy as np

    from cloudsc2jax.cache import enable_compile_cache
    from cloudsc2jax.state import Cloudsc2State

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"kernel_ab needs a GPU, found {jax.devices()}")
    enable_compile_cache()
    state = Cloudsc2State.synthetic(ngptot=100, nlev=137)
    inputs = state.device_kernel_inputs(args.ncol, dtype=np.float32)
    records = compare(state.params, inputs, repeats=args.repeats)
    print(json.dumps(records))
    if not all(r["parity_ok"] for r in records):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
