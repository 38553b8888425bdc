#!/usr/bin/env python
"""The main path on the GPU, end to end, at the size users run.

    python chip_smoke.py              # one card, phases 1-7
    python chip_smoke.py --four       # four cards against one, nothing else
    python chip_smoke.py --rehearse   # the CPU: tiny sizes, interpret mode

Drives the normal entry points (``cloudsc2jax.cli.main`` and the
drivers) in ONE process — a JAX process reserves most of a card's memory,
so no phase spawns another.  At the upstream canonical NL size (NGPTOT
160,000 x KLEV 137, BASELINE.md) rounded to 163,840 columns:

1. device: ``jax.devices()``, the device kind, and the card's name and
   power limit as nvidia-smi reports them;
2. ``nl`` f32 through the fused kernel, the validation table against the
   cyclically expanded golden at the CLI's f32 threshold (100 eps32,
   ``cli.NL_THRESHOLD``);
3. ``nl`` f64 through the XLA path, at 10 eps64;
4. ``tl 1 100 1`` / ``ad 1 100 100`` in f64 (TEST PASSED / TEST OK), then
   the f32 TL parity and adjoint identity through the kernels at 16,384
   columns;
5. the fused NL+TL+AD work unit with the primal outputs on (CLI) and off
   (driver), finite and adjoint-consistent, the two contracts bit-equal;
6. each kernel against what XLA makes of the plain version: parity and
   median times (tools/kernel_ab.py);
7. the card-only tests, ``pytest -m gpu``, in this process.

``--four`` runs only the four-card path: ``nl`` and ``tlad`` on 655,360
columns sharded over four cards and the same on one card; outputs must
agree column for column, the validation reductions and the chunked
checksum ``psum`` within their summation-order tolerance.

Each phase prints its result line before the next starts; any failure
ends the run with a non-zero exit and no result line.  The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent


class PhaseFailed(RuntimeError):
    pass


def _check(cond, what):
    if not cond:
        raise PhaseFailed(what)


def phase(name):
    """Decorator: run the phase now, print its one result line."""
    def run(fn):
        t0 = time.perf_counter()
        summary = fn()
        print(f"[{name}] {summary} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        return summary
    return run


def cli(*argv):
    """``cloudsc2jax.cli.main(argv)`` with its report captured; the report
    is echoed to standard output and returned; a non-zero rc fails."""
    from cloudsc2jax import cli as _cli

    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc = _cli.main(list(argv))
    text = buf.getvalue()
    print(f"$ cloudsc2jax {' '.join(argv)}\n{text}", end="", flush=True)
    _check(rc == 0, f"cloudsc2jax {' '.join(argv)} exited {rc}")
    return text


def validation_clean(text, argv):
    _check("MaxRelErr-%" in text, f"{argv}: no validation table")
    _check("!!!!" not in text, f"{argv}: validation table flags a field")


def lines_with(text, key):
    return "; ".join(ln.strip() for ln in text.splitlines() if key in ln)


# ------------------------------------------------------------- one card
def one_card(rehearse):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cloudsc2jax.device import pallas_interpret

    ncol = 256 if rehearse else 163840
    nver = 256 if rehearse else 16384
    interp = pallas_interpret()

    @phase("2 nl f32 pallas")
    def _():
        from cloudsc2jax.cli import NL_THRESHOLD

        argv = ("nl", "1", str(ncol), "128", "--dtype", "f32", "--pallas")
        validation_clean(cli(*argv), argv)
        return (f"validation table clean at {NL_THRESHOLD['f32']:g} eps32, "
                f"{ncol} columns")

    @phase("3 nl f64 xla")
    def _():
        argv = ("nl", "1", str(ncol), "128", "--dtype", "f64")
        validation_clean(cli(*argv), argv)
        return f"validation table clean at 10 eps64, {ncol} columns"

    @phase("4 tl/ad")
    def _():
        _check("TEST PASSED" in cli("tl", "1", "100", "1"), "tl f64")
        _check("TEST OK" in cli("ad", "1", "100", "100"), "ad f64")
        tl = cli("tl", "1", str(nver), "1", "--pallas")
        ad = cli("ad", "1", str(nver), str(nver), "--pallas")
        _check("-> OK" in lines_with(tl, "parity"), "tl --pallas parity")
        _check("-> OK" in lines_with(ad, "identity"), "ad --pallas identity")
        return ("TEST PASSED, TEST OK (f64, 100 columns); "
                + lines_with(tl, "parity") + "; " + lines_with(ad, "identity"))

    @phase("5 tlad work unit")
    def _():
        from cloudsc2jax.cli import (
            PALLAS_AD_IDENTITY_TOL,
            _adjoint_identity,
            scaled_identity_tol,
        )
        from cloudsc2jax.drivers import run_tlad
        from cloudsc2jax.pallas import BLOCK_COLS
        from cloudsc2jax.state import Cloudsc2State

        text = cli("tlad", "1", str(ncol), str(ncol), "--dtype", "f32",
                   "--pallas")
        _check("tlad outputs finite: True" in text, "tlad outputs finite")
        state = Cloudsc2State.load(REPO / "tests" / "fixtures" / "input.npz")
        inputs = state.device_kernel_inputs(ncol, dtype=np.float32,
                                            block_multiple=BLOCK_COLS)
        runs = {wp: run_tlad(inputs, state.params, lregcl=True,
                             backend="pallas_blocked", write_primal=wp,
                             interpret=interp)
                for wp in (True, False)}
        _check(runs[False][0] is None, "write_primal=False returned primals")
        same = jax.jit(lambda a, b: jnp.all(jnp.stack(
            [jnp.all(x == y) for x, y in
             zip(jax.tree.leaves(a), jax.tree.leaves(b))])))(
            runs[True][1:], runs[False][1:])
        _check(bool(same), "primal off changed the tangents or adjoints")
        _, dout, adj = runs[False]
        rel, finite = _adjoint_identity(jax, state, inputs, dout, adj)
        tol = scaled_identity_tol(PALLAS_AD_IDENTITY_TOL,
                                  int(np.size(inputs.pt)))
        _check(finite and rel < tol, f"primal-off identity {rel:.3e}")
        return (lines_with(text, "tlad outputs finite") + "; primal off: "
                f"finite {finite}, identity {rel:.3e} (tol {tol:g}), "
                "tangents and adjoints bit-equal to primal on")

    @phase("6 kernel vs xla")
    def _():
        from cloudsc2jax.state import Cloudsc2State
        from tools import kernel_ab

        state = Cloudsc2State.load(REPO / "tests" / "fixtures" / "input.npz")
        inputs = state.device_kernel_inputs(ncol, dtype=np.float32)
        print(f"tolerance reason: {kernel_ab.TOLERANCE_REASON}")
        recs = kernel_ab.compare(state.params, inputs,
                                 repeats=2 if rehearse else 10)
        for r in recs:
            _check(r["parity_ok"], f"{r['sweep']} parity {r}")
        return json.dumps(recs)

    @phase("7 pytest -m gpu")
    def _():
        import pytest

        os.environ["CLOUDSC2_TESTS_IN_PROCESS"] = "1"
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          str(REPO / "tests" / "test_gpu.py")])
        _check(rc == 0, f"pytest -m gpu exited {rc}")
        return "card-only tests passed" if not rehearse else \
            "card-only tests collected and skipped on the CPU"


# ----------------------------------------------------------- four cards
def four_cards(rehearse):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cloudsc2jax.device import pallas_interpret

    ncol = 2048 if rehearse else 655360
    interp = pallas_interpret()

    @phase("four: cli")
    def _():
        for ndev in ("4", "1"):
            argv = ("nl", ndev, str(ncol), "128", "--dtype", "f32",
                    "--pallas")
            validation_clean(cli(*argv), argv)
            text = cli("tlad", ndev, str(ncol), str(ncol), "--dtype", "f32",
                       "--pallas")
            _check("tlad outputs finite: True" in text, f"tlad {ndev}")
        return f"nl and tlad at {ncol} columns on 4 cards and on 1: clean"

    @phase("four: column for column")
    def _():
        from cloudsc2jax import dist
        from cloudsc2jax.drivers import run_chunked, run_nl, run_tlad
        from cloudsc2jax.pallas import BLOCK_COLS, unblock_outputs
        from cloudsc2jax.state import Cloudsc2State

        state = Cloudsc2State.load(REPO / "tests" / "fixtures" / "input.npz")
        mesh = dist.column_mesh(jax.devices()[:4])
        one = state.device_kernel_inputs(ncol, dtype=np.float32,
                                         block_multiple=BLOCK_COLS * 4)
        four = dist.shard_inputs(one, mesh, axis=1)
        equal = jax.jit(lambda a, b: jnp.all(jnp.stack(
            [jnp.all(x == y) for x, y in
             zip(jax.tree.leaves(a), jax.tree.leaves(b))])))
        kw = dict(backend="pallas_blocked", interpret=interp)
        nl4 = run_nl(four, state.params, mesh=mesh, **kw)
        nl1 = run_nl(one, state.params, **kw)
        _check(bool(equal(nl4, dist.shard_inputs(nl1, mesh, axis=1))),
               "nl: 4 cards differ from 1")
        t4 = run_tlad(four, state.params, mesh=mesh, **kw)
        t1 = run_tlad(one, state.params, **kw)
        _check(bool(equal(t4, dist.shard_inputs(t1, mesh, axis=1))),
               "tlad: 4 cards differ from 1")

        # the validation reductions: min/max exact, sums to f32 order
        ref = REPO / "tests" / "fixtures" / "reference.npz"
        errs = []
        for out, inp in ((nl4, four), (nl1, one)):
            std = unblock_outputs(out, state.params, ncol)
            errs.append(state.device_errors(
                std, inp._replace(plude=inp.plude.T[:ncol]), ref))
        worst = 0.0
        for k, e4 in errs[0].items():
            e1 = errs[1][k]
            _check((e4.zminval, e4.zmaxval, e4.zmaxerr)
                   == (e1.zminval, e1.zmaxval, e1.zmaxerr), f"{k} min/max")
            for a, b in ((e4.zerrsum, e1.zerrsum), (e4.zsum, e1.zsum)):
                worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
        _check(worst < 1e-5, f"validation sums differ by {worst:.2e}")
        sums = {}
        for variant in ("nl", "tlad"):
            c4 = run_chunked(state, ncol, variant=variant, chunk=ncol,
                             mesh=mesh, interpret=interp)[1]
            c1 = run_chunked(state, ncol, variant=variant, chunk=ncol,
                             interpret=interp)[1]
            sums[variant] = abs(c4 - c1) / max(abs(c1), 1e-30)
            _check(sums[variant] < 1e-4, f"{variant} psum checksum {sums}")
        return (f"nl and tlad outputs equal column for column on 4 cards and "
                f"1; validation sums agree to {worst:.2e} (tol 1e-05); "
                f"checksum psum rel diff nl {sums['nl']:.2e}, tlad "
                f"{sums['tlad']:.2e} (tol 1e-04)")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="CLOUDSC2 main path on the GPU at full width")
    p.add_argument("--four", action="store_true",
                   help="only the four-card path and its one-card check")
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU at tiny sizes, kernels in interpret "
                        "mode")
    args = p.parse_args(argv)
    ndev = 4 if args.four else 1

    if not (REPO / "cloudsc2jax" / "cli.py").exists():
        print("chip_smoke.py: the cloudsc2jax package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
                 if "host_platform_device_count" not in f]
        os.environ["XLA_FLAGS"] = " ".join(
            flags + [f"--xla_force_host_platform_device_count={ndev}"])

    import jax

    from cloudsc2jax.device import nvidia_smi

    want = "cpu" if args.rehearse else "gpu"

    @phase("1 device")
    def _():
        devs = jax.devices()
        print(f"jax.devices(): {devs}")
        print(f"device_kind: {devs[0].device_kind}")
        print(f"nvidia-smi name, power.limit: {nvidia_smi()}")
        _check(devs[0].platform == want,
               f"platform {devs[0].platform!r}, this run needs {want!r}")
        _check(len(devs) >= ndev, f"{len(devs)} devices, need {ndev}")
        return f"{devs[0].platform} {devs[0].device_kind} x{len(devs)}"

    (four_cards if args.four else one_card)(args.rehearse)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


def run(argv=None):
    """``main`` with a failed phase turned into exit code 1."""
    try:
        return main(argv)
    except PhaseFailed as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(run())
