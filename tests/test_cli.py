"""CLI entry-point tests (reference UX: dwarf_cloudsc argv/env handling)."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(args, env_extra=None, timeout=560):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "cloudsc2jax", *args],
        capture_output=True,
        text=True,
        env=env,
        cwd=REPO,
        timeout=timeout,
    )


@pytest.mark.slow
def test_cli_nl_validates():
    r = _run(["nl", "1", "100", "100"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Variable" in r.stderr  # validation table header


@pytest.mark.slow
def test_cli_tl_passes():
    r = _run(["tl", "1", "100", "1"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "TEST PASSED" in r.stderr


@pytest.mark.slow
def test_cli_ad_passes():
    r = _run(["ad", "1", "100", "100"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "TEST OK" in r.stderr


@pytest.mark.slow
def test_cli_write_reference_roundtrip(tmp_path):
    """CLOUDSC2_WRITE_REFERENCE writes a golden that a subsequent
    validation run passes against bit-for-bit (the reference's own
    golden-regeneration workflow, cloudsc2_array_state_mod.F90:260-287)."""
    r = _run(
        ["nl", "1", "100", "100", "--no-validate"],
        env_extra={"CLOUDSC2_WRITE_REFERENCE": "1"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    written = REPO / "reference.npz"
    assert written.exists()
    try:
        r2 = _run(["nl", "1", "100", "100", "--reference", str(written)])
        assert r2.returncode == 0, r2.stderr[-2000:]
        assert "MaxRelErr-%" in r2.stderr
        assert "!!!!" not in r2.stderr  # exact self-consistency
    finally:
        written.unlink()


@pytest.mark.slow
def test_cli_tl_pallas_runs_fused_check():
    """tl --pallas must RUN the fused-kernel f32 parity check (not ignore
    the flag, VERDICT r1 item 4); interpret mode on CPU."""
    r = _run(["tl", "1", "100", "1", "--pallas"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "TEST PASSED" in r.stderr
    assert "TL(pallas) vs jvp parity" in r.stderr
    assert "-> OK" in r.stderr


@pytest.mark.slow
def test_cli_ad_pallas_runs_fused_identity():
    r = _run(["ad", "1", "100", "100", "--pallas"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "TEST OK" in r.stderr
    assert "AD(pallas) identity" in r.stderr
    assert "-> OK" in r.stderr


@pytest.mark.slow
def test_cli_profile_writes_trace(tmp_path):
    """--profile DIR captures a jax profiler trace (the DR_HOOK/observability
    analogue, SURVEY §5.1)."""
    prof = tmp_path / "trace"
    r = _run(["nl", "1", "100", "100", "--no-validate",
              "--profile", str(prof)])
    assert r.returncode == 0, r.stderr[-2000:]
    files = list(prof.rglob("*"))
    assert any(f.is_file() for f in files), "no trace artifacts written"


@pytest.mark.slow
def test_cli_nl_pallas_on_cpu_interprets(tmp_path):
    """nl --pallas on the CPU must run the kernel in interpret mode (and
    say so) instead of dying in the GPU compiler."""
    import sys as _sys

    _sys.path.insert(0, str(REPO))
    from cloudsc2jax import io as cio

    fields, params = cio.synthetic_state(nlon=40, nlev=9)
    tiny = tmp_path / "tiny_input.h5"
    cio.write_input_h5(tiny, fields, params)
    r = _run(["nl", "1", "100", "100", "--pallas", "--dtype", "f32",
              "--input", str(tiny), "--no-validate"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Pallas interpret mode" in r.stderr


def test_adjoint_identity_helper_both_contracts():
    """cli._adjoint_identity computes the work-unit identity on BOTH
    tangent contracts: the standard 10-field Cloudsc2Outputs (f64 XLA
    path) and the blocked 8-stream contract, whose rfln/sfln norms must
    carry the (1+L²) weights the dscale work unit folds out of the
    streams (fold_flux_seeds) — an unweighted blocked norm would break
    <Mdx,Mdx> = <dx,M^TMdx>."""
    import jax
    import numpy as np

    from cloudsc2jax.cli import _adjoint_identity
    from cloudsc2jax.drivers import run_tlad
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=17)

    # standard contract, f64 XLA backend
    inputs = st.kernel_inputs(dtype=np.float64)
    _, dout, adj = run_tlad(inputs, st.params, lregcl=True, backend="xla")
    rel, finite = _adjoint_identity(jax, st, inputs, dout, adj)
    assert finite and rel < 1e-10, rel

    # blocked 8-stream contract (dscale work unit), f32 interpret
    blk = st.device_kernel_inputs(256, dtype=np.float32,
                                  block_multiple=128)
    _, doutb, adjb = run_tlad(blk, st.params, lregcl=True,
                              backend="pallas_blocked", interpret=True)
    assert hasattr(doutb, "rfln")  # the weighted branch is exercised
    relb, finiteb = _adjoint_identity(jax, st, blk, doutb, adjb)
    assert finiteb and relb < 1e-2, relb


def test_measure_f32_verdicts_contract(state):
    """bench.py's f32 verdict emitter: returns the measured TL-parity /
    adjoint-identity values with their CLI tolerances, and the measured
    values sit under the tolerances."""
    import numpy as np

    from cloudsc2jax.cli import (
        PALLAS_AD_IDENTITY_TOL,
        PALLAS_TL_PARITY_TOL,
        measure_f32_verdicts,
    )

    inputs = state.kernel_inputs(dtype=np.float32)
    m = measure_f32_verdicts(state, inputs)
    assert m["finite"]
    assert m["tl_parity_tol"] == PALLAS_TL_PARITY_TOL
    # the small CLI test config sits at/below the anchor size, so the
    # scaled tolerance equals the base value here
    assert m["ad_identity_tol"] == PALLAS_AD_IDENTITY_TOL
    # CPU interpret-mode values (~2.3e-7 TL) sit only ~4x under the
    # on-chip tolerances; gate CI at 10x the tolerance so an XLA
    # reduction-reassociation upgrade can't flake the default suite —
    # the tight bound is enforced on the card (chip_smoke.py phase 4)
    assert 0.0 <= m["tl_parity_rel_err"] < 10 * PALLAS_TL_PARITY_TOL
    assert 0.0 <= m["ad_identity_rel_err"] < 10 * PALLAS_AD_IDENTITY_TOL


def test_measure_device_lanes_marks_rows():
    """--per-device-timing's engine (timer.measure_device_lanes): each
    device lane's clock is a genuine per-shard measurement (not a lane-0
    mirror) and the perf table labels the rows `(measured)` — the
    per-execution-lane clock semantics of timer_mod.F90:56-112, which a
    single-controller SPMD run can otherwise only mirror."""
    import io
    from functools import partial

    import jax
    import numpy as np

    from cloudsc2jax import dist
    from cloudsc2jax.drivers import run_nl
    from cloudsc2jax.state import Cloudsc2State
    from cloudsc2jax.timer import PerformanceTimer

    st = Cloudsc2State.synthetic(ngptot=100, nlev=9)
    ndev = 4
    mesh = dist.column_mesh(jax.devices()[:ndev])
    inp = dist.shard_inputs(
        st.device_kernel_inputs(512, dtype=np.float64), mesh
    )
    t = PerformanceTimer()
    t.start(ndev)
    t.thread_start(0)
    jax.block_until_ready(run_nl(inp, st.params))
    t.spmd_log(ndev, 512)
    t.thread_end(0)
    t.mirror_times(ndev)
    t.measure_device_lanes(partial(run_nl, params=st.params), inp, repeats=1)
    t.end()
    buf = io.StringIO()
    t.print_performance(128, 4, 512, file=buf)
    table = buf.getvalue()
    assert table.count("(measured)") == ndev
    assert "(mirror)" not in table
    lanes = sorted(t._lanes.values(), key=lambda l: l.lane_id)
    assert len(lanes) == ndev
    assert all(l.measured_lane and l.t_total > 0 for l in lanes)
    # each lane timed ITS OWN device's shard (core_id records device id)
    assert [l.core_id for l in lanes] == sorted(
        d.id for d in mesh.devices.ravel()
    )


@pytest.mark.slow
def test_cli_per_device_timing_flag():
    """End-to-end: `nl --per-device-timing` on a 4-device run prints one
    measured row per device."""
    r = _run(["nl", "4", "512", "128", "--no-validate", "--dtype", "f32",
              "--per-device-timing"],
             env_extra={"CLOUDSC2_NUM_CPU_DEVICES": "4"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stderr.count("(measured)") == 4
    assert "(mirror)" not in r.stderr


def test_measure_device_lanes_scales_with_repeat():
    """The measured lane clock is scaled by calls_equivalent (the CLI's
    --repeat): the lane's logged columns carry the repeat multiplier, so
    an unscaled single-execution clock would inflate col/s repeat-fold."""
    import time as _time

    import jax

    from cloudsc2jax.timer import PerformanceTimer

    ndev = 2
    mesh_devs = jax.devices()[:ndev]
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    import numpy as np

    mesh = Mesh(np.array(mesh_devs).reshape(ndev), ("c",))
    x = jax.device_put(
        jnp.zeros((ndev * 4,)), NamedSharding(mesh, PartitionSpec("c"))
    )

    def slow_step(local):
        _time.sleep(0.02)
        return 0.0

    t = PerformanceTimer()
    t.start(ndev)
    t.spmd_log(ndev, 800)  # 100 cols x repeat=4 x 2 lanes
    t.end()
    t.measure_device_lanes(slow_step, {"x": x}, repeats=1,
                           calls_equivalent=4)
    lanes = sorted(t._lanes.values(), key=lambda l: l.lane_id)
    # ~0.02s per execution x 4 equivalent calls, generous CI bounds
    assert all(0.06 < l.t_total < 2.0 for l in lanes)
    assert all(l.measured_lane for l in lanes)
