"""Pallas fused kernel vs pure-JAX reference path (interpret mode on CPU).

The Pallas kernel re-schedules the identical math for the GPU (a grid over
column blocks, the level loop inside the program, the carry in
registers); these tests pin its semantics to the lax.scan implementation
in f32, and check what surrounds it: padding, layouts, the choice of the
Triton route, and that the zero-copy path adds no relayout.
"""

import numpy as np
import pytest

from cloudsc2jax.pallas.cloudsc2_kernel import cloudsc2_pallas
from cloudsc2jax.physics.cloudsc2 import cloudsc2


@pytest.fixture(scope="module")
def f32_inputs(state):
    return state.kernel_inputs(dtype=np.float32)


def test_pallas_matches_scan_f32(state, f32_inputs):
    ref = cloudsc2(f32_inputs, state.params)
    out = cloudsc2_pallas(f32_inputs, state.params, interpret=True)
    for name, a, b in zip(out._fields, out, ref):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 5e-6, name


def test_pallas_pads_arbitrary_column_counts(state):
    # 100 columns -> one padded 128-column block; padding must not leak
    # into the first 100 columns
    small = state.kernel_inputs(dtype=np.float32)
    out_small = cloudsc2_pallas(small, state.params, interpret=True)
    assert np.asarray(out_small.pclc).shape == (100, 137)
    assert np.isfinite(np.asarray(out_small.tenl_t)).all()


def test_pallas_levels_major_matches(state, f32_inputs):
    """The zero-transpose levels-major layout is a pure re-layout."""
    ref = cloudsc2_pallas(f32_inputs, state.params, interpret=True)
    lm_in = type(f32_inputs)(*(np.ascontiguousarray(x.T) for x in f32_inputs))
    lm = cloudsc2_pallas(
        lm_in, state.params, interpret=True, levels_major=True
    )
    for a, b in zip(lm, ref):
        np.testing.assert_array_equal(np.asarray(a).T, np.asarray(b))


def test_pallas_blocked_path_matches(state):
    """The zero-copy blocked path (inputs generated padded levels-major,
    raw outputs returned) must match the standard path exactly."""
    import numpy as np

    from cloudsc2jax.pallas.cloudsc2_kernel import BLOCK_COLS, unblock_outputs
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=23)
    ncol = 256
    std = st.device_kernel_inputs(ncol, dtype=np.float32)
    blk = st.device_kernel_inputs(ncol, dtype=np.float32,
                                  block_multiple=BLOCK_COLS)
    ref = cloudsc2_pallas(std, st.params, interpret=True)
    bout = cloudsc2_pallas(blk, st.params, blocked=True, interpret=True)
    out = unblock_outputs(bout, st.params, ncol)
    for name, a, b in zip(ref._fields, out, ref):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 1e-6, name


def test_pallas_fuse_satur_matches(state):
    """In-kernel qsat (fuse_satur: SATUR + CLOUDSC2 as one sweep) matches
    the streamed-PQS path."""
    import numpy as np

    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=23)
    blk = st.device_kernel_inputs(256, dtype=np.float32, block_multiple=128)
    ref = cloudsc2_pallas(blk, st.params, blocked=True, interpret=True)
    fused = cloudsc2_pallas(
        blk, st.params, blocked=True, fuse_satur=True, interpret=True
    )
    for name, a, b in zip(ref._fields, fused, ref):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 2e-5, name


def test_pallas_rejects_lphylin_false(state):
    """The fused kernels hardcode the LPHYLIN branch; a non-LPHYLIN
    configuration must be refused, not silently diverged from
    (physics.cloudsc2 carries the FOEALFA branch)."""
    import dataclasses

    import pytest as _pytest

    from cloudsc2jax.pallas.tlad_kernel import cloudsc2_pallas_tl

    inputs = state.kernel_inputs(dtype=np.float32)
    params = dataclasses.replace(
        state.params,
        yrephli=dataclasses.replace(state.params.yrephli, lphylin=False),
    )
    with _pytest.raises(NotImplementedError):
        cloudsc2_pallas(inputs, params, interpret=True)
    with _pytest.raises(NotImplementedError):
        cloudsc2_pallas_tl(inputs, inputs, params, interpret=True)


@pytest.mark.parametrize("seed,nlev,ncol,ldrain1d", [
    (7, 11, 97, False),     # odd ncol: tail padding inside one block
    (11, 21, 259, True),    # two padded blocks + the LDRAIN1D branch
    (13, 5, 130, False),    # shallow atmosphere, one-column tail
])
def test_pallas_matches_scan_random_states(seed, nlev, ncol, ldrain1d):
    """Fuzz the Pallas NL kernel against the lax.scan kernel on fresh
    random states at odd shapes — the fixture-state parity tests all run
    the same 100x137 state, so a masking/padding bug conditioned on the
    data or on non-standard shapes could hide there."""
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=ncol, nlev=nlev, seed=seed)
    inputs = st.kernel_inputs(dtype=np.float32)
    ref = cloudsc2(inputs, st.params, ldrain1d=ldrain1d)
    out = cloudsc2_pallas(inputs, st.params, ldrain1d=ldrain1d,
                          interpret=True)
    for name, a, b in zip(out._fields, out, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape == (ncol, b.shape[1])
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 5e-6, (seed, nlev, ncol, name)


@pytest.mark.parametrize("ncol,block_cols", [
    (97, 32),    # four blocks, the last one padded
    (130, 64),   # a one-column tail block
    (33, 8),     # many small blocks
    (200, 128),  # the default block, padded
])
def test_column_blocks_match_scan(ncol, block_cols):
    """The column grid at counts that are not block multiples: every
    program runs its own level loop, padding replicates column 0 and is
    sliced off again."""
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=ncol, nlev=9, seed=ncol)
    inputs = st.kernel_inputs(dtype=np.float32)
    ref = cloudsc2(inputs, st.params)
    out = cloudsc2_pallas(inputs, st.params, block_cols=block_cols,
                          interpret=True)
    for name, a, b in zip(out._fields, out, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 5e-6, (ncol, block_cols, name)


def test_layout_pads_with_column_zero(state):
    """The padded levels-major layout: (nlev, ncol) rounded up to whole
    blocks, the padding a replica of column 0."""
    from cloudsc2jax.pallas.cloudsc2_kernel import _Layout

    inputs = state.kernel_inputs(dtype=np.float32)  # 100 columns
    lay = _Layout(inputs, state.params, 64, levels_major=False)
    assert (lay.nlev, lay.ncol, lay.nb, lay.npad) == (137, 100, 2, 28)
    pt = np.asarray(lay.arrs["pt"])
    assert pt.shape == (137, 128)
    np.testing.assert_array_equal(pt[:, :100], np.asarray(inputs.pt).T)
    np.testing.assert_array_equal(
        pt[:, 100:], np.repeat(pt[:, :1], 28, axis=1))
    assert np.asarray(lay.arrs["paph"]).shape == (138, 128)
    assert lay.ztrpaus.shape == lay.paphsfc.shape == (128,)


def test_block_cols_must_be_power_of_two(state):
    """Triton loads and stores power-of-two shapes only."""
    inputs = state.kernel_inputs(dtype=np.float32)
    with pytest.raises(ValueError, match="power of two"):
        cloudsc2_pallas(inputs, state.params, block_cols=96, interpret=True)


def test_blocked_rejects_unpadded_columns(state):
    """blocked=True promises whole blocks; a ragged column count is
    refused rather than padded behind the caller's back."""
    inputs = state.kernel_inputs(dtype=np.float32, levels_major=True)
    with pytest.raises(ValueError, match="multiple of 128"):
        cloudsc2_pallas(inputs, state.params, blocked=True, interpret=True)


def _lower_for_cuda(fn, *args):
    """StableHLO of ``fn`` lowered for the GPU — the Triton lowering of
    every kernel runs here, on the CPU, without a card."""
    import jax

    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("sweep", ["nl", "tl", "ad"])
def test_kernels_lower_through_triton(state, sweep):
    """Every kernel names the Triton route and lowers for the GPU (the
    route a pallas_call that names none takes is Mosaic GPU)."""
    from functools import partial

    from cloudsc2jax.pallas.tlad_kernel import (
        cloudsc2_pallas_ad,
        cloudsc2_pallas_tl,
    )

    inputs = state.kernel_inputs(dtype=np.float32)
    p = state.params
    fn, args, ncalls = {
        "nl": (partial(cloudsc2_pallas, params=p), (inputs,), 1),
        "tl": (partial(cloudsc2_pallas_tl, params=p, lregcl=True),
               (inputs, inputs), 1),
        # forward checkpoint sweep + reverse sweep
        "ad": (lambda i: cloudsc2_pallas_ad(
            i, cloudsc2(i, p), p, lregcl=True), (inputs,), 2),
    }[sweep]
    text = _lower_for_cuda(fn, *args)
    assert text.count("__gpu$xla.gpu.triton") == ncalls


def test_blocked_path_adds_no_relayout(state):
    """On the zero-copy path the kernel reads the generated levels-major
    arrays as they are: no transpose or concatenate is lowered around the
    call, and the only reshapes drop unit dimensions (bitcasts, such as
    the surface-pressure row ``paph[nlev]``)."""
    import re

    from functools import partial

    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=17)
    blk = st.device_kernel_inputs(256, dtype=np.float32, block_multiple=128)
    text = _lower_for_cuda(
        partial(cloudsc2_pallas, params=st.params, blocked=True,
                fuse_satur=True), blk)
    assert text.count("__gpu$xla.gpu.triton") == 1
    for op in ("stablehlo.transpose", "stablehlo.concatenate"):
        assert op not in text, op
    reshapes = re.findall(
        r"stablehlo\.reshape .*: \(tensor<([0-9x]*)x?f32>\) -> "
        r"tensor<([0-9x]*)x?f32>", text)
    for src, dst in reshapes:
        dims = [[int(d) for d in t.split("x") if d and d != "1"]
                for t in (src, dst)]
        assert dims[0] == dims[1], (src, dst)
