"""Fused Pallas TL/AD kernels vs jax.jvp/jax.vjp of the pure-JAX kernel
(interpret mode on CPU, f32).

The kernels (tlad_kernel.py) re-schedule the identical differentiated
math: the TL kernel fuses trajectory+tangent per level step
(≙ cloudsc2tl.F90's dual statements), the AD pair runs a forward
carry-checkpoint sweep plus a downward transpose sweep
(≙ cloudsc2ad.F90:366-866 forward store / :934-1668 reverse loop).
These tests pin both to the autodiff of the lax.scan kernel and check
the adjoint identity end-to-end through the kernels themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cloudsc2jax.pallas.tlad_kernel import cloudsc2_pallas_ad, cloudsc2_pallas_tl
from cloudsc2jax.tlad import cloudsc2_ad, cloudsc2_tl


@pytest.fixture(scope="module")
def f32_inputs(state):
    return state.kernel_inputs(dtype=np.float32)


@pytest.fixture(scope="module")
def f32_increments(f32_inputs):
    return jax.tree.map(lambda x: 0.01 * jnp.asarray(x), f32_inputs)


def _assert_tree_close(got, want, rtol, what):
    for name, a, b in zip(want._fields, got, want):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < rtol, (what, name)


@pytest.mark.parametrize("lregcl", [False, True])
def test_tl_kernel_matches_jvp(state, f32_inputs, f32_increments, lregcl):
    out_ref, dout_ref = cloudsc2_tl(
        f32_inputs, f32_increments, state.params, lregcl=lregcl
    )
    out, dout = cloudsc2_pallas_tl(
        f32_inputs, f32_increments, state.params,
        lregcl=lregcl, interpret=True,
    )
    _assert_tree_close(out, out_ref, 5e-6, "primal")
    _assert_tree_close(dout, dout_ref, 5e-5, "tangent")


@pytest.mark.parametrize("lregcl", [False, True])
def test_ad_kernel_matches_vjp(state, f32_inputs, f32_increments, lregcl):
    # seed with the TL image of the canonical increments, like the AD
    # driver (cloudsc_driver_ad_mod.F90:160-237)
    _, dout = cloudsc2_tl(f32_inputs, f32_increments, state.params, lregcl=lregcl)
    out_ref, adj_ref = cloudsc2_ad(
        f32_inputs, dout, state.params, lregcl=lregcl
    )
    out, adj = cloudsc2_pallas_ad(
        f32_inputs, dout, state.params, lregcl=lregcl,
        interpret=True,
    )
    _assert_tree_close(out, out_ref, 5e-6, "primal")
    for name, a, b in zip(adj_ref._fields, adj, adj_ref):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 1e-4, name


def test_adjoint_identity_through_kernels(state, f32_inputs, f32_increments):
    """⟨Mδx, Mδx⟩ = ⟨δx, MᵀMδx⟩ with M = the Pallas TL kernel and Mᵀ = the
    Pallas AD kernel — the dot-product test of
    cloudsc_driver_ad_mod.F90:184-264 run through the fused kernels."""
    di = f32_increments._replace(
        psupsat=jnp.zeros_like(f32_increments.psupsat)
    )
    _, dout = cloudsc2_pallas_tl(
        f32_inputs, di, state.params, lregcl=True, interpret=True
    )
    _, adj = cloudsc2_pallas_ad(
        f32_inputs, dout, state.params, lregcl=True,
        interpret=True,
    )
    norm1 = sum(float(jnp.sum(jnp.asarray(y, jnp.float64) ** 2)) for y in dout)
    norm2 = sum(
        float(jnp.sum(jnp.asarray(a, jnp.float64) * jnp.asarray(b, jnp.float64)))
        for a, b in zip(di, adj)
    )
    assert norm1 != 0.0
    # kernels run in f32; the identity holds to f32 rounding of the dot
    # products (the f64 10⁴ε criterion applies to the f64 path, tlad.py)
    assert abs(norm1 - norm2) / abs(norm2) < 1e-4


def test_tl_kernel_levels_major(state, f32_inputs, f32_increments):
    ref_out, ref_dout = cloudsc2_pallas_tl(
        f32_inputs, f32_increments, state.params, interpret=True
    )
    lm_in = type(f32_inputs)(*(np.ascontiguousarray(np.asarray(x).T) for x in f32_inputs))
    lm_di = type(f32_inputs)(*(np.ascontiguousarray(np.asarray(x).T) for x in f32_increments))
    lm_out, lm_dout = cloudsc2_pallas_tl(
        lm_in, lm_di, state.params, interpret=True,
        levels_major=True,
    )
    for a, b in zip(lm_dout, ref_dout):
        np.testing.assert_array_equal(np.asarray(a).T, np.asarray(b))


def test_blocked_tlad_matches_standard(state):
    """Blocked-layout TL and AD kernels (zero-relayout path) match the
    standard-layout kernels, including the 10-field flux-seed fold."""
    from cloudsc2jax.pallas.cloudsc2_kernel import unblock_outputs
    from cloudsc2jax.pallas.tlad_kernel import fold_flux_seeds
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=23)
    params = st.params
    ncol = 256
    std = st.device_kernel_inputs(ncol, dtype=np.float32)
    blk = st.device_kernel_inputs(ncol, dtype=np.float32, block_multiple=128)
    d_std = jax.tree.map(lambda x: 0.01 * x, std)
    d_blk = jax.tree.map(lambda x: 0.01 * x, blk)

    out_s, dout_s = cloudsc2_pallas_tl(
        std, d_std, params, lregcl=True, interpret=True
    )
    out_b, dout_b = cloudsc2_pallas_tl(
        blk, d_blk, params, lregcl=True, blocked=True, interpret=True
    )
    dout_bu = unblock_outputs(dout_b, params, ncol)
    _assert_tree_close(dout_bu, dout_s, 1e-5, "blocked TL tangent")

    _, adj_s = cloudsc2_pallas_ad(
        std, dout_s, params, lregcl=True, interpret=True
    )
    _, adj_b = cloudsc2_pallas_ad(
        blk, fold_flux_seeds(dout_b, params), params, lregcl=True,
        blocked=True, interpret=True,
    )
    for name, a, b in zip(adj_s._fields, adj_b, adj_s):
        a = np.asarray(a)
        a = a.reshape(a.shape[0], -1)[:, :ncol].T
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 1e-4, name


def test_checkpoint_reuse_adjoint_matches(state):
    """The reverse-only adjoint fed with the TL kernel's carry
    checkpoints equals the adjoint that runs its own forward sweep."""
    from cloudsc2jax.pallas.tlad_kernel import fold_flux_seeds
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=23)
    params = st.params
    blk = st.device_kernel_inputs(256, dtype=np.float32, block_multiple=128)
    di = jax.tree.map(lambda x: 0.01 * x, blk)

    out, dout, ckpts = cloudsc2_pallas_tl(
        blk, di, params, lregcl=True, blocked=True, save_checkpoints=True,
        interpret=True,
    )
    seeds = fold_flux_seeds(dout, params)
    _, adj_fast = cloudsc2_pallas_ad(
        blk, seeds, params, lregcl=True, blocked=True, checkpoints=ckpts,
        interpret=True,
    )
    _, adj_ref = cloudsc2_pallas_ad(
        blk, seeds, params, lregcl=True, blocked=True, interpret=True
    )
    for name, a, b in zip(adj_ref._fields, adj_fast, adj_ref):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 1e-5, name


def test_write_primal_false_matches(state):
    """Dropping the 8 primal output streams (the adjoint work unit never
    needs them — cloudsc_driver_ad_mod.F90:160-256 uses only δy and x̄)
    leaves tangents, checkpoints and the adjoint bit-identical."""
    from cloudsc2jax.drivers import DSCALE
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=23)
    params = st.params
    blk = st.device_kernel_inputs(256, dtype=np.float32, block_multiple=128)

    out_w, dout_w, ck_w = cloudsc2_pallas_tl(
        blk, None, params, lregcl=True, blocked=True, save_checkpoints=True,
        dscale=DSCALE, interpret=True,
    )
    out_n, dout_n, ck_n = cloudsc2_pallas_tl(
        blk, None, params, lregcl=True, blocked=True, save_checkpoints=True,
        dscale=DSCALE, write_primal=False, interpret=True,
    )
    assert out_n is None
    for name, a, b in zip(dout_w._fields, dout_n, dout_w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    for a, b in zip(ck_n, ck_w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    _, adj_w = cloudsc2_pallas_ad(
        blk, dout_w, params, lregcl=True, blocked=True, checkpoints=ck_w,
        fold_seeds=True, interpret=True,
    )
    _, adj_n = cloudsc2_pallas_ad(
        blk, dout_n, params, lregcl=True, blocked=True, checkpoints=ck_n,
        fold_seeds=True, interpret=True,
    )
    for name, a, b in zip(adj_w._fields, adj_n, adj_w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


def test_fold_seeds_in_kernel_matches_external(state):
    """The production work unit's in-kernel flux-seed fold
    (``fold_seeds=True``, drivers._tlad_step) equals the external
    ``fold_flux_seeds`` pass — pins the seeds[:6]/rfln/sfln split and the
    (1+L²) scales inside ``_rev_kernel``."""
    from cloudsc2jax.pallas.tlad_kernel import fold_flux_seeds
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=23)
    params = st.params
    blk = st.device_kernel_inputs(256, dtype=np.float32, block_multiple=128)
    di = jax.tree.map(lambda x: 0.01 * x, blk)

    _, dout = cloudsc2_pallas_tl(
        blk, di, params, lregcl=True, blocked=True, interpret=True
    )
    _, adj_ext = cloudsc2_pallas_ad(
        blk, fold_flux_seeds(dout, params), params, lregcl=True,
        blocked=True, interpret=True,
    )
    _, adj_ink = cloudsc2_pallas_ad(
        blk, dout, params, lregcl=True, blocked=True, fold_seeds=True,
        interpret=True,
    )
    # not bit-identical: the in-kernel fold fuses the (1+L²) multiply
    # into the reverse sweep's f32 arithmetic (different rounding order)
    for name, a, b in zip(adj_ext._fields, adj_ink, adj_ext):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 1e-5, name


@pytest.mark.parametrize("lregcl", [False, True])
def test_tlad_kernels_ldrain1d(state, f32_inputs, f32_increments, lregcl):
    """TL/AD kernels through the LDRAIN1D clear-sky evaporation branch
    (cloudsc2.F90:556-591 active): parity with jax.jvp/vjp including the
    safe-where guards in reverse mode."""
    out_ref, dout_ref = cloudsc2_tl(
        f32_inputs, f32_increments, state.params, lregcl=lregcl,
        ldrain1d=True,
    )
    out, dout = cloudsc2_pallas_tl(
        f32_inputs, f32_increments, state.params, lregcl=lregcl,
        ldrain1d=True, interpret=True,
    )
    _assert_tree_close(out, out_ref, 5e-6, "primal")
    _assert_tree_close(dout, dout_ref, 5e-5, "tangent")

    _, adj_ref = cloudsc2_ad(
        f32_inputs, dout_ref, state.params, lregcl=lregcl, ldrain1d=True
    )
    _, adj = cloudsc2_pallas_ad(
        f32_inputs, dout_ref, state.params, lregcl=lregcl, ldrain1d=True,
        interpret=True,
    )
    for name, a, b in zip(adj_ref._fields, adj, adj_ref):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all(), name
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 2e-4, name


def test_dscale_matches_explicit_increments(state):
    """In-register canonical increments (dscale) must equal explicitly
    streamed d_inputs = dscale*x, and the primal must be unaffected."""
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=23)
    params = st.params
    blk = st.device_kernel_inputs(256, dtype=np.float32, block_multiple=128)
    di = jax.tree.map(lambda x: np.float32(0.01) * x, blk)
    out_a, dout_a = cloudsc2_pallas_tl(
        blk, di, params, lregcl=True, blocked=True, interpret=True
    )
    out_b, dout_b, _ = cloudsc2_pallas_tl(
        blk, None, params, lregcl=True, blocked=True, save_checkpoints=True,
        dscale=0.01, interpret=True,
    )
    _assert_tree_close(dout_b, dout_a, 1e-5, "dscale tangent")
    for name, a, b in zip(out_a._fields, out_b, out_a):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)

    with pytest.raises(ValueError):
        cloudsc2_pallas_tl(blk, di, params, blocked=True, dscale=0.01,
                           interpret=True)


def test_run_tlad_rejects_unhonorable_write_primal(state):
    """run_tlad must refuse write_primal=False on backends that cannot
    shed the primal streams (only the blocked Pallas kernels can) —
    silently returning full primals under the noprim flag would let a
    caller time/compare a different work unit."""
    from cloudsc2jax.drivers import run_tlad

    inputs = state.kernel_inputs(dtype=np.float32)
    for backend in ("xla", "pallas"):
        with pytest.raises(ValueError, match="write_primal"):
            run_tlad(inputs, state.params, backend=backend,
                     write_primal=False, interpret=True)


@pytest.mark.parametrize("seed,nlev,ncol", [(7, 11, 97), (13, 19, 141)])
def test_tlad_kernels_match_autodiff_random_states(seed, nlev, ncol):
    """Fuzz the fused TL and reverse-AD kernels against jax.jvp/vjp of
    the scan kernel on fresh random states at odd shapes (the fixed
    fixture/synthetic shapes of the parity tests above could hide a
    data- or padding-conditioned masking bug in the derivative paths)."""
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=ncol, nlev=nlev, seed=seed)
    inputs = st.kernel_inputs(dtype=np.float32)
    di = jax.tree.map(lambda x: 0.01 * jnp.asarray(x), inputs)

    out_ref, dout_ref = cloudsc2_tl(inputs, di, st.params, lregcl=True)
    out, dout = cloudsc2_pallas_tl(
        inputs, di, st.params, lregcl=True, interpret=True
    )
    _assert_tree_close(out, out_ref, 5e-6, ("primal", seed))
    _assert_tree_close(dout, dout_ref, 5e-5, ("tangent", seed))

    _, adj_ref = cloudsc2_ad(inputs, dout_ref, st.params, lregcl=True)
    _, adj = cloudsc2_pallas_ad(
        inputs, dout_ref, st.params, lregcl=True, interpret=True
    )
    for name, a, b in zip(adj_ref._fields, adj, adj_ref):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 1e-4, (seed, name)


@pytest.mark.parametrize("ncol,block_cols", [(97, 32), (64, 64)])
def test_reverse_kernel_shift_rows_match_vjp(ncol, block_cols):
    """The reverse kernel writes the adjoints of the shifted reads in
    place: d_plu[k+1] from the plu(k+1) read, d_paph[k+1] = hi(k) +
    lo(k+1) with lo carried one level, row 0 of both, and the surface row
    d_paph[nlev] that also collects every level's surface-pressure read.
    Each row against jax.vjp of the scan, over several column blocks."""
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=ncol, nlev=11, seed=ncol)
    inputs = st.kernel_inputs(dtype=np.float32)
    di = jax.tree.map(lambda x: 0.01 * jnp.asarray(x), inputs)
    _, seeds = cloudsc2_tl(inputs, di, st.params, lregcl=True)
    _, adj_ref = cloudsc2_ad(inputs, seeds, st.params, lregcl=True)
    _, adj = cloudsc2_pallas_ad(inputs, seeds, st.params, lregcl=True,
                                block_cols=block_cols, interpret=True)
    plu, plu_ref = np.asarray(adj.plu), np.asarray(adj_ref.plu)
    paph, paph_ref = np.asarray(adj.paph), np.asarray(adj_ref.paph)
    assert paph.shape == paph_ref.shape == (ncol, 12)
    np.testing.assert_array_equal(plu[:, 0], 0.0)  # never read as k+1
    for name, a, b in (("plu", plu, plu_ref),
                       ("paph rows 0..nlev-1", paph[:, :-1], paph_ref[:, :-1]),
                       ("paph surface row", paph[:, -1:], paph_ref[:, -1:])):
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 1e-4, name


@pytest.mark.parametrize("ncol,block_cols", [(45, 16), (130, 64)])
def test_tl_kernel_column_blocks_match_jvp(ncol, block_cols):
    """The TL kernel over several column blocks with a padded tail."""
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=ncol, nlev=9, seed=ncol)
    inputs = st.kernel_inputs(dtype=np.float32)
    di = jax.tree.map(lambda x: 0.01 * jnp.asarray(x), inputs)
    out_ref, dout_ref = cloudsc2_tl(inputs, di, st.params, lregcl=True)
    out, dout = cloudsc2_pallas_tl(inputs, di, st.params, lregcl=True,
                                   block_cols=block_cols, interpret=True)
    _assert_tree_close(out, out_ref, 5e-6, "primal")
    _assert_tree_close(dout, dout_ref, 5e-5, "tangent")
