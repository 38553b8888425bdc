"""Distribution tests on a virtual 8-device CPU mesh.

The reference's multi-rank guarantee — results are decomposition-invariant
because columns are independent and inputs replicated (SURVEY §4.4) — is
checked across mesh shapes; sharded reductions replace MPI_REDUCE.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from cloudsc2jax import dist
from cloudsc2jax.drivers import run_nl


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return dist.column_mesh()


def _no_launcher_rank(monkeypatch):
    for var in dist.LOCAL_RANK_VARS:
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("process_id,ncards,card", [
    (0, 4, 0), (3, 4, 3), (5, 4, 1), (7, 8, 7), (2, 0, None)])
def test_local_card_is_the_rank_on_its_host(monkeypatch, process_id, ncards,
                                            card):
    """Without a launcher's local rank, the global rank modulo the cards
    on the host: rank 5 of two 4-card hosts is card 1 of the second."""
    _no_launcher_rank(monkeypatch)
    monkeypatch.setattr("cloudsc2jax.device.cards_on_host", lambda: ncards)
    assert dist.local_card(process_id) == card


@pytest.mark.parametrize("var", dist.LOCAL_RANK_VARS)
def test_local_card_takes_the_launchers_local_rank(monkeypatch, var):
    _no_launcher_rank(monkeypatch)
    monkeypatch.setattr("cloudsc2jax.device.cards_on_host", lambda: 4)
    monkeypatch.setenv(var, "2")
    assert dist.local_card(5) == 2


@pytest.mark.parametrize("ncards,ids", [(4, [1]), (0, None)])
def test_initialize_binds_one_card(monkeypatch, ncards, ids):
    """A multi-process launch binds each process to its card; a single
    process initialises nothing."""
    _no_launcher_rank(monkeypatch)
    monkeypatch.setattr("cloudsc2jax.device.cards_on_host", lambda: ncards)
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    dist.initialize("localhost:1", num_processes=1, process_id=0)
    assert calls == []
    dist.initialize("localhost:1", num_processes=8, process_id=5)
    assert calls == [dict(coordinator_address="localhost:1", num_processes=8,
                          process_id=5, local_device_ids=ids)]


def test_rank_columns_reference_split():
    # (NGPTOTG-1)/NUMPROC+1 per rank, remainder on the last
    # (dwarf_cloudsc.F90:66-69)
    s = [dist.rank_columns(1000, 3, r) for r in range(3)]
    assert [x.stop - x.start for x in s] == [334, 334, 332]
    assert s[0].start == 0 and s[2].stop == 1000


def test_sharded_matches_single_device(state, mesh):
    from cloudsc2jax.state import Cloudsc2State
    from conftest import FIXTURES

    n = dist.pad_columns(100, mesh)  # 104: equal shards per device
    padded = Cloudsc2State.load(FIXTURES / "input.h5", ngptot=n)
    inputs = padded.kernel_inputs()
    sharded = dist.shard_inputs(inputs, mesh)
    for leaf in jax.tree.leaves(sharded):
        assert len(leaf.sharding.device_set) == 8
    out = run_nl(sharded, padded.params)
    ref = run_nl(inputs, padded.params)
    # Not bitwise: XLA:CPU's vector-remainder lanes contract FMAs
    # differently on each shard's last column (observed <=1e-19 abs).
    # The reference's "bit" build type makes the same reproducibility
    # caveat for its own compilers (README.md:36).
    for a, b in zip(out, ref):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-10, atol=1e-16
        )


def test_decomposition_invariance(state, mesh):
    """Expanded 800-column run sharded over 8 devices reproduces the
    100-column results on every replica."""
    from cloudsc2jax.state import Cloudsc2State
    from conftest import FIXTURES

    big = Cloudsc2State.load(FIXTURES / "input.h5", ngptot=800)
    sharded = dist.shard_inputs(big.kernel_inputs(), mesh)
    out = run_nl(sharded, big.params)
    small_out = run_nl(state.kernel_inputs(), state.params)
    for a, b in zip(out, small_out):
        a = np.asarray(a)
        b = np.asarray(b)
        for rep in range(8):
            np.testing.assert_allclose(
                a[rep * 100 : (rep + 1) * 100], b, rtol=1e-10, atol=1e-16
            )


def test_sharded_global_reduction(mesh):
    """Validation-style reductions on sharded outputs (replaces
    MPI_REDUCE, validate_mod.F90:149-151)."""
    from cloudsc2jax.state import Cloudsc2State
    from conftest import FIXTURES

    state = Cloudsc2State.load(FIXTURES / "input.h5", ngptot=104)
    sharded = dist.shard_inputs(state.kernel_inputs(), mesh)
    out = run_nl(sharded, state.params)

    @jax.jit
    def stats(x):
        return jnp.min(x), jnp.max(x), jnp.sum(jnp.abs(x))

    mn, mx, s = stats(out.tenl_t)
    ref = np.asarray(out.tenl_t)
    assert float(mn) == ref.min() and float(mx) == ref.max()
    np.testing.assert_allclose(float(s), np.abs(ref).sum(), rtol=1e-12)


def test_pad_columns(mesh):
    assert dist.pad_columns(100, mesh) == 104
    assert dist.pad_columns(800, mesh) == 800


def test_map_columns_matches_unblocked(state):
    """NPROMA-style lax.map chunking is semantics-preserving."""
    from functools import partial

    import jax.numpy as jnp

    from cloudsc2jax.drivers import map_columns
    from cloudsc2jax.physics.cloudsc2 import cloudsc2

    inputs = state.kernel_inputs()
    f = partial(cloudsc2, params=state.params)
    ref = f(inputs)
    out = jax.jit(lambda i: map_columns(f, i, nproma=25))(inputs)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-18
        )


def test_shard_map_pallas_nl_matches_single_device(mesh):
    """The Pallas kernel SPMD-wrapped over the 8-device column mesh
    (dist.shard_map_columns) matches the single-device run: one kernel
    instance per device on its local shard, zero collectives."""
    from functools import partial

    import jax.numpy as jnp

    from cloudsc2jax.pallas.cloudsc2_kernel import cloudsc2_pallas
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=1024, nlev=23)
    inputs = st.kernel_inputs(dtype=np.float32)
    fn = partial(cloudsc2_pallas, params=st.params, interpret=True)
    sharded = dist.shard_inputs(inputs, mesh)
    out = jax.jit(dist.shard_map_columns(fn, mesh, sharded))(sharded)
    ref = fn(inputs)
    for name, a, b in zip(out._fields, out, ref):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-30)
        # f32 lane-remainder FMA differences across padding layouts
        assert np.abs(a - b).max() / scale < 5e-6, name


def test_run_tlad_xla_mesh(mesh):
    """run_tlad's XLA backend under the mesh: auto-partitioned from the
    input shardings, must run anywhere."""
    from cloudsc2jax.drivers import run_tlad
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=64, nlev=9)
    inputs = st.kernel_inputs(dtype=np.float32)
    sharded = dist.shard_inputs(inputs, mesh)
    out, dout, adj = run_tlad(sharded, st.params, lregcl=True, remat=False)
    assert np.isfinite(np.asarray(out.tenl_t)).all()
    assert np.isfinite(np.asarray(adj.pt)).all()


def test_run_tlad_pallas_mesh(mesh):
    """run_tlad(backend='pallas', mesh=...) actually RUNS the fused TL+AD
    kernel pair SPMD over the 8-device mesh (interpret mode on CPU, wired
    through run_tlad) and matches the single-device pallas run."""
    from cloudsc2jax.drivers import run_tlad
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=64, nlev=9)
    inputs = st.kernel_inputs(dtype=np.float32)
    sharded = dist.shard_inputs(inputs, mesh)
    out, dout, adj = run_tlad(
        sharded, st.params, lregcl=True, backend="pallas", mesh=mesh,
        interpret=True,
    )
    ref_out, ref_dout, ref_adj = run_tlad(
        inputs, st.params, lregcl=True, backend="pallas", interpret=True,
    )
    for group, rgroup in ((out, ref_out), (dout, ref_dout), (adj, ref_adj)):
        for name, a, b in zip(group._fields, group, rgroup):
            a, b = np.asarray(a), np.asarray(b)
            scale = max(np.abs(b).max(), 1e-30)
            assert np.abs(a - b).max() / scale < 5e-6, name


def test_shard_map_blocked_pallas(mesh):
    """Padded levels-major kernel SPMD over the column axis (axis=1)
    matches the single-device run."""
    from functools import partial

    from cloudsc2jax.pallas.cloudsc2_kernel import cloudsc2_pallas
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=17)
    # 8 blocks of 128 columns -> one block per device
    blk = st.device_kernel_inputs(1024, dtype=np.float32, block_multiple=128)
    fn = partial(cloudsc2_pallas, params=st.params, blocked=True,
                 interpret=True)
    ref = fn(blk)
    sharded = dist.shard_inputs(blk, mesh, axis=1)
    out = jax.jit(dist.shard_map_columns(fn, mesh, sharded, axis=1))(sharded)
    for name, a, b in zip(out._fields, out, ref):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() / scale < 5e-6, name


def test_map_columns_pads_partial_block(state):
    """A partial final NPROMA block is padded with replicas and sliced
    back (≙ the reference's ICEND partial block)."""
    from functools import partial

    from cloudsc2jax.drivers import map_columns
    from cloudsc2jax.physics.cloudsc2 import cloudsc2

    inputs = state.kernel_inputs()
    f = partial(cloudsc2, params=state.params)
    ref = f(inputs)
    out = jax.jit(lambda i: map_columns(f, i, nproma=33))(inputs)  # 100 % 33 != 0
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-12, atol=1e-18)


def test_device_inputs_col_offset_matches_global_slice():
    """Per-host shard materialisation: device_kernel_inputs(col_offset=o)
    must equal columns [o, o+n) of the full cyclic expansion."""
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=9)
    full = st.device_kernel_inputs(300, dtype=np.float32)
    shard = st.device_kernel_inputs(120, dtype=np.float32, col_offset=130)
    for name, a, b in zip(full._fields, shard, full):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)[130:250], err_msg=name
        )


def test_load_col_slice_is_cyclic_shard(tmp_path):
    """state.load(col_slice=...) materialises only the shard, with the
    cyclic-expansion values of the global column range."""
    import pathlib

    from cloudsc2jax.state import Cloudsc2State

    fixtures = pathlib.Path(__file__).parent / "fixtures"
    full = Cloudsc2State.load(fixtures / "input.h5", ngptot=250)
    shard = Cloudsc2State.load(
        fixtures / "input.h5", ngptot=250, col_slice=slice(90, 180)
    )
    for k, v in shard.fields.items():
        np.testing.assert_array_equal(v, full.fields[k][90:180], err_msg=k)


def test_run_chunked_matches_single_shot(state):
    """Streaming execution over device-generated chunks equals one-shot
    execution of the same global column range (cyclic offsets)."""
    from cloudsc2jax.drivers import run_chunked
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=13)
    n1, s1 = run_chunked(st, 512, variant="nl", chunk=256,
                         interpret=True)
    n2, s2 = run_chunked(st, 512, variant="nl", chunk=512,
                         interpret=True)
    assert n1 == n2 == 512
    np.testing.assert_allclose(s1, s2, rtol=1e-5)


def test_run_chunked_mesh_invariant(mesh):
    """The >HBM streaming pipeline sharded over the 8-device mesh: each
    device generates + runs its own blocks (per-rank hyperslab semantics
    on-device), psum checksum. The same global column range must give the
    same checksum for ANY (chunk, mesh) decomposition."""
    from cloudsc2jax.drivers import run_chunked
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=13)
    n0, s0 = run_chunked(st, 2048, variant="nl", chunk=2048,
                         interpret=True)
    # one mesh chunk vs TWO mesh chunks: chunks are rounded to whole
    # per-device multiples (gc = BLOCK_COLS*ndev = 1024 here), so chunk=1024 is
    # a real two-chunk decomposition whose second step advances every
    # device's global block offset — the arithmetic a single-chunk run
    # never exercises (a sub-gc chunk would silently round UP to gc and
    # test nothing new)
    n1, s1 = run_chunked(st, 2048, variant="nl", chunk=2048,
                         interpret=True, mesh=mesh)
    n2, s2 = run_chunked(st, 2048, variant="nl", chunk=1024,
                         interpret=True, mesh=mesh)
    assert n0 == n1 == n2 == 2048
    np.testing.assert_allclose(s1, s0, rtol=1e-5)
    np.testing.assert_allclose(s2, s0, rtol=1e-5)


def test_run_chunked_tlad_mesh_invariant(mesh):
    """The fused TL+AD work unit streamed across the mesh matches the
    single-device streamed checksum (1024 columns, two decompositions)."""
    from cloudsc2jax.drivers import run_chunked
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=9)
    n0, s0 = run_chunked(st, 1024, variant="tlad", chunk=1024,
                         interpret=True)
    n1, s1 = run_chunked(st, 1024, variant="tlad", chunk=1024,
                         interpret=True, mesh=mesh)
    assert n0 == n1 == 1024
    np.testing.assert_allclose(s1, s0, rtol=1e-4)


def test_run_chunked_tlad_matches_single_shot():
    """The fused TL+AD work unit streamed over device-generated chunks
    (interpret mode now wired through run_tlad's pallas backends)."""
    from cloudsc2jax.drivers import run_chunked
    from cloudsc2jax.state import Cloudsc2State

    st = Cloudsc2State.synthetic(ngptot=100, nlev=9)
    n1, s1 = run_chunked(st, 512, variant="tlad", chunk=256,
                         interpret=True)
    n2, s2 = run_chunked(st, 512, variant="tlad", chunk=512,
                         interpret=True)
    assert n1 == n2 == 512
    np.testing.assert_allclose(s1, s2, rtol=1e-4)
