"""Distributed execution over device meshes.

Replaces the reference's MPI layer (``src/common/module/cloudsc_mpi_mod.F90``
— init/finalize, reduce sum/min/max, gather; used for domain decomposition
over grid points, validation reductions and perf gathering) with JAX's
SPMD stack:

* **domain decomposition** — a 1-D ``jax.sharding.Mesh`` over all devices
  with the column axis of every field sharded (``NamedSharding``); the
  per-rank NGPTOT split of dwarf_cloudsc.F90:66-69 becomes an XLA data
  layout.  The physics is embarrassingly parallel across columns (zero
  halo — SURVEY §3.4), so no kernel-side communication is ever emitted.
* **reductions** — ``jnp.sum``/``jnp.max`` over sharded arrays inside
  ``jit``; XLA inserts the all-reduce (NCCL over NVLink between the cards
  of a host; this replaces cloudsc_mpi_mod.F90:102-243).
* **gather** — ``jax.experimental.multihost_utils`` /
  ``process_allgather`` for host-side perf tables
  (replaces :264-322).
* **per-host loading** — each host materialises only its shard of the
  expanded input (the analogue of the rank-strided hyperslab reads,
  expand_mod.F90:30-46); :func:`shard_state` places host-local numpy
  blocks directly onto local devices with
  ``jax.make_array_from_process_local_data``.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "initialize",
    "local_card",
    "column_mesh",
    "column_sharding",
    "pad_columns",
    "shard_inputs",
    "shard_map_columns",
    "rank_columns",
    "local_column_slice",
]

COLS_AXIS = "columns"


# launcher variables that hold a process's rank on its own host
# (mpirun, srun, torchrun-style launchers)
LOCAL_RANK_VARS = ("OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_LOCALID", "LOCAL_RANK")


def local_card(process_id: int) -> Optional[int]:
    """The card a process of a multi-process launch binds to: its rank on
    its own host.  That is the launcher's local rank where one is set,
    else the global rank modulo the cards on this host (one process per
    card, ranks numbered host by host).  None on a host with no card."""
    for var in LOCAL_RANK_VARS:
        if os.environ.get(var):
            return int(os.environ[var])
    from .device import cards_on_host

    n = cards_on_host()
    return process_id % n if n else None


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Multi-process runtime init (replaces CLOUDSC_MPI_INIT,
    cloudsc_mpi_mod.F90:58-88).  No-op in single-process runs; otherwise
    call once before any jax op.

    Each process is bound to one card, :func:`local_card` — one process
    per card, as one process per MPI rank upstream.  Unbound, every
    process would open every card of its host, and a JAX process
    reserves most of a card's memory when it opens it."""
    if num_processes is not None and num_processes > 1:
        card = local_card(process_id)
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=None if card is None else [card],
        )


def column_mesh(devices=None) -> Mesh:
    """1-D mesh over all devices; the only parallel axis this workload
    needs (SURVEY §2.4: no tensor/pipeline/expert parallelism applies —
    the vertical is a per-column serial recurrence)."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (COLS_AXIS,))


def column_sharding(mesh: Mesh, ndim: int = 2, axis: int = 0) -> NamedSharding:
    """Shard the column axis (default axis 0), replicate the rest.

    ``axis=1`` is the blocked kernel layout ``(nlev, nb, S, 128)``, whose
    shardable column dimension is the block axis ``nb``."""
    spec = [None] * ndim
    spec[axis] = COLS_AXIS
    return NamedSharding(mesh, P(*spec))


def rank_columns(ngptot: int, nranks: int, rank: int) -> slice:
    """The reference's per-rank split: NGPTOT = (NGPTOTG-1)/NUMPROC+1 per
    rank, remainder on the last (dwarf_cloudsc.F90:66-69)."""
    per = (ngptot - 1) // nranks + 1
    start = rank * per
    stop = min(start + per, ngptot)
    return slice(start, stop)


def local_column_slice(ngptot: int) -> slice:
    """Columns this host should materialise (per-host hyperslab read)."""
    return rank_columns(ngptot, jax.process_count(), jax.process_index())


def pad_columns(ngptot: int, mesh: Mesh) -> int:
    """Round the column count up to a multiple of the mesh size so every
    device gets an equal shard (inputs are cyclically expanded, so padding
    columns are just more replicas — results stay decomposition-invariant)."""
    n = mesh.devices.size
    return math.ceil(ngptot / n) * n


def shard_inputs(pytree, mesh: Mesh, axis: int = 0):
    """Place a pytree of column-batched arrays on the mesh, column-sharded
    along ``axis`` (0 for the (ncol, ...) contract, 1 for the blocked
    kernel layout).

    Single-process: a device_put with a NamedSharding. Multi-host: each
    process passes its host-local block (from :func:`local_column_slice`)
    and the global array is assembled without data movement.
    """

    def place(x):
        sh = column_sharding(mesh, np.ndim(x), axis=axis)
        if jax.process_count() == 1:
            # device arrays re-shard in place; no host round-trip
            return jax.device_put(x, sh)
        # multi-host: x is this process's LOCAL block (callers build it
        # with local_column_slice / device_kernel_inputs(col_offset=...));
        # device arrays pass through without a host round-trip
        local = x if isinstance(x, jax.Array) else np.asarray(x)
        return jax.make_array_from_process_local_data(sh, local)

    return jax.tree.map(place, pytree)


def shard_map_columns(fn, mesh: Mesh, example, axis: int = 0):
    """SPMD-wrap a column-wise kernel over the mesh's column axis.

    The XLA (lax.scan) kernel path is auto-partitioned by jit from the
    input shardings, but a ``pallas_call`` is a single-device program —
    ``shard_map`` runs one instance per device on its local column shard
    (embarrassingly parallel, zero collectives: SURVEY §3.4 — the physics
    never communicates across columns).  ``example`` is an input pytree
    (or ShapeDtypeStructs) used to derive the per-leaf specs; ``axis=1``
    for the blocked kernel layout (shard the nb block axis).
    """

    def spec(x):
        s = [None] * np.ndim(x)
        s[axis] = COLS_AXIS
        return P(*s)

    in_specs = (jax.tree.map(spec, example),)
    out_specs = jax.tree.map(spec, jax.eval_shape(fn, example))
    # check_vma=False: pallas_call out_shapes carry no varying-mesh-axis
    # info; the kernel is per-column so every output varies with COLS_AXIS
    return jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
