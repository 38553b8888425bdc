"""Array state: load, run, validate, write-reference.

Re-design of ``src/common/module/cloudsc2_array_state_mod.F90``: the
NPROMA-blocked AOSOA buffers (:26-151) become a flat pytree of
``(ncol, …, nlev)`` arrays; LOAD (:153-203) reads + column-expands the
input file; VALIDATE (:205-258) compares the 10 output fields against a
golden file with the reference's statistics; WRITE_REFERENCE (:260-287)
writes a new golden file from the first ``klon_file`` columns.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from . import io as cio
from . import validate as cval
from .constants import NCLDQI, NCLDQL, NCLV, Params
from .physics.cloudsc2 import Cloudsc2Inputs, Cloudsc2Outputs
from .physics.satur import satur

__all__ = ["Cloudsc2State", "blockify_columns"]


def blockify_columns(base, ncol: int, klon: int, off):
    """Cyclic-expand ``klon`` stored columns straight into the padded
    levels-major kernel layout ``(nlev[,+1], ncol)`` starting at global
    column ``off``: the generation pass IS the relayout, so the kernels
    see zero extra copies.  ``off`` may be traced — callers that stream
    chunks at varying offsets (e.g. ``drivers.run_chunked``, whose
    ``_CHUNK_CACHE`` holds the jitted step) reuse one executable across
    offsets.  Call inside ``jax.jit`` with ``ncol``/``klon`` static."""
    import jax.numpy as jnp

    idx = (off + jnp.arange(ncol)) % klon
    return Cloudsc2Inputs(*(x.T[:, idx] for x in base))


def _tile_columns(tree, ngptot: int, col_offset: int = 0):
    """Cyclic column expansion on device (EXPAND_R2/R3 semantics,
    expand_mod.F90:270-335): tile + truncate along the leading axis.
    ``col_offset`` starts the cycle at that global column (per-host
    shard materialisation)."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    @partial(jax.jit, static_argnums=(1,))
    def tile(x, n, off):
        idx = (off + jnp.arange(n)) % x.shape[0]
        return x[idx]

    off = jnp.asarray(col_offset, jnp.int32)
    return jax.tree.map(lambda x: tile(x, ngptot, off), tree)


@dataclasses.dataclass
class Cloudsc2State:
    """All model fields in framework order ``(ncol, [nclv,] nlev)``."""

    fields: Dict[str, np.ndarray]
    params: Params
    ngptot: int
    klon_file: int  # columns stored in the source file (100 upstream)

    # ------------------------------------------------------------------ load
    @classmethod
    def load(
        cls,
        path,
        ngptot: Optional[int] = None,
        *,
        col_slice: Optional[slice] = None,
    ) -> "Cloudsc2State":
        """LOAD + expand (cloudsc2_array_state_mod.F90:153-203).

        ``col_slice`` implements the per-rank hyperslab read of
        expand_mod.F90:30-46: a host materialises only its shard of the
        expanded column range — the stored columns are loaded and the
        shard is built by cyclic indexing, never the full NGPTOT array.
        """
        with cio.open_store(path) as f:
            klon_file = int(f["KLON"][0])
        if col_slice is not None:
            fields, params = cio.load_input_h5(path)
            idx = np.arange(col_slice.start, col_slice.stop) % klon_file
            fields = {k: v[idx] for k, v in fields.items()}
            return cls(fields=fields, params=params,
                       ngptot=ngptot or klon_file, klon_file=klon_file)
        fields, params = cio.load_input_h5(path, ngptot=ngptot)
        ngptot = ngptot or klon_file
        return cls(fields=fields, params=params, ngptot=ngptot, klon_file=klon_file)

    @classmethod
    def synthetic(cls, ngptot: int = 100, nlev: int = 137, seed: int = 2026) -> "Cloudsc2State":
        raw, params = cio.synthetic_state(nlon=min(ngptot, 100), nlev=nlev, seed=seed)
        fields = cio.expand_columns(raw, ngptot, columns_first=True)
        return cls(fields=fields, params=params, ngptot=ngptot, klon_file=min(ngptot, 100))

    # ------------------------------------------------------------- kernel IO
    def qsat(self, dtype=None):
        f = self._cast(dtype)
        return self._jit_satur(f["PAP"], f["PT"])

    @property
    def _jit_satur(self):
        """SATUR under one jit: eager execution would dispatch ~40
        separate ops, each with its own launch and host round trip."""
        fn = getattr(self, "_jit_satur_cache", None)
        if fn is None:
            import jax
            from functools import partial

            fn = jax.jit(
                partial(satur, params=self.params, lphylin=True, kflag=2)
            )
            object.__setattr__(self, "_jit_satur_cache", fn)
        return fn

    def _cast(self, dtype):
        if dtype is None:
            return self.fields
        return {k: np.asarray(v, dtype) for k, v in self.fields.items()}

    def kernel_inputs(
        self, pqs=None, dtype=None, levels_major: bool = False
    ) -> Cloudsc2Inputs:
        """Assemble the 16 differentiated kernel inputs; PQS defaults to
        SATUR of the state (cloudsc_driver_mod.F90:91-92).

        ``levels_major=True`` returns fields shaped ``(nlev, ncol)`` (the
        HDF5 storage order) for the zero-transpose Pallas fast path.
        """
        inp = self._kernel_inputs_cm(pqs, dtype)
        if levels_major:
            inp = Cloudsc2Inputs(
                *(np.ascontiguousarray(np.asarray(x).T) for x in inp)
            )
        return inp

    def _kernel_inputs_cm(self, pqs=None, dtype=None) -> Cloudsc2Inputs:
        f = self._cast(dtype)
        if pqs is None:
            pqs = self._jit_satur(f["PAP"], f["PT"])
        return Cloudsc2Inputs(
            paph=f["PAPH"],
            pap=f["PAP"],
            pq=f["PQ"],
            pqs=pqs,
            pt=f["PT"],
            pl=f["PCLV"][:, NCLDQL],
            pi=f["PCLV"][:, NCLDQI],
            plude=f["PLUDE"],
            plu=f["PLU"],
            pmfu=f["PMFU"],
            pmfd=f["PMFD"],
            ten_t=f["TENDENCY_CML_T"],
            ten_q=f["TENDENCY_CML_Q"],
            ten_l=f["TENDENCY_CML_CLD"][:, NCLDQL],
            ten_i=f["TENDENCY_CML_CLD"][:, NCLDQI],
            psupsat=f["PSUPSAT"],
        )

    def device_kernel_inputs(
        self, ngptot: Optional[int] = None, dtype=None,
        levels_major: bool = False, block_multiple: Optional[int] = None,
        col_offset: int = 0,
    ) -> Cloudsc2Inputs:
        """Kernel inputs expanded to ``ngptot`` columns ON DEVICE.

        The host-side expansion (``io.expand_columns`` ≙ expand_mod.F90)
        materialises GB-scale arrays and ships them over the host↔device
        link.  Here only the ``klon_file`` stored columns are transferred
        (~1 MB) and XLA tiles them cyclically on the accelerator —
        identical values, accelerator-speed expansion.

        ``block_multiple=M`` generates straight into the padded
        levels-major kernel layout ``(nlev[,+1], ncol)`` with ``ncol``
        rounded up to a multiple of M (padding columns are further
        replicas), for the kernels' ``blocked=True`` path — the
        generation pass IS the relayout, so the kernels see zero extra
        copies.

        ``col_offset`` shifts the cyclic expansion: a multi-host process
        materialising its shard of the global column range [o, o+n)
        passes ``col_offset=o`` so column i holds global column o+i
        (the per-rank hyperslab semantics of expand_mod.F90:30-46).
        """
        import jax

        ngptot = ngptot or self.ngptot
        base = Cloudsc2Inputs(
            *(np.asarray(x)[: self.klon_file]
              for x in self._kernel_inputs_cm(dtype=dtype))
        )
        if block_multiple is not None:
            import jax.numpy as jnp

            ncol = -(-ngptot // block_multiple) * block_multiple
            return jax.jit(blockify_columns, static_argnums=(1, 2))(
                jax.device_put(base), ncol, self.klon_file,
                jnp.int32(col_offset)
            )
        tiled = _tile_columns(jax.device_put(base), ngptot,
                              col_offset=col_offset)
        if levels_major:
            tiled = Cloudsc2Inputs(*(x.T for x in tiled))
        return tiled

    def output_dict(self, out: Cloudsc2Outputs) -> Dict[str, np.ndarray]:
        """Map kernel outputs to the golden-file field names.

        TENDENCY_LOC_A and the rain/snow/vapour species of
        TENDENCY_LOC_CLD are never written by the NL kernel and validate
        as zero (SURVEY Appendix A); PLUDE is IN-only for CLOUDSC2 and
        passes through from the input state.
        """
        ncol, nlev = np.shape(out.pclc)
        cld = np.zeros((ncol, NCLV, nlev))
        cld[:, NCLDQL] = np.asarray(out.tenl_l, np.float64)
        cld[:, NCLDQI] = np.asarray(out.tenl_i, np.float64)
        return {
            "PLUDE": np.asarray(self.fields["PLUDE"], np.float64),
            "PCOVPTOT": np.asarray(out.pcovptot, np.float64),
            "PFPLSL": np.asarray(out.pfplsl, np.float64),
            "PFPLSN": np.asarray(out.pfplsn, np.float64),
            "PFHPSL": np.asarray(out.pfhpsl, np.float64),
            "PFHPSN": np.asarray(out.pfhpsn, np.float64),
            "TENDENCY_LOC_A": np.zeros((ncol, nlev)),
            "TENDENCY_LOC_T": np.asarray(out.tenl_t, np.float64),
            "TENDENCY_LOC_Q": np.asarray(out.tenl_q, np.float64),
            "TENDENCY_LOC_CLD": cld,
        }

    # -------------------------------------------------------------- validate
    def validate(
        self, out: Cloudsc2Outputs, reference_path, threshold: float = 10.0, quiet=False
    ) -> bool:
        """VALIDATE against a golden file (…array_state_mod.F90:205-258).

        The reference stores ``klon_file`` columns; results are compared
        over all ``ngptot`` columns against the cyclically-expanded golden
        fields, which is exact because expansion replicates inputs.
        """
        ref = cio.load_reference_h5(reference_path, ngptot=self.ngptot)
        res = self.output_dict(out)
        errors = cval.validate(res, ref, ngptot=self.ngptot)
        if quiet:
            return all(e.passed(threshold) for e in errors.values())
        return cval.print_validation(errors, threshold)

    def validate_device(
        self,
        out: Cloudsc2Outputs,
        inputs: Cloudsc2Inputs,
        reference_path,
        threshold: float = 10.0,
        quiet: bool = False,
    ) -> bool:
        """VALIDATE with device-resident statistics
        (:meth:`device_errors`), printed as the reference's table."""
        errors = self.device_errors(out, inputs, reference_path)
        if quiet:
            return all(e.passed(threshold) for e in errors.values())
        return cval.print_validation(errors, threshold)

    def device_errors(
        self, out: Cloudsc2Outputs, inputs: Cloudsc2Inputs, reference_path,
    ) -> Dict[str, "cval.FieldErrors"]:
        """Per-field validation statistics, reduced on the device.

        The golden 100 columns are tiled on device (``_tile_columns``) and
        every field's five reductions run under jit — only scalars cross
        the host link, so golden validation works at any NGPTOT without
        fetching GB of results.  On a mesh the reductions become XLA
        collectives (≙ the MPI_REDUCEs of validate_mod.F90:149-151).
        PLUDE is IN-only for CLOUDSC2 and validates from the input state;
        TENDENCY_LOC_A and the rain/snow/vapour CLD species are never
        written and validate as zero (SURVEY Appendix A).
        """
        import jax
        import jax.numpy as jnp

        ncol = int(np.shape(out.pclc)[0])
        ref_small = cio.load_reference_h5(reference_path)
        # multi-process: outputs are global sharded arrays whose shards
        # live on other hosts too — assemble the golden reference as a
        # matching global array, each process materialising only its own
        # shards' cyclic tile (≙ per-rank hyperslab reads,
        # expand_mod.F90:30-46)
        multiproc = (
            isinstance(out.pclc, jax.Array)
            and not out.pclc.is_fully_addressable
        )
        if multiproc:
            def _global_ref(like, ref_np):
                ref_np = np.asarray(ref_np)

                def cb(idx):
                    rows = np.arange(*idx[0].indices(like.shape[0]))
                    return ref_np[rows % ref_np.shape[0]][
                        (slice(None),) + tuple(idx[1:])
                    ].astype(like.dtype)

                return jax.make_array_from_callback(
                    like.shape, like.sharding, cb
                )
        else:
            ref = _tile_columns(jax.device_put(ref_small), ncol)

        zeros2d = jnp.zeros_like(out.tenl_t)
        species = [zeros2d] * NCLV
        species[NCLDQL] = out.tenl_l
        species[NCLDQI] = out.tenl_i
        res = {
            "PLUDE": inputs.plude,
            "PCOVPTOT": out.pcovptot,
            "PFPLSL": out.pfplsl,
            "PFPLSN": out.pfplsn,
            "PFHPSL": out.pfhpsl,
            "PFHPSN": out.pfhpsn,
            "TENDENCY_LOC_A": zeros2d,
            "TENDENCY_LOC_T": out.tenl_t,
            "TENDENCY_LOC_Q": out.tenl_q,
            "TENDENCY_LOC_CLD": jnp.stack(species, axis=1),
        }
        return {
            k: cval.field_errors_jax(
                k, v,
                _global_ref(v, ref_small[k]) if multiproc
                else ref[k].astype(v.dtype),
                ngptot=ncol,
            )
            for k, v in res.items()
        }

    def write_reference(self, out: Cloudsc2Outputs, path) -> None:
        """WRITE_REFERENCE (…array_state_mod.F90:260-287): stores the first
        ``klon_file`` columns in file order (the reference requires
        NPROMA == stored KLON for this, :264-268)."""
        from .errors import abor1

        if self.ngptot < self.klon_file:
            abor1(
                f"write_reference needs >= {self.klon_file} columns, "
                f"have {self.ngptot}"
            )
        res = self.output_dict(out)
        res = {k: np.moveaxis(v[: self.klon_file], 0, -1) for k, v in res.items()}
        cio.write_reference_h5(path, res)
