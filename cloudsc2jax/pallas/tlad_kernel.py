"""Pallas kernels (Triton route) for the CLOUDSC2 tangent-linear and
adjoint sweeps.

The reference maintains hand-written TL/AD Fortran kernels
(``src/cloudsc2_tl/cloudsc2tl.F90`` 1120 lines,
``src/cloudsc2_ad/cloudsc2ad.F90`` 1746 lines) whose structure is:

* **TL** — one forward level sweep that recomputes the nonlinear
  trajectory inline while propagating the perturbation through every
  statement (cloudsc2tl.F90:341-1119).
* **AD** — a forward sweep that stores the per-level trajectory into ~40
  ``(KLON, KLEV)`` checkpoint arrays (cloudsc2ad.F90:228-292, 366-866),
  then a reverse sweep ``JK = KLEV..1`` accumulating adjoints
  (cloudsc2ad.F90:934-1668).

Here both derive from the *single* nonlinear level body
(:func:`cloudsc2jax.pallas.cloudsc2_kernel._level_physics`) via in-kernel
``jax.jvp`` / ``jax.vjp`` at trace time — the tangent/adjoint statements
are generated, not hand-maintained, yet the *schedule* is the
reference's.  Both kernels use the NL kernel's schedule: a grid over
column blocks, the level loop inside the program, carries in registers.

* :func:`cloudsc2_pallas_tl` — the loop carries the primal (rain, snow,
  covptot) and its tangent; the per-level body is
  ``jax.jvp(level_physics)``, so trajectory and perturbation are computed
  together, like the dual statements of cloudsc2tl.F90.
* :func:`cloudsc2_pallas_ad` — the forward sweep is the NL kernel storing
  the carry-in of every level (the minimal checkpoint: the only
  cross-level state is (rfl, sfl, covptot), so the reference's ~40
  trajectory arrays shrink to 3; everything else is recomputed
  in-register).  The reverse kernel runs the level loop downwards
  (``DO JK = KLEV, 1, -1``), recomputes the level body from the raw
  fields and the checkpoint, and transposes it with ``jax.vjp``; the
  adjoint carry is a loop carry.  The shifted reads PLU(k+1) and
  PAPH(k+1) transpose into plain row writes: ``d_plu[k+1]`` and
  ``d_paph[k+1] = hi(k) + lo(k+1)`` with ``lo`` carried from the previous
  (higher) level, as the reference accumulates ZPAPHTC/ZPLUTC in place
  (cloudsc2ad.F90:1721-1740).  The surface row, which also collects the
  surface-pressure reads of every level, is finished after the loop.

LREGCL regularisations enter through the shared level body (identity on
the primal, tangent/adjoint rescale via ``ops.damp_tangent``), so
``lregcl=True`` reproduces the reference AD configuration
(cloudsc2_ad/dwarf_cloudsc.F90:105) and the TL/AD pair stays mutually
adjoint by construction.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..constants import Params
from ..physics.cloudsc2 import Cloudsc2Inputs, Cloudsc2Outputs
from .cloudsc2_kernel import (
    BLOCK_COLS,
    Cloudsc2BlockedOutputs,
    N_LEVEL_FIELDS,
    N_OUTPUTS,
    _LEVEL_FIELDS,
    _Layout,
    _check_lphylin,
    _level_fields,
    _level_physics,
    _level_scalars,
    nl_sweep,
    unblock_outputs,
)

__all__ = [
    "cloudsc2_pallas_tl",
    "cloudsc2_pallas_ad",
    "fold_flux_seeds",
]


def fold_flux_seeds(d_out: Cloudsc2BlockedOutputs, params: Params):
    """Fold the 10-field output cotangent into 8 raw seed streams.

    The standard contract exposes rain/snow fluxes twice — as PFPLSL/N
    (shifted by the zero top row) and as enthalpy fluxes
    PFHPSL/N = -RLVTT/RLSTT x flux (cloudsc2.F90:730-735).  Seeding the
    raw-stream adjoint with a cotangent defined on those 10 fields
    therefore scales the flux streams by (1 + L**2); the work-unit
    convention (adjoint seeded with the TL image itself,
    cloudsc_driver_ad_mod.F90:216-237) uses exactly this fold.
    """
    cst = params.yomcst
    return d_out._replace(
        rfln=d_out.rfln * (1.0 + cst.rlvtt**2),
        sfln=d_out.sfln * (1.0 + cst.rlstt**2),
    )


def _seed_streams(lay: _Layout, params: Params, d_outputs: Cloudsc2Outputs,
                  levels_major: bool):
    """Cloudsc2Outputs cotangents -> the 8 per-level seed streams.

    Transpose of the output assembly: the flux rows k+1 and both enthalpy
    fluxes seed the level-k rain/snow outputs
    (pfhpsl = -rlvtt*pfplsl, cloudsc2.F90:730-735; pfplsl[0] is the
    constant zero top row, its cotangent drops)."""
    d = {k: jnp.asarray(v, lay.dtype) for k, v in d_outputs._asdict().items()}
    if not levels_major:
        d = {k: v.T for k, v in d.items()}
    cst = params.yomcst
    d_rfln = d["pfplsl"][1:] - cst.rlvtt * d["pfhpsl"][1:]
    d_sfln = d["pfplsn"][1:] - cst.rlstt * d["pfhpsn"][1:]
    seeds = (d["tenl_t"], d["tenl_q"], d["tenl_l"], d["tenl_i"],
             d["pclc"], d["pcovptot"], d_rfln, d_sfln)
    return tuple(lay.padcols(s) for s in seeds)


# ------------------------------------------------------------------ TL
def _tl_kernel(ceta_ref, zscalm_ref, *refs, params: Params, ldrain1d: bool,
               lregcl: bool, nlev: int, dscale, write_primal: bool):
    """Fused trajectory+tangent level loop (≙ cloudsc2tl.F90 dual
    statements); primal and tangent carries in registers.

    Three output refs past the tangents store the per-level primal
    carry-in, so a following reverse sweep needs no forward sweep of its
    own.

    ``dscale`` replaces the tangent streams with in-register
    ``dx = dscale * x`` — the canonical driver increments
    (cloudsc_driver_{tl,ad}_mod.F90: 0.01·x) as the reference holds them,
    block-local temporaries rather than grid-scale arrays."""
    nf = N_LEVEL_FIELDS
    lev_refs, (plu_ref, paph_ref), rest = refs[:nf], refs[nf:nf + 2], \
        refs[nf + 2:]
    if dscale is None:
        dlev_refs, (dplu_ref, dpaph_ref) = rest[:nf], rest[nf:nf + 2]
        ztrpaus_ref, paphsfc_ref, dpaphsfc_ref = rest[nf + 2:nf + 5]
        rest = rest[nf + 5:]
    else:
        ztrpaus_ref, paphsfc_ref = rest[:2]
        rest = rest[2:]
    nprim = N_OUTPUTS if write_primal else 0
    prim_refs = rest[:nprim]
    tan_refs = rest[nprim:nprim + N_OUTPUTS]
    ckpt_refs = rest[nprim + N_OUTPUTS:]

    ztrpaus = ztrpaus_ref[...]
    cols = (ztrpaus, paphsfc_ref[...])
    zero = jnp.zeros_like(ztrpaus)
    # the tropopause eta is piecewise-constant in the inputs — zero
    # tangent (cloudsc2.F90:314-326; same as the pure-JAX kernel)
    dsfc = dpaphsfc_ref[...] if dscale is None else dscale * cols[1]
    dcols = (zero, dsfc)

    def body(k, carries):
        carry, dcarry = carries
        fields = _level_fields(lev_refs, plu_ref, paph_ref, k, nlev)
        if dscale is None:
            dfields = _level_fields(dlev_refs, dplu_ref, dpaph_ref, k, nlev)
        else:
            dfields = tuple(dscale * x for x in fields)
        scalars = _level_scalars(ceta_ref, zscalm_ref, k, nlev)

        def f(fl, co, ca):
            return _level_physics(params, ldrain1d, scalars, fl, co, ca,
                                  lregcl=lregcl)

        (outs, new_carry), (douts, dnew_carry) = jax.jvp(
            f, (fields, cols, carry), (dfields, dcols, dcarry)
        )
        for r, v in zip(prim_refs, outs):
            r[k] = v
        for r, v in zip(tan_refs, douts):
            r[k] = v
        for r, v in zip(ckpt_refs, carry):
            r[k] = v
        return new_carry, dnew_carry

    jax.lax.fori_loop(0, nlev, body, ((zero,) * 3, (zero,) * 3))


def cloudsc2_pallas_tl(
    inputs: Cloudsc2Inputs,
    d_inputs: Cloudsc2Inputs,
    params: Params,
    *,
    lregcl: bool = False,
    ldrain1d: bool = False,
    block_cols: int = BLOCK_COLS,
    levels_major: bool = False,
    blocked: bool = False,
    save_checkpoints: bool = False,
    dscale=None,
    write_primal: bool = True,
    interpret: bool = False,
) -> Tuple[Cloudsc2Outputs, Cloudsc2Outputs]:
    """Fused-kernel tangent-linear CLOUDSC2: returns (outputs, d_outputs).

    Drop-in for :func:`cloudsc2jax.tlad.cloudsc2_tl`
    (≙ CLOUDSC2TL, cloudsc2tl.F90:10-24: one sweep, trajectory recomputed
    alongside the linear propagation, nothing stored).

    ``blocked=True``: inputs/increments arrive levels-major and padded to
    a multiple of ``block_cols``, and both results return as
    :class:`Cloudsc2BlockedOutputs` — the zero-copy path.

    ``save_checkpoints=True`` (blocked only) additionally returns the
    3 per-level primal carry-in streams, letting
    :func:`cloudsc2_pallas_ad` skip its forward sweep in the fused work
    unit — returns (outputs, d_outputs, checkpoints).

    ``dscale`` (with ``d_inputs=None``): the canonical driver increments
    dx = dscale·x are formed in-register — no tangent streams exist in
    device memory at all, matching the reference drivers' block-local
    perturbation temporaries (cloudsc_driver_tl_mod.F90:156-171).

    ``write_primal=False`` (blocked only) drops the 8 primal output
    streams (trajectory still computed in-register): the reference AD
    driver consumes only δy and x̄ (cloudsc_driver_ad_mod.F90:160-256);
    returns (None, d_outputs[, checkpoints])."""
    if save_checkpoints and not blocked:
        raise ValueError("save_checkpoints requires blocked=True")
    if not write_primal and not blocked:
        raise ValueError("write_primal=False requires blocked=True")
    if (d_inputs is None) == (dscale is None):
        raise ValueError("provide exactly one of d_inputs or dscale")
    _check_lphylin(params, ldrain1d, "the Pallas TL kernel")
    lay = _Layout(inputs, params, block_cols, levels_major, blocked=blocked)

    col = lay.col_spec()
    if dscale is None:
        d_arrs = {
            k: jnp.asarray(v, lay.dtype) for k, v in d_inputs._asdict().items()
        }
        if not (levels_major or blocked):
            d_arrs = {k: v.T for k, v in d_arrs.items()}
        d_arrs = {k: lay.padcols(v) for k, v in d_arrs.items()}
        in_specs = lay.stream_specs() * 2 + [col] * 3
        operands = (*lay.level_operands(lay.arrs),
                    *lay.level_operands(d_arrs),
                    lay.ztrpaus, lay.paphsfc, d_arrs["paph"][lay.nlev])
    else:
        in_specs = lay.stream_specs() + [col] * 2
        operands = (*lay.level_operands(lay.arrs), lay.ztrpaus, lay.paphsfc)

    nprim = N_OUTPUTS if write_primal else 0
    nout = nprim + N_OUTPUTS + (3 if save_checkpoints else 0)
    kernel = functools.partial(
        _tl_kernel, params=params, ldrain1d=ldrain1d, lregcl=lregcl,
        nlev=lay.nlev, dscale=None if dscale is None else float(dscale),
        write_primal=write_primal,
    )
    outs = lay.call(kernel, "tl", in_specs, [lay.stream_spec()] * nout,
                    [lay.out_shape()] * nout, operands, interpret)
    if blocked:
        out_b = (Cloudsc2BlockedOutputs(*outs[:N_OUTPUTS]) if write_primal
                 else None)
        dout_b = Cloudsc2BlockedOutputs(*outs[nprim:nprim + N_OUTPUTS])
        if save_checkpoints:
            return out_b, dout_b, tuple(outs[nprim + N_OUTPUTS:])
        return out_b, dout_b
    out = unblock_outputs(Cloudsc2BlockedOutputs(*outs[:N_OUTPUTS]), params,
                          lay.ncol, levels_major)
    d_out = unblock_outputs(Cloudsc2BlockedOutputs(*outs[N_OUTPUTS:]),
                            params, lay.ncol, levels_major)
    return out, d_out


# ------------------------------------------------------------------ AD
def _rev_kernel(ceta_ref, zscalm_ref, *refs, params: Params, ldrain1d: bool,
                lregcl: bool, nlev: int, seed_scales):
    """Reverse sweep (≙ cloudsc2ad.F90:934-1668, DO JK=KLEV,1,-1): the
    level loop runs downwards; each level's trajectory is recomputed from
    the raw fields + carry checkpoint and transposed with jax.vjp; the
    adjoint carry is a loop carry.

    Outputs: the 14 plain level-field adjoints, ``d_plu`` (nlev rows) and
    ``d_paph`` (nlev+1 rows), written whole — the shifted reads become
    plain row writes one level up (module docstring)."""
    nf = N_LEVEL_FIELDS
    lev_refs, (plu_ref, paph_ref) = refs[:nf], refs[nf:nf + 2]
    ckpt_refs = refs[nf + 2:nf + 5]
    seed_refs = refs[nf + 5:nf + 5 + N_OUTPUTS]
    ztrpaus_ref, paphsfc_ref = refs[nf + 5 + N_OUTPUTS:nf + 7 + N_OUTPUTS]
    dlev_refs = refs[nf + 7 + N_OUTPUTS:2 * nf + 7 + N_OUTPUTS]
    dplu_ref, dpaph_ref = refs[2 * nf + 7 + N_OUTPUTS:]

    cols = (ztrpaus_ref[...], paphsfc_ref[...])
    zero = jnp.zeros_like(cols[0])

    def body(i, carries):
        dcarry, dlo, dsfc, dtop = carries
        kr = nlev - 1 - i  # physical level of this step
        fields = _level_fields(lev_refs, plu_ref, paph_ref, kr, nlev)
        carry_in = tuple(r[kr] for r in ckpt_refs)
        scalars = _level_scalars(ceta_ref, zscalm_ref, kr, nlev)

        def f(fl, co, ca):
            return _level_physics(params, ldrain1d, scalars, fl, co, ca,
                                  lregcl=lregcl)

        _, vjp_fn = jax.vjp(f, fields, cols, carry_in)
        seeds = tuple(r[kr] for r in seed_refs)
        if seed_scales is not None:
            # flux-seed fold done in-register on load (see
            # fold_flux_seeds for the (1+L^2) derivation)
            srfl, ssfl = seed_scales
            seeds = seeds[:6] + (seeds[6] * srfl, seeds[7] * ssfl)
        dfields, dcols, dcarry_in = vjp_fn((seeds, dcarry))

        for r, v in zip(dlev_refs, dfields[:nf]):
            r[kr] = v
        d_plu_k1, d_lo, d_hi = dfields[nf:]
        # plu read at level kr+1: at kr = nlev-1 the read is clamped onto
        # row nlev-1 and its cotangent is exactly zero (llo1 is masked by
        # not_last); the next step writes that row with its real value
        dplu_ref[jnp.minimum(kr + 1, nlev - 1)] = d_plu_k1
        dpaph_ref[kr + 1] = d_hi + dlo
        # d_ztrpaus (dcols[0]) is exactly zero (stop-gradient masked max)
        dtop = jnp.where(i == 0, d_hi, dtop)
        return dcarry_in, d_lo, dsfc + dcols[1], dtop

    _, dlo, dsfc, dtop = jax.lax.fori_loop(
        0, nlev, body, ((zero,) * 3, zero, zero, zero)
    )
    # plu level 0 is never read as k+1; paph row 0 is read only as lo(0);
    # the surface row also collects every level's surface-pressure read
    dplu_ref[0] = zero
    dpaph_ref[0] = dlo
    dpaph_ref[nlev] = dtop + dsfc


def cloudsc2_pallas_ad(
    inputs: Cloudsc2Inputs,
    d_outputs: Cloudsc2Outputs,
    params: Params,
    *,
    lregcl: bool = True,
    ldrain1d: bool = False,
    block_cols: int = BLOCK_COLS,
    levels_major: bool = False,
    blocked: bool = False,
    checkpoints=None,
    fold_seeds: bool = False,
    interpret: bool = False,
) -> Tuple[Cloudsc2Outputs, Cloudsc2Inputs]:
    """Fused-kernel adjoint CLOUDSC2: returns (outputs, input_adjoints).

    Drop-in for :func:`cloudsc2jax.tlad.cloudsc2_ad`
    (≙ CLOUDSC2AD, cloudsc2ad.F90:177-202): forward checkpoint sweep +
    reverse accumulation sweep, seeded with output adjoints.

    ``blocked=True``: inputs arrive levels-major and padded, ``d_outputs``
    is a :class:`Cloudsc2BlockedOutputs` cotangent (use
    :func:`fold_flux_seeds` if it represents the 10-field contract), and
    (outputs, input_adjoints) return padded levels-major.

    ``fold_seeds=True`` (blocked only) applies the
    :func:`fold_flux_seeds` (1+L²) flux scaling in-register on seed load
    instead of as a separate XLA pass.

    ``checkpoints`` (blocked only): per-level primal carry-in streams
    from ``cloudsc2_pallas_tl(save_checkpoints=True)`` — the forward
    sweep is then skipped entirely (the TL kernel already recomputed the
    trajectory) and the returned ``outputs`` is ``None``."""
    if checkpoints is not None and not blocked:
        raise ValueError("external checkpoints require blocked=True")
    if fold_seeds and not blocked:
        raise ValueError("fold_seeds requires blocked=True")
    _check_lphylin(params, ldrain1d, "the Pallas AD kernels")
    lay = _Layout(inputs, params, block_cols, levels_major, blocked=blocked)

    if checkpoints is not None:
        outs, ckpts = None, tuple(checkpoints)
    else:
        fwd = nl_sweep(lay, params, ldrain1d=ldrain1d, save_checkpoints=True,
                       interpret=interpret)
        outs, ckpts = fwd[:N_OUTPUTS], fwd[N_OUTPUTS:]

    if blocked:
        seeds = tuple(jnp.asarray(s, lay.dtype) for s in d_outputs)
    else:
        seeds = _seed_streams(lay, params, d_outputs, levels_major)
    kernel = functools.partial(
        _rev_kernel, params=params, ldrain1d=ldrain1d, lregcl=lregcl,
        nlev=lay.nlev,
        seed_scales=(
            (1.0 + float(params.yomcst.rlvtt) ** 2,
             1.0 + float(params.yomcst.rlstt) ** 2)
            if fold_seeds else None
        ),
    )
    lev = lay.stream_spec()
    rev = lay.call(
        kernel, "ad",
        lay.stream_specs() + [lev] * (3 + N_OUTPUTS) + [lay.col_spec()] * 2,
        [lev] * (N_LEVEL_FIELDS + 1) + [lay.stream_spec(lay.nlev + 1)],
        [lay.out_shape()] * (N_LEVEL_FIELDS + 1)
        + [lay.out_shape(lay.nlev + 1)],
        (*lay.level_operands(lay.arrs), *ckpts, *seeds, lay.ztrpaus,
         lay.paphsfc),
        interpret,
    )
    d = {name: lay.from_blocks(x)
         for name, x in zip((*_LEVEL_FIELDS, "plu", "paph"), rev)}
    d_in = Cloudsc2Inputs(**d)
    if blocked:
        if outs is None:
            return None, d_in
        return Cloudsc2BlockedOutputs(*outs), d_in
    out = unblock_outputs(Cloudsc2BlockedOutputs(*outs), params, lay.ncol,
                          levels_major)
    if not levels_major:
        d_in = Cloudsc2Inputs(*(x.T for x in d_in))
    return out, d_in
