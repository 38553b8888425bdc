"""Pallas kernels (Triton route) for the nonlinear CLOUDSC2 sweep.

Schedule — one column per lane, a block of columns per program:

* The grid runs over column blocks only.  Program ``b`` owns columns
  ``[b*BC, (b+1)*BC)`` of every stream; ``BC`` is a power of two (the
  Triton lowering loads and stores power-of-two shapes only).
* A ``fori_loop`` over the levels runs inside the program.  The vertical
  recurrence — rain/snow fluxes and the maximum-overlap precipitation
  fraction (cloudsc2.F90:339,475-481,720-723) — is the loop carry, held
  in registers.  Each level loads one ``(BC,)`` row of every input stream
  and stores one row of every output: each stream crosses device memory
  once.
* Streams are levels-major ``(nlev, ncol)``, the HDF5 storage order.  The
  first-guess state, layer thickness and latent-heat factors are computed
  in-register (cloudsc2.F90:253-277); the off-level reads PAPH(k+1) and
  PLU(k+1) (:272, :435) are row loads at a shifted level of the same
  buffer, so no derived field is ever materialised.
* The per-level tables CETA and ZSCALM are scalar loads; the last-level
  flag comes from the loop index.

``levels_major=True`` accepts and returns ``(nlev, ncol)`` fields, so the
XLA passes around the call contain no transposes; ``blocked=True`` further
takes columns already padded to a block multiple and returns the raw
padded output streams, so nothing around the call copies at all.

Semantics are identical to :func:`cloudsc2jax.physics.cloudsc2.cloudsc2`;
:func:`_level_physics` is the one level body of every kernel — the TL and
AD kernels (:mod:`.tlad_kernel`) differentiate it in-kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..constants import Params
from ..ops import damp_tangent
from ..physics.satur import satur
from ..physics.cloudsc2 import (
    Cloudsc2Inputs,
    Cloudsc2Outputs,
    _ZEPS1,
    _ZEPS2,
    _ZQMAX,
    _ZSCAL,
    _crit_rel_humidity,
)

__all__ = [
    "BLOCK_COLS",
    "cloudsc2_pallas",
    "Cloudsc2BlockedOutputs",
    "unblock_outputs",
]

# raw per-level streams fed to the kernels, in order
_LEVEL_FIELDS = (
    "pt", "pq", "pqs", "pap", "pl", "pi", "plude", "pmfu", "pmfd",
    "ten_t", "ten_q", "ten_l", "ten_i", "psupsat",
)
N_LEVEL_FIELDS = len(_LEVEL_FIELDS)  # + plu(k+1), paph(k), paph(k+1)
N_OUTPUTS = 8  # tent, tenq, tenl, teni, pclc, pcov, rfln, sfln

# Triton launch shape of every sweep: columns per program (a power of
# two, and the column multiple of the padded levels-major layout), warps
# and pipeline stages.  On one H100, 64-256 columns with 2-8 warps and 1-2
# stages moved no sweep by more than run-to-run noise (PERF.md).
BLOCK_COLS = 128
NUM_WARPS = 4
NUM_STAGES = 1


def _level_physics(
    params: Params, ldrain1d: bool, scalars, fields, cols, carry,
    lregcl: bool = False,
):
    """One level of CLOUDSC2 on a ``(BC,)`` column block.

    ``scalars`` = (ceta_k, zscalm_k, not_last); ``fields`` = the 14 raw
    level rows + (plu_k1, paph_lo, paph_hi); ``cols`` = (ztrpaus,
    paph_sfc); ``carry`` = (zrfl, zsfl, zcovptot).  Returns
    (outputs, new_carry).  Line references cite
    src/cloudsc2_nl/cloudsc2.F90.

    ``lregcl`` injects the reference's TL/AD perturbation regularisations
    (identity on this nonlinear trajectory; rescales tangents/adjoints
    when the body is differentiated by the fused TL/AD kernels in
    :mod:`cloudsc2jax.pallas.tlad_kernel`) at the same five sites as the
    pure-JAX kernel: the ZYYY cloud-cover damp (cloudsc2tl.F90:574-580),
    0.1x subsidence (:657), the two 1/100 autoconversion damps
    (:323-324 with :754 and :794) and 0.7x vapour clipping (:994-1001).
    """
    cst, thf = params.yomcst, params.yoethf
    cldp, phli, phnc = params.yrecldp, params.yrephli, params.yophnc
    ptsphy = params.ptsphy

    ceta_k, zscalm_k, not_last = scalars
    (pt, pq, pqs, pap, pl_, pi_, plude, pmfu, pmfd,
     ten_t, ten_q, ten_l, ten_i, psupsat, plu_k1, paph_lo, paph_hi) = fields
    ztrpaus, paph_sfc = cols
    zrfl, zsfl, zcovptot = carry

    one = jnp.asarray(1.0, pt.dtype)
    reg = damp_tangent if lregcl else (lambda x, factor: x)

    zckcodtl = 2.0 * cldp.rkconv * ptsphy
    zckcodti = 5.0 * cldp.rkconv * ptsphy
    zcons2 = 1.0 / (ptsphy * cst.rg)
    zcons3 = cst.rlvtt / cst.rcpd
    zmeltp2 = cst.rtt + 2.0
    zqtmst = 1.0 / ptsphy

    # first-guess state (:253-260) and layer thickness (:272)
    ztp1 = pt + ptsphy * ten_t
    zqp1 = pq + ptsphy * ten_q + psupsat
    zl = pl_ + ptsphy * ten_l
    zi = pi_ + ptsphy * ten_i
    zdp = paph_hi - paph_lo

    # latent-heat factors (:272-277)
    zzz = 1.0 / (cst.rcpd + cst.rcpd * thf.rvtmp2 * zqp1)
    zlfdcp = cst.rlmlt * zzz
    zlsdcp = cst.rlstt * zzz
    zlvdcp = cst.rlvtt * zzz

    # --- 3.1 dqs/dT (LPHYLIN branch, :349-364)
    zoealfaw = 0.545 * (jnp.tanh(0.17 * (ztp1 - phli.rlptrc)) + 1.0)
    cold = ztp1 < cst.rtt
    zfwat = jnp.where(cold, zoealfaw, one)
    z3es = jnp.where(cold, thf.r3ies, thf.r3les)
    z4es = jnp.where(cold, thf.r4ies, thf.r4les)
    zfoeew = thf.r2es * jnp.exp(z3es * (ztp1 - cst.rtt) / (ztp1 - z4es))
    zesdp = jnp.minimum(zfoeew / pap, _ZQMAX)
    zfacw = thf.r5les / (ztp1 - thf.r4les) ** 2
    zfaci = thf.r5ies / (ztp1 - thf.r4ies) ** 2
    zfac = zfwat * zfacw + (1.0 - zfwat) * zfaci
    zcor = 1.0 / (1.0 - cst.retv * zesdp)
    zdqsdtemp = zfac * zcor * pqs
    zcorqs = 1.0 + zcons3 * zdqsdtemp
    zqlim = jnp.where(zqp1 > pqs, pqs, zqp1)

    zcrh2 = _crit_rel_humidity(ceta_k, ztrpaus)
    zsupsat_fac = jnp.where(ztp1 < thf.rtice, 1.8 - 3.0e-3 * ztp1, one)
    zqsat = pqs * zsupsat_fac
    zqcrit = zcrh2 * zqsat

    # --- cloud cover (:412-427)
    zqt = zqp1 + zl + zi
    zqpd = zqsat - zqt
    zqcd = zqsat - zqcrit
    mid = (zqt > zqcrit) & (zqt < zqsat)
    denom = zqcd - zscalm_k * (zqt - zqcrit)
    denom_safe = jnp.where(mid, denom, one)
    ratio = jnp.where(mid, zqpd, denom_safe) / denom_safe
    pclc_mid = 1.0 - jnp.sqrt(jnp.maximum(ratio, 0.0))
    if lregcl:
        # ZYYY cloud-fraction perturbation damp (cloudsc2tl.F90:574-580)
        zqcd_safe = jnp.where(mid, zqcd, one)
        zrat = jnp.clip(zqpd / zqcd_safe, 0.0, 1.0)
        zyyy = jnp.minimum(
            0.3,
            3.5 * jnp.sqrt(zrat * (1.0 - zscalm_k * (1.0 - zrat)) ** 3)
            / (1.0 - zscalm_k),
        )
        pclc_mid = damp_tangent(pclc_mid, zyyy)
    zqc_mid = (zscalm_k * zqpd + (1.0 - zscalm_k) * zqcd) * pclc_mid**2
    saturated = zqt >= zqsat
    pclc = jnp.where(mid, pclc_mid, jnp.where(saturated, one, 0.0))
    zqc = jnp.where(
        mid, zqc_mid, jnp.where(saturated, (1.0 - zscalm_k) * zqcd, 0.0)
    )

    # --- convective detrainment (:431-444)
    zgdp = cst.rg / zdp
    zlude = plude * ptsphy * zgdp
    llo1 = not_last & (zlude >= cldp.rlmin) & (plu_k1 >= _ZEPS2)
    plu_safe = jnp.where(llo1, plu_k1, one)
    pclc = jnp.where(
        llo1, pclc + (1.0 - pclc) * (1.0 - jnp.exp(-zlude / plu_safe)), pclc
    )
    zqc = jnp.where(llo1, zqc + zlude, zqc)

    # --- compensating subsidence (:448-460)
    zrho = pap / (cst.rd * ztp1)
    zrodqsdp = -zrho * pqs / (pap - cst.retv * zfoeew)
    zldcp = zfwat * zlvdcp + (1.0 - zfwat) * zlsdcp
    zfac3 = 1.0 / (1.0 + zldcp * zdqsdtemp)
    dtdzmo = cst.rg * (1.0 / cst.rcpd - zldcp * zrodqsdp) * zfac3
    zdqsdz = zdqsdtemp * dtdzmo - cst.rg * zrodqsdp
    zdqc_sub = zdqsdz * (pmfu + pmfd) * ptsphy / zrho
    # MIN tie convention + 0.1x subsidence tangent damp under LREGCL
    # (cloudsc2tl.F90:651-661)
    zqc = zqc - jnp.where(zdqc_sub < zqc, reg(zdqc_sub, 0.1), zqc)

    # --- condensation rates (:464-469)
    zqlwc = zqc * zfwat
    zqiwc = zqc * (1.0 - zfwat)
    zcondl = (zqlwc - zl) * zqtmst
    zcondi = (zqiwc - zi) * zqtmst

    # --- precip overlap (:475-481)
    zcovptot = jnp.maximum(zcovptot, pclc)
    zcovpclr = jnp.maximum(zcovptot - pclc, 0.0)

    # --- snow melt (:487-498)
    zcons = zcons2 * zdp / zlfdcp
    zsnmlt = jnp.minimum(zsfl, zcons * jnp.maximum(0.0, ztp1 - zmeltp2))
    zrfln = zrfl + zsnmlt
    zsfln = zsfl - zsnmlt
    ztp1 = ztp1 - zsnmlt / zcons

    # --- autoconversion (:504-534)
    levapls2 = bool(phnc.levapls2)
    active = pclc > _ZEPS2
    pclc_safe = jnp.where(active, pclc, one)
    zlcrit_l = 1.9 * cldp.rclcrit if (levapls2 or ldrain1d) else 2.0 * cldp.rclcrit
    zcldl = zqlwc / pclc_safe
    zdl = zckcodtl * (1.0 - jnp.exp(-((zcldl / zlcrit_l) ** 2)))
    zdl = reg(zdl, 0.01)  # ZCKCODTLA=ZCKCODTL/100 (cloudsc2tl.F90:323,751-760)
    zlnew = pclc * zcldl * jnp.exp(-zdl)
    zprr = jnp.where(active, zqlwc - zlnew, 0.0)
    zqlwc = zqlwc - zprr

    zlcrit_i = 1.0e-4 if (levapls2 or ldrain1d) else 2.0 * cldp.rclcrit
    zcldi = zqiwc / pclc_safe
    zdi = (
        zckcodti
        * jnp.exp(0.025 * (ztp1 - cst.rtt))
        * (1.0 - jnp.exp(-((zcldi / zlcrit_i) ** 2)))
    )
    zdi = reg(zdi, 0.01)  # (cloudsc2tl.F90:324, 791-800)
    zinew = pclc * zcldi * jnp.exp(-zdi)
    zprs = jnp.where(active, zqiwc - zinew, 0.0)
    zqiwc = zqiwc - zprs

    # --- freezing split (:538-552)
    zdr = zcons2 * zdp * (zprr + zprs)
    cold = ztp1 < cst.rtt
    zrfreeze = jnp.where(cold, zcons2 * zdp * zprr, 0.0)
    zfwatr = jnp.where(cold, 0.0, one)
    zrfln = zrfln + zfwatr * zdr
    zsfln = zsfln + (1.0 - zfwatr) * zdr

    # --- clear-sky precip evaporation (:556-591)
    zprtot = zrfln + zsfln
    if levapls2 or ldrain1d:
        llo2 = (zprtot > _ZEPS2) & (zcovpclr > _ZEPS2)
        covptot_safe = jnp.where(llo2, zcovptot, one)
        covpclr_safe = jnp.where(llo2, zcovpclr, one)
        one_m_clc = jnp.where(llo2, (1.0 - pclc) ** 2, one)
        zpreclr = zprtot * zcovpclr / covptot_safe
        zqe = pqs - (pqs - zqlim) * zcovpclr / one_m_clc
        zbeta_arg = jnp.where(
            llo2,
            jnp.sqrt(pap / paph_sfc) / 5.09e-3 * zpreclr / covpclr_safe,
            one,
        )
        zbeta = cst.rg * cldp.rpecons * zbeta_arg**0.5777
        zb = ptsphy * zbeta * (pqs - zqe) / (1.0 + zbeta * ptsphy * zcorqs)
        zdtgdp = ptsphy * cst.rg / zdp
        zdpr = jnp.minimum(zcovpclr * zb / zdtgdp, zpreclr)
        zpreclr2 = zpreclr - zdpr
        zcovptot_new = jnp.where(zpreclr2 <= 0.0, pclc, zcovptot)
        zcovptot = jnp.where(llo2, zcovptot_new, zcovptot)
        pcov = jnp.where(llo2, zcovptot, 0.0)
        prtot_safe = jnp.where(llo2, zprtot, one)
        zevapr = jnp.where(llo2, zdpr * zrfln / prtot_safe, 0.0)
        zevaps = jnp.where(llo2, zdpr * zsfln / prtot_safe, 0.0)
        zrfln = zrfln - zevapr
        zsfln = zsfln - zevaps
    else:
        pcov = jnp.zeros_like(zprtot)
        zevapr = jnp.zeros_like(zprtot)
        zevaps = jnp.zeros_like(zprtot)

    # --- tendencies + first guess (:601-618)
    def tend(condl, condi, rfreeze):
        dqdt = -(condl + condi) + (plude + zevapr + zevaps) * zgdp
        dtdt = (
            zlvdcp * condl
            + zlsdcp * condi
            - (
                zlvdcp * zevapr
                + zlsdcp * zevaps
                + plude * (zfwat * zlvdcp + (1.0 - zfwat) * zlsdcp)
                - (zlsdcp - zlvdcp) * rfreeze
            )
            * zgdp
        )
        return dqdt, dtdt

    zdqdt, zdtdt = tend(zcondl, zcondi, zrfreeze)
    ztp1 = ztp1 + ptsphy * zdtdt
    zqp1 = zqp1 + ptsphy * zdqdt
    zqold = zqp1

    # --- inlined saturation adjustment (:628-669)
    liquid = ztp1 > cst.rtt
    z3es = jnp.where(liquid, thf.r3les, thf.r3ies)
    z4es = jnp.where(liquid, thf.r4les, thf.r4ies)
    z5alcp = jnp.where(liquid, thf.r5alvcp, thf.r5alscp)
    zaldcp = jnp.where(liquid, thf.ralvdcp, thf.ralsdcp)
    zqp = 1.0 / pap
    for _ in range(2):
        foeew_a = thf.r2es * jnp.exp(z3es * (ztp1 - cst.rtt) / (ztp1 - z4es))
        qsat_a = jnp.minimum(zqp * foeew_a, _ZQMAX)
        cor_a = 1.0 / (1.0 - cst.retv * qsat_a)
        qsat_a = qsat_a * cor_a
        z2s = z5alcp / (ztp1 - z4es) ** 2
        cond1 = (zqp1 - qsat_a) / (1.0 + qsat_a * cor_a * z2s)
        ztp1 = ztp1 + zaldcp * cond1
        zqp1 = zqp1 - cond1

    # --- post-adjustment accounting (:672-692); clipping tangent damped
    # by 0.7 under LREGCL (cloudsc2tl.F90:994-1001)
    diff = zqold - zqp1
    zdq = jnp.where(diff >= 0.0, reg(diff, 0.7), jnp.zeros_like(diff))
    zdr2 = zcons2 * zdp * zdq
    cold2 = ztp1 < cst.rtt
    zrfreeze2 = jnp.where(cold2, zfwat * zdr2, 0.0)
    zfwatr = jnp.where(cold2, 0.0, one)
    zcondl = zcondl + zfwatr * zdq * zqtmst
    zcondi = zcondi + (1.0 - zfwatr) * zdq * zqtmst
    zrfln = zrfln + zfwatr * zdr2
    zsfln = zsfln + (1.0 - zfwatr) * zdr2
    zrfreeze = zrfreeze + zrfreeze2

    zdqdt, zdtdt = tend(zcondl, zcondi, zrfreeze)

    outputs = (
        zdtdt,
        zdqdt,
        (zqlwc - zl) * zqtmst,
        (zqiwc - zi) * zqtmst,
        pclc,
        pcov,
        zrfln,
        zsfln,
    )
    return outputs, (zrfln, zsfln, zcovptot)


def _level_scalars(ceta_ref, zscalm_ref, k, nlev):
    """(ceta_k, zscalm_k, not_last) of level ``k``."""
    return ceta_ref[k], zscalm_ref[k], k < nlev - 1


def _level_fields(lev_refs, plu_ref, paph_ref, k, nlev):
    """The level-``k`` rows of the raw streams, then the shifted reads
    plu(min(k+1, nlev-1)), paph(k), paph(k+1)."""
    k1 = jnp.minimum(k + 1, nlev - 1)
    return (*(r[k] for r in lev_refs), plu_ref[k1], paph_ref[k],
            paph_ref[k + 1])


def _nl_kernel(ceta_ref, zscalm_ref, *refs, params: Params, ldrain1d: bool,
               nlev: int, fuse_satur: bool):
    """One column block: ascending level loop, carry in registers.

    Three output refs past the 8 outputs store each level's carry-in
    (rfl, sfl, covptot): the whole trajectory a reverse sweep needs, since
    that is the only state that crosses levels (≙ cloudsc2ad.F90's
    forward sweep with its ~40 (KLON,KLEV) arrays reduced to three)."""
    nf = N_LEVEL_FIELDS - (1 if fuse_satur else 0)
    lev_refs = refs[:nf]
    plu_ref, paph_ref, ztrpaus_ref, paphsfc_ref = refs[nf:nf + 4]
    out_refs = refs[nf + 4:nf + 4 + N_OUTPUTS]
    ckpt_refs = refs[nf + 4 + N_OUTPUTS:]
    cols = (ztrpaus_ref[...], paphsfc_ref[...])

    def body(k, carry):
        fields = _level_fields(lev_refs, plu_ref, paph_ref, k, nlev)
        if fuse_satur:
            # stream order without pqs: pt, pq, pap, ... — qsat computed
            # in-register from the validated SATUR (the driver's
            # SATUR-then-CLOUDSC2 work unit as one sweep,
            # cloudsc_driver_mod.F90:91-107)
            pqs = satur(fields[2], fields[0], params, lphylin=True, kflag=2)
            fields = fields[:2] + (pqs,) + fields[2:]
        outs, new_carry = _level_physics(
            params, ldrain1d, _level_scalars(ceta_ref, zscalm_ref, k, nlev),
            fields, cols, carry,
        )
        for r, v in zip(out_refs, outs):
            r[k] = v
        for r, v in zip(ckpt_refs, carry):
            r[k] = v
        return new_carry

    zero = jnp.zeros_like(cols[0])
    jax.lax.fori_loop(0, nlev, body, (zero, zero, zero))


def _tropopause_eta_lm(ztp1_lm, ceta):
    """Tropopause eta, levels leading: ``(nlev, ...)`` any trailing shape
    (cloudsc2.F90:314-326)."""
    tail = (None,) * (ztp1_lm.ndim - 1)
    sl = (slice(None),) + tail
    mask = (
        (ceta[:-1] > 0.1)[sl]
        & (ceta[:-1] < 0.4)[sl]
        & (ztp1_lm[:-1] > ztp1_lm[1:])
    )
    cand = jnp.where(mask, jax.lax.stop_gradient(ceta[:-1])[sl], 0.1)
    return jnp.max(cand, axis=0)


class Cloudsc2BlockedOutputs(NamedTuple):
    """Raw kernel output streams, levels-major ``(nlev, ncol_padded)``.

    The zero-copy contract for callers that consume padded levels-major
    data (benchmarks, device-side validation).  ``unblock_outputs``
    converts to the standard :class:`Cloudsc2Outputs` contract (flux top
    row + enthalpy fluxes, cloudsc2.F90:694-735).
    """

    tenl_t: jax.Array
    tenl_q: jax.Array
    tenl_l: jax.Array
    tenl_i: jax.Array
    pclc: jax.Array
    pcovptot: jax.Array
    rfln: jax.Array
    sfln: jax.Array


def unblock_outputs(
    out: Cloudsc2BlockedOutputs, params: Params, ncol: int,
    levels_major: bool = False,
) -> Cloudsc2Outputs:
    """Raw padded streams -> standard Cloudsc2Outputs of ``ncol`` columns."""
    tent, tenq, tenl, teni, pclc, pcov, rfln, sfln = [
        o[:, :ncol] for o in out
    ]
    top = jnp.zeros((1, ncol), rfln.dtype)
    pfplsl = jnp.concatenate([top, rfln], axis=0)
    pfplsn = jnp.concatenate([top, sfln], axis=0)
    res = Cloudsc2Outputs(
        tenl_t=tent, tenl_q=tenq, tenl_l=tenl, tenl_i=teni, pclc=pclc,
        pfplsl=pfplsl, pfplsn=pfplsn,
        pfhpsl=-pfplsl * params.yomcst.rlvtt,
        pfhpsn=-pfplsn * params.yomcst.rlstt,
        pcovptot=pcov,
    )
    if not levels_major:
        res = Cloudsc2Outputs(*(x.T for x in res))
    return res


# ------------------------------------------------------------------ layout
class _Layout:
    """Levels-major padded layout shared by the NL, TL and AD wrappers.

    Transposes to ``(nlev, ncol)`` unless ``levels_major``/``blocked``,
    pads columns to a multiple of ``block_cols`` by replicating column 0
    (inputs are tile-replicated upstream anyway, expand_mod.F90
    semantics) unless ``blocked`` (already padded), and builds the block
    specs of the column grid.
    """

    def __init__(self, inputs: Cloudsc2Inputs, params: Params,
                 block_cols: int, levels_major: bool, blocked: bool = False):
        if block_cols & (block_cols - 1):
            raise ValueError(f"block_cols must be a power of two, "
                             f"got {block_cols}")
        arrs = {k: jnp.asarray(v) for k, v in inputs._asdict().items()}
        if not (levels_major or blocked):
            arrs = {k: v.T for k, v in arrs.items()}
        self.nlev, self.ncol = arrs["pt"].shape
        self.bc = block_cols
        self.nb = max(1, -(-self.ncol // block_cols))
        self.npad = self.nb * block_cols - self.ncol
        if blocked and self.npad:
            raise ValueError(
                f"blocked inputs need a column count that is a multiple of "
                f"{block_cols}, got {self.ncol}")
        self.arrs = {k: self.padcols(v) for k, v in arrs.items()}
        self.dtype = arrs["pt"].dtype

        ceta = jnp.asarray(params.ceta, self.dtype)
        self.ceta = ceta
        self.zscalm = (_ZSCAL * jnp.maximum(ceta - 0.2, _ZEPS1) ** 0.2).astype(
            self.dtype
        )
        a = self.arrs
        ztp1 = a["pt"] + params.ptsphy * a["ten_t"]
        self.ztrpaus = _tropopause_eta_lm(ztp1, ceta)
        self.paphsfc = a["paph"][self.nlev]

    def padcols(self, x):
        if self.npad == 0:
            return x
        return jnp.concatenate(
            [x, jnp.broadcast_to(x[..., :1], x.shape[:-1] + (self.npad,))], -1
        )

    def from_blocks(self, x):  # (L, ncol_padded) -> (L, ncol)
        return x if self.npad == 0 else x[:, : self.ncol]

    def level_operands(self, arrs, names=_LEVEL_FIELDS):
        """The primal-ordered streams: level fields, then plu and paph."""
        return (*(arrs[n] for n in names), arrs["plu"], arrs["paph"])

    def stream_spec(self, rows=None):
        rows = self.nlev if rows is None else rows
        return pl.BlockSpec((rows, self.bc), lambda b: (0, b))

    def col_spec(self):
        return pl.BlockSpec((self.bc,), lambda b: (b,))

    def table_spec(self):
        return pl.BlockSpec((self.nlev,), lambda b: (0,))

    def stream_specs(self, n_level_fields=N_LEVEL_FIELDS):
        """Specs of ``level_operands``: level fields, plu, paph."""
        return ([self.stream_spec()] * (n_level_fields + 1)
                + [self.stream_spec(self.nlev + 1)])

    def out_shape(self, rows=None):
        rows = self.nlev if rows is None else rows
        return jax.ShapeDtypeStruct((rows, self.nb * self.bc), self.dtype)

    def call(self, kernel, sweep, in_specs, out_specs, out_shape, operands,
             interpret):
        """``pallas_call`` over the column grid, Triton route, with the
        per-level tables prepended to the operands."""
        return pl.pallas_call(
            kernel,
            grid=(self.nb,),
            in_specs=[self.table_spec()] * 2 + list(in_specs),
            out_specs=out_specs,
            out_shape=out_shape,
            backend="triton",
            compiler_params=pltriton.CompilerParams(
                num_warps=min(NUM_WARPS, max(1, self.bc // 32)),
                num_stages=NUM_STAGES,
            ),
            interpret=interpret,
            name=f"cloudsc2_{sweep}",
        )(self.ceta, self.zscalm, *operands)


def _check_lphylin(params: Params, ldrain1d: bool, what: str):
    if not (bool(params.yrephli.lphylin) or ldrain1d):
        # the level body hardcodes the LPHYLIN dqs/dT branch (the
        # reference entry programs force LPHYLIN=.TRUE.,
        # dwarf_cloudsc.F90:107); the FOEALFA branch lives only in the
        # pure-JAX kernel — refuse rather than silently diverge
        raise NotImplementedError(
            f"{what} implements the LPHYLIN=True configuration only; use "
            "physics.cloudsc2 / cloudsc2jax.tlad for lphylin=False"
        )


def nl_sweep(lay: _Layout, params: Params, *, ldrain1d: bool,
             fuse_satur: bool = False, save_checkpoints: bool = False,
             interpret: bool = False):
    """The NL kernel on a prepared layout: returns the 8 raw padded
    output streams, then the 3 carry-in checkpoint streams if
    ``save_checkpoints``."""
    names = [n for n in _LEVEL_FIELDS if not (fuse_satur and n == "pqs")]
    kernel = functools.partial(
        _nl_kernel, params=params, ldrain1d=ldrain1d, nlev=lay.nlev,
        fuse_satur=fuse_satur,
    )
    nout = N_OUTPUTS + (3 if save_checkpoints else 0)
    return lay.call(
        kernel, "nl",
        lay.stream_specs(len(names)) + [lay.col_spec()] * 2,
        [lay.stream_spec()] * nout,
        [lay.out_shape()] * nout,
        (*lay.level_operands(lay.arrs, names), lay.ztrpaus, lay.paphsfc),
        interpret,
    )


def cloudsc2_pallas(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    ldrain1d: bool = False,
    block_cols: int = BLOCK_COLS,
    levels_major: bool = False,
    blocked: bool = False,
    fuse_satur: bool = False,
    interpret: bool = False,
) -> Cloudsc2Outputs:
    """Fused-kernel CLOUDSC2; drop-in for :func:`cloudsc2`.

    ``fuse_satur=True`` computes qsat in-kernel from the streamed PT/PAP
    instead of reading a PQS stream — the reference driver's SATUR +
    CLOUDSC2 work unit as ONE sweep, one less stream (``inputs.pqs`` is
    then ignored).

    ``levels_major=True`` expects each input field shaped ``(nlev, ncol)``
    (HDF5 storage order) and returns outputs in the same layout — the
    zero-transpose path.  Default accepts/returns the framework's
    ``(ncol, nlev)`` layout.  Columns are padded to a multiple of
    ``block_cols``, the columns of one Triton program.

    ``blocked=True`` is the zero-copy path: levels-major inputs already
    padded to a multiple of ``block_cols`` (e.g. from
    ``Cloudsc2State.device_kernel_inputs(..., block_multiple=BLOCK_COLS)``)
    and the raw padded output streams returned as
    :class:`Cloudsc2BlockedOutputs`.
    """
    _check_lphylin(params, ldrain1d, "cloudsc2_pallas")
    lay = _Layout(inputs, params, block_cols, levels_major, blocked=blocked)
    outs = nl_sweep(lay, params, ldrain1d=ldrain1d, fuse_satur=fuse_satur,
                    interpret=interpret)
    if blocked:
        return Cloudsc2BlockedOutputs(*outs)
    return unblock_outputs(
        Cloudsc2BlockedOutputs(*outs), params, lay.ncol, levels_major
    )
