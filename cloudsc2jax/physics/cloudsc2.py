"""CLOUDSC2 — cloud cover and large-scale condensation/precipitation.

JAX re-design of the reference nonlinear kernel
``src/cloudsc2_nl/cloudsc2.F90`` (742 lines of Fortran).  Design:

* Arrays are ``(ncol, nlev)`` with grid columns as the leading — and, under
  ``pjit``, the *sharded* — axis.  The reference's NPROMA blocking
  (cloudsc_driver_mod.F90:73-119) is unnecessary: XLA vectorises the
  column axis itself, and the Pallas kernel
  (:mod:`cloudsc2jax.pallas.cloudsc2_kernel`) chooses its own block size.
* The vertical dependence — precipitation fluxes ZRFL/ZSFL and the
  maximum-overlap precipitation fraction ZCOVPTOT carried level-to-level
  (cloudsc2.F90:339, 475-481, 720-723) — becomes a ``jax.lax.scan`` over the
  level axis with carry ``(rfl, sfl, covptot)``.
* Every data-dependent Fortran branch is a value-level select, so the whole
  kernel is a single traced program; "inactive branch" NaN/Inf hazards are
  removed with the standard safe-``where`` (clamp-then-select) pattern so
  that forward *and* reverse AD stay finite.
* The single nonlinear source of truth is differentiated with
  ``jax.jvp``/``jax.vjp`` (see :mod:`cloudsc2jax.tlad`); the reference's
  hand-written TL/AD regularisations under LREGCL are reproduced exactly
  with :func:`cloudsc2jax.ops.damp_tangent` at the five sites the reference
  damps (cloudsc2tl.F90:575-580, :657, :754-760, :794-800, :998-1000).

The returned PCOVPTOT is only written inside the precip-evaporation branch
(cloudsc2.F90:582), which is active only under LEVAPLS2/LDRAIN1D — matching
the reference configuration where it validates as all-zero.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..constants import Params
from ..ops import damp_tangent

__all__ = ["Cloudsc2Inputs", "Cloudsc2Outputs", "cloudsc2"]

# Tunables fixed inside the reference kernel (cloudsc2.F90:172, 242-244).
_ZSCAL = 0.9
_ZQMAX = 0.5
_ZEPS1 = 1.0e-12
_ZEPS2 = 1.0e-10


class Cloudsc2Inputs(NamedTuple):
    """The 16 differentiated inputs, in the order the TL/AD drivers perturb
    them (cloudsc_driver_tl_mod.F90:156-171)."""

    paph: jax.Array  # (ncol, nlev+1) half-level pressure        [PAPHP1]
    pap: jax.Array  # (ncol, nlev)   full-level pressure         [PAPP1]
    pq: jax.Array  # (ncol, nlev)    specific humidity           [PQM1]
    pqs: jax.Array  # (ncol, nlev)   saturation humidity         [PQS]
    pt: jax.Array  # (ncol, nlev)    temperature                 [PTM1]
    pl: jax.Array  # (ncol, nlev)    cloud liquid water          [PL]
    pi: jax.Array  # (ncol, nlev)    cloud ice                   [PI]
    plude: jax.Array  # (ncol, nlev) detrained liquid            [PLUDE]
    plu: jax.Array  # (ncol, nlev)   updraught condensate        [PLU]
    pmfu: jax.Array  # (ncol, nlev)  updraught mass flux         [PMFU]
    pmfd: jax.Array  # (ncol, nlev)  downdraught mass flux       [PMFD]
    ten_t: jax.Array  # (ncol, nlev) accumulated T tendency      [PGTENT]
    ten_q: jax.Array  # (ncol, nlev) accumulated q tendency      [PGTENQ]
    ten_l: jax.Array  # (ncol, nlev) accumulated ql tendency     [PGTENL]
    ten_i: jax.Array  # (ncol, nlev) accumulated qi tendency     [PGTENI]
    psupsat: jax.Array  # (ncol, nlev) supersaturation moisture  [PSUPSAT]


class Cloudsc2Outputs(NamedTuple):
    """The 10 validated/tested outputs (cloudsc_driver_tl_mod.F90:235-244)."""

    tenl_t: jax.Array  # (ncol, nlev)   process T tendency       [PTENT]
    tenl_q: jax.Array  # (ncol, nlev)   process q tendency       [PTENQ]
    tenl_l: jax.Array  # (ncol, nlev)   process ql tendency      [PTENL]
    tenl_i: jax.Array  # (ncol, nlev)   process qi tendency      [PTENI]
    pclc: jax.Array  # (ncol, nlev)     layer cloud cover        [PCLC]
    pfplsl: jax.Array  # (ncol, nlev+1) rain flux                [PFPLSL]
    pfplsn: jax.Array  # (ncol, nlev+1) snow flux                [PFPLSN]
    pfhpsl: jax.Array  # (ncol, nlev+1) rain enthalpy flux       [PFHPSL]
    pfhpsn: jax.Array  # (ncol, nlev+1) snow enthalpy flux       [PFHPSN]
    pcovptot: jax.Array  # (ncol, nlev)  precipitation fraction  [PCOVPTOT]


def _tropopause_eta(ztp1, ceta):
    """Eta of the tropopause (cloudsc2.F90:314-326).

    The Fortran downward scan keeps overwriting ZTRPAUS, so the *last*
    (deepest) level in the 0.1<eta<0.4 band with a temperature inversion
    wins.  CETA is monotonically increasing with level index, so the last
    qualifying level is the one with the largest eta — a masked max.
    The result is piecewise-constant in the inputs (no tangent), exactly
    like the reference TL/AD which recompute it from the trajectory.
    """
    mask = (ceta[:-1] > 0.1) & (ceta[:-1] < 0.4) & (ztp1[:, :-1] > ztp1[:, 1:])
    cand = jnp.where(mask, jax.lax.stop_gradient(ceta[:-1])[None, :], 0.1)
    return jnp.max(cand, axis=-1)


def _crit_rel_humidity(ceta_k, zeta3):
    """Critical relative humidity profile (cloudsc2.F90:384-399)."""
    zrh1 = 1.0
    zrh2 = (
        0.35
        + 0.14 * ((zeta3 - 0.25) / 0.15) ** 2
        + 0.04 * jnp.minimum(zeta3 - 0.25, 0.0) / 0.15
    )
    zrh3 = 1.0
    zdeta2 = 0.3
    zdeta1 = 0.09 + 0.16 * (0.4 - zeta3) / 0.3
    above = zrh3
    blend_lo = zrh3 + (zrh2 - zrh3) * ((ceta_k - zeta3) / zdeta2)
    mid = zrh2
    blend_hi = zrh1 + (zrh2 - zrh1) * jnp.sqrt(
        jnp.maximum((1.0 - ceta_k) / zdeta1, 0.0)
    )
    return jnp.where(
        ceta_k < zeta3,
        above,
        jnp.where(
            ceta_k < zeta3 + zdeta2,
            blend_lo,
            jnp.where(ceta_k < 1.0 - zdeta1, mid, blend_hi),
        ),
    )


def cloudsc2(
    inputs: Cloudsc2Inputs,
    params: Params,
    *,
    lregcl: bool = False,
    ldrain1d: bool = False,
    remat_level: bool = False,
) -> Cloudsc2Outputs:
    """Nonlinear CLOUDSC2 over a batch of columns.

    ``lregcl`` activates the TL/AD perturbation regularisations
    (no-op on this nonlinear trajectory; it only rescales tangents /
    adjoints under ``jax.jvp``/``jax.vjp``, matching YRNCL%LREGCL).
    ``ldrain1d`` mirrors the LDRAIN1D argument (all reference drivers pass
    .FALSE., cloudsc_driver_mod.F90:61).

    ``remat_level`` checkpoints the level-scan body: reverse-mode then
    stores only each level's inputs and carries instead of every
    intermediate (the reference AD stores ~40 (KLON,KLEV) trajectory
    arrays, cloudsc2ad.F90:228-292 — this trades those for recomputation,
    cutting peak adjoint memory by an order of magnitude at 137 levels).
    """
    cst, thf = params.yomcst, params.yoethf
    cldp, phli, phnc = params.yrecldp, params.yrephli, params.yophnc
    ptsphy = params.ptsphy

    (paph, pap, pq, pqs, pt, pl, pi, plude, plu, pmfu, pmfd,
     ten_t, ten_q, ten_l, ten_i, psupsat) = inputs

    dtype = pt.dtype
    ncol, nlev = pt.shape
    ceta = jnp.asarray(params.ceta, dtype=dtype)

    reg = damp_tangent if lregcl else (lambda x, factor: x)

    # -- 1.1 derived constants (cloudsc2.F90:235-244)
    zckcodtl = 2.0 * cldp.rkconv * ptsphy
    zckcodti = 5.0 * cldp.rkconv * ptsphy
    zcons2 = 1.0 / (ptsphy * cst.rg)
    zcons3 = cst.rlvtt / cst.rcpd
    zmeltp2 = cst.rtt + 2.0
    zqtmst = 1.0 / ptsphy

    # -- 2.1 first-guess state (cloudsc2.F90:253-260)
    ztp1 = pt + ptsphy * ten_t
    zqp1 = pq + ptsphy * ten_q + psupsat
    zl = pl + ptsphy * ten_l
    zi = pi + ptsphy * ten_i

    # level-constant cloud-formation parameter (cloudsc2.F90:266)
    zscalm = _ZSCAL * jnp.maximum(ceta - 0.2, _ZEPS1) ** 0.2

    # thermodynamic factors (cloudsc2.F90:272-277)
    zdp = paph[:, 1:] - paph[:, :-1]
    zzz = 1.0 / (cst.rcpd + cst.rcpd * thf.rvtmp2 * zqp1)
    zlfdcp = cst.rlmlt * zzz
    zlsdcp = cst.rlstt * zzz
    zlvdcp = cst.rlvtt * zzz

    # tropopause eta (cloudsc2.F90:314-326)
    ztrpaus = _tropopause_eta(ztp1, ceta)

    paph_sfc = paph[:, nlev]  # surface pressure, used by precip evaporation

    levapls2 = bool(phnc.levapls2)
    lphylin = bool(phli.lphylin)

    def level_step(carry, xs):
        zrfl, zsfl, zcovptot = carry
        (ztp1_k, zqp1_k, zl_k, zi_k, pap_k, pqs_k, plude_k,
         plu_k1, pmfu_k, pmfd_k, zdp_k, zlfdcp_k, zlsdcp_k, zlvdcp_k,
         ceta_k, zscalm_k, not_last) = xs

        # ---- 3.1 dqs/dT correction factor (cloudsc2.F90:343-408)
        if lphylin or ldrain1d:
            zoealfaw = 0.545 * (jnp.tanh(0.17 * (ztp1_k - phli.rlptrc)) + 1.0)
            cold = ztp1_k < cst.rtt
            zfwat = jnp.where(cold, zoealfaw, 1.0)
            z3es = jnp.where(cold, thf.r3ies, thf.r3les)
            z4es = jnp.where(cold, thf.r4ies, thf.r4les)
            zfoeew = thf.r2es * jnp.exp(z3es * (ztp1_k - cst.rtt) / (ztp1_k - z4es))
            zesdp = zfoeew / pap_k
            zesdp = jnp.where(zesdp > _ZQMAX, _ZQMAX, zesdp)
        else:
            alfa = jnp.minimum(
                1.0,
                ((jnp.maximum(thf.rtice, jnp.minimum(thf.rtwat, ztp1_k))
                  - thf.rtice) * thf.rtwat_rtice_r) ** 2,
            )
            zfwat = alfa
            ew = jnp.exp(thf.r3les * (ztp1_k - cst.rtt) / (ztp1_k - thf.r4les))
            ei = jnp.exp(thf.r3ies * (ztp1_k - cst.rtt) / (ztp1_k - thf.r4ies))
            zfoeew = thf.r2es * (alfa * ew + (1.0 - alfa) * ei)
            zesdp = zfoeew / pap_k
        zfacw = thf.r5les / (ztp1_k - thf.r4les) ** 2
        zfaci = thf.r5ies / (ztp1_k - thf.r4ies) ** 2
        zfac = zfwat * zfacw + (1.0 - zfwat) * zfaci
        zcor = 1.0 / (1.0 - cst.retv * zesdp)
        zdqsdtemp = zfac * zcor * pqs_k
        zcorqs = 1.0 + zcons3 * zdqsdtemp

        # clipped humidity (cloudsc2.F90:379-380)
        zqlim = jnp.where(zqp1_k > pqs_k, pqs_k, zqp1_k)

        # critical humidity and ice supersaturation (cloudsc2.F90:384-407)
        zcrh2 = _crit_rel_humidity(ceta_k, ztrpaus)
        zsupsat_fac = jnp.where(ztp1_k < thf.rtice, 1.8 - 3.0e-3 * ztp1_k, 1.0)
        zqsat = pqs_k * zsupsat_fac
        zqcrit = zcrh2 * zqsat

        # ---- Letreut & Li uniform-PDF cloud cover (cloudsc2.F90:412-427)
        zqt = zqp1_k + zl_k + zi_k
        zqpd = zqsat - zqt
        zqcd = zqsat - zqcrit
        mid = (zqt > zqcrit) & (zqt < zqsat)
        denom = zqcd - zscalm_k * (zqt - zqcrit)
        denom_safe = jnp.where(mid, denom, 1.0)
        # arg-safe select: sqrt'(0)=inf would form 0*inf=NaN in reverse
        # mode at inactive points if the argument could reach 0
        ratio = jnp.where(mid, zqpd, denom_safe) / denom_safe
        sqrt_ratio = jnp.sqrt(jnp.maximum(ratio, 0.0))
        pclc_mid = 1.0 - sqrt_ratio
        if lregcl:
            # Regularisation of the cloud-fraction perturbation
            # (cloudsc2tl.F90:574-580): tangent scaled by ZYYY computed
            # from the trajectory.
            zqcd_safe = jnp.where(mid, zqcd, 1.0)
            zrat = jnp.clip(zqpd / zqcd_safe, 0.0, 1.0)
            zyyy = jnp.minimum(
                0.3,
                3.5 * jnp.sqrt(zrat * (1.0 - zscalm_k * (1.0 - zrat)) ** 3)
                / (1.0 - zscalm_k),
            )
            pclc_mid = damp_tangent(pclc_mid, zyyy)
        zqc_mid = (zscalm_k * zqpd + (1.0 - zscalm_k) * zqcd) * pclc_mid**2
        saturated = zqt >= zqsat
        pclc = jnp.where(mid, pclc_mid, jnp.where(saturated, 1.0, 0.0))
        zqc = jnp.where(
            mid,
            zqc_mid,
            jnp.where(saturated, (1.0 - zscalm_k) * zqcd, 0.0),
        )

        # ---- convective detrainment contribution (cloudsc2.F90:431-444)
        zgdp = cst.rg / zdp_k
        zlude = plude_k * ptsphy * zgdp
        llo1 = not_last & (zlude >= cldp.rlmin) & (plu_k1 >= _ZEPS2)
        plu_safe = jnp.where(llo1, plu_k1, 1.0)
        pclc_conv = pclc + (1.0 - pclc) * (1.0 - jnp.exp(-zlude / plu_safe))
        pclc = jnp.where(llo1, pclc_conv, pclc)
        zqc = jnp.where(llo1, zqc + zlude, zqc)

        # ---- compensating subsidence (cloudsc2.F90:448-460)
        zrho = pap_k / (cst.rd * ztp1_k)
        zrodqsdp = -zrho * pqs_k / (pap_k - cst.retv * zfoeew)
        zldcp = zfwat * zlvdcp_k + (1.0 - zfwat) * zlsdcp_k
        zfac3 = 1.0 / (1.0 + zldcp * zdqsdtemp)
        dtdzmo = cst.rg * (1.0 / cst.rcpd - zldcp * zrodqsdp) * zfac3
        zdqsdz = zdqsdtemp * dtdzmo - cst.rg * zrodqsdp
        zdqc_sub = zdqsdz * (pmfu_k + pmfd_k) * ptsphy / zrho
        # MIN with the Fortran tie convention (a < qc picks a); under
        # LREGCL the subsidence tangent is damped by 0.1
        # (cloudsc2tl.F90:651-661).
        zdqc = jnp.where(zdqc_sub < zqc, reg(zdqc_sub, 0.1), zqc)
        zqc = zqc - zdqc

        # ---- condensation rates (cloudsc2.F90:464-469)
        zqlwc = zqc * zfwat
        zqiwc = zqc * (1.0 - zfwat)
        zcondl = (zqlwc - zl_k) * zqtmst
        zcondi = (zqiwc - zi_k) * zqtmst

        # ---- max-overlap precipitation fraction (cloudsc2.F90:475-481)
        zcovptot = jnp.maximum(zcovptot, pclc)
        zcovpclr = jnp.maximum(zcovptot - pclc, 0.0)

        # ---- melting of incoming snow (cloudsc2.F90:487-498)
        # Branchless: ZSFL==0 gives ZSNMLT==0 exactly.
        zcons = zcons2 * zdp_k / zlfdcp_k
        zsnmlt = jnp.minimum(zsfl, zcons * jnp.maximum(0.0, ztp1_k - zmeltp2))
        zrfln = zrfl + zsnmlt
        zsfln = zsfl - zsnmlt
        ztp1_k = ztp1_k - zsnmlt / zcons

        # ---- rain production from cloud liquid (cloudsc2.F90:504-517)
        active = pclc > _ZEPS2
        pclc_safe = jnp.where(active, pclc, 1.0)
        zlcrit_l = 1.9 * cldp.rclcrit if (levapls2 or ldrain1d) else 2.0 * cldp.rclcrit
        zcldl = zqlwc / pclc_safe
        zdl = zckcodtl * (1.0 - jnp.exp(-((zcldl / zlcrit_l) ** 2)))
        if lregcl:
            # autoconversion tangent damped by 1/100 via ZCKCODTLA
            # (cloudsc2tl.F90:323, 751-760)
            zdl = damp_tangent(zdl, 0.01)
        zlnew = pclc * zcldl * jnp.exp(-zdl)
        zprr = jnp.where(active, zqlwc - zlnew, 0.0)
        zqlwc = zqlwc - zprr

        # ---- snow production from cloud ice (cloudsc2.F90:521-534)
        zlcrit_i = 1.0e-4 if (levapls2 or ldrain1d) else 2.0 * cldp.rclcrit
        zcldi = zqiwc / pclc_safe
        zdi = (
            zckcodti
            * jnp.exp(0.025 * (ztp1_k - cst.rtt))
            * (1.0 - jnp.exp(-((zcldi / zlcrit_i) ** 2)))
        )
        if lregcl:
            # (cloudsc2tl.F90:324, 791-800)
            zdi = damp_tangent(zdi, 0.01)
        zinew = pclc * zcldi * jnp.exp(-zdi)
        zprs = jnp.where(active, zqiwc - zinew, 0.0)
        zqiwc = zqiwc - zprs

        # ---- new precipitation & freezing split (cloudsc2.F90:538-552)
        zdr = zcons2 * zdp_k * (zprr + zprs)
        cold = ztp1_k < cst.rtt
        zrfreeze = jnp.where(cold, zcons2 * zdp_k * zprr, 0.0)
        zfwatr = jnp.where(cold, 0.0, 1.0)
        zrfln = zrfln + zfwatr * zdr
        zsfln = zsfln + (1.0 - zfwatr) * zdr

        # ---- clear-sky precip evaporation (cloudsc2.F90:556-591)
        # Active only under LEVAPLS2 or LDRAIN1D (llo2); PCOVPTOT is written
        # only here (:582).
        zprtot = zrfln + zsfln
        if levapls2 or ldrain1d:
            llo2 = (zprtot > _ZEPS2) & (zcovpclr > _ZEPS2)
            covptot_safe = jnp.where(llo2, zcovptot, 1.0)
            covpclr_safe = jnp.where(llo2, zcovpclr, 1.0)
            one_m_clc = jnp.where(llo2, (1.0 - pclc) ** 2, 1.0)
            zpreclr = zprtot * zcovpclr / covptot_safe
            zqe = pqs_k - (pqs_k - zqlim) * zcovpclr / one_m_clc
            # arg-safe select before the fractional power: x**0.5777 has an
            # infinite derivative at x=0, which would form 0*inf=NaN in
            # reverse mode at inactive points
            zbeta_arg = jnp.where(
                llo2,
                jnp.sqrt(pap_k / paph_sfc) / 5.09e-3 * zpreclr / covpclr_safe,
                1.0,
            )
            zbeta = cst.rg * cldp.rpecons * zbeta_arg**0.5777
            zb = ptsphy * zbeta * (pqs_k - zqe) / (1.0 + zbeta * ptsphy * zcorqs)
            zdtgdp = ptsphy * cst.rg / zdp_k
            zdpr = jnp.minimum(zcovpclr * zb / zdtgdp, zpreclr)
            zpreclr2 = zpreclr - zdpr
            zcovptot_new = jnp.where(zpreclr2 <= 0.0, pclc, zcovptot)
            zcovptot = jnp.where(llo2, zcovptot_new, zcovptot)
            pcovptot_k = jnp.where(llo2, zcovptot, 0.0)
            prtot_safe = jnp.where(llo2, zprtot, 1.0)
            zevapr = jnp.where(llo2, zdpr * zrfln / prtot_safe, 0.0)
            zevaps = jnp.where(llo2, zdpr * zsfln / prtot_safe, 0.0)
            zrfln = zrfln - zevapr
            zsfln = zsfln - zevaps
        else:
            pcovptot_k = jnp.zeros_like(zprtot)
            zevapr = jnp.zeros_like(zprtot)
            zevaps = jnp.zeros_like(zprtot)

        # ---- tendency update + first-guess T/q (cloudsc2.F90:601-618)
        def tendencies(condl, condi, rfreeze):
            dqdt = -(condl + condi) + (plude_k + zevapr + zevaps) * zgdp
            dtdt = (
                zlvdcp_k * condl
                + zlsdcp_k * condi
                - (
                    zlvdcp_k * zevapr
                    + zlsdcp_k * zevaps
                    + plude_k * (zfwat * zlvdcp_k + (1.0 - zfwat) * zlsdcp_k)
                    - (zlsdcp_k - zlvdcp_k) * rfreeze
                )
                * zgdp
            )
            return dqdt, dtdt

        zdqdt, zdtdt = tendencies(zcondl, zcondi, zrfreeze)
        ztp1_k = ztp1_k + ptsphy * zdtdt
        zqp1_k = zqp1_k + ptsphy * zdqdt
        zqold = zqp1_k

        # ---- clipping of final qv: inlined CUADJTQS, 2 Newton iterations
        # (cloudsc2.F90:628-669); phase constants chosen once.
        liquid = ztp1_k > cst.rtt
        z3es = jnp.where(liquid, thf.r3les, thf.r3ies)
        z4es = jnp.where(liquid, thf.r4les, thf.r4ies)
        z5alcp = jnp.where(liquid, thf.r5alvcp, thf.r5alscp)
        zaldcp = jnp.where(liquid, thf.ralvdcp, thf.ralsdcp)
        zqp = 1.0 / pap_k
        for _ in range(2):
            zfoeew_a = thf.r2es * jnp.exp(
                z3es * (ztp1_k - cst.rtt) / (ztp1_k - z4es)
            )
            zqsat_a = zqp * zfoeew_a
            zqsat_a = jnp.where(zqsat_a > _ZQMAX, _ZQMAX, zqsat_a)
            zcor_a = 1.0 / (1.0 - cst.retv * zqsat_a)
            zqsat_a = zqsat_a * zcor_a
            z2s = z5alcp / (ztp1_k - z4es) ** 2
            zcond1 = (zqp1_k - zqsat_a) / (1.0 + zqsat_a * zcor_a * z2s)
            ztp1_k = ztp1_k + zaldcp * zcond1
            zqp1_k = zqp1_k - zcond1

        # ---- post-adjustment precipitation/freezing (cloudsc2.F90:672-692)
        diff = zqold - zqp1_k
        # clipping tangent damped by 0.7 under LREGCL
        # (cloudsc2tl.F90:994-1001)
        zdq = jnp.where(diff >= 0.0, reg(diff, 0.7), 0.0)
        zdr2 = zcons2 * zdp_k * zdq
        cold2 = ztp1_k < cst.rtt
        zrfreeze2 = jnp.where(cold2, zfwat * zdr2, 0.0)
        zfwatr = jnp.where(cold2, 0.0, 1.0)
        zcondl = zcondl + zfwatr * zdq * zqtmst
        zcondi = zcondi + (1.0 - zfwatr) * zdq * zqtmst
        zrfln = zrfln + zfwatr * zdr2
        zsfln = zsfln + (1.0 - zfwatr) * zdr2
        zrfreeze = zrfreeze + zrfreeze2

        # ---- outputs (cloudsc2.F90:694-716)
        zdqdt, zdtdt = tendencies(zcondl, zcondi, zrfreeze)
        tenl_l = (zqlwc - zl_k) * zqtmst
        tenl_i = (zqiwc - zi_k) * zqtmst

        new_carry = (zrfln, zsfln, zcovptot)
        ys = (zdtdt, zdqdt, tenl_l, tenl_i, pclc, pcovptot_k, zrfln, zsfln)
        return new_carry, ys

    # per-level scan inputs, level axis leading
    plu_next = jnp.concatenate(
        [plu[:, 1:], jnp.zeros((ncol, 1), dtype)], axis=1
    )
    not_last = jnp.arange(nlev) < nlev - 1
    xs = (
        ztp1.T, zqp1.T, zl.T, zi.T, pap.T, pqs.T, plude.T,
        plu_next.T, pmfu.T, pmfd.T, zdp.T, zlfdcp.T, zlsdcp.T, zlvdcp.T,
        ceta, zscalm, not_last,
    )
    zero = jnp.zeros((ncol,), dtype)
    carry0 = (zero, zero, zero)
    step = jax.checkpoint(level_step) if remat_level else level_step
    _, ys = jax.lax.scan(step, carry0, xs)
    (tent, tenq, tenl, teni, pclc, pcovptot, rfln, sfln) = ys

    top = jnp.zeros((1, ncol), dtype)
    pfplsl = jnp.concatenate([top, rfln], axis=0).T
    pfplsn = jnp.concatenate([top, sfln], axis=0).T

    # enthalpy fluxes (cloudsc2.F90:730-735)
    pfhpsl = -pfplsl * cst.rlvtt
    pfhpsn = -pfplsn * cst.rlstt

    return Cloudsc2Outputs(
        tenl_t=tent.T,
        tenl_q=tenq.T,
        tenl_l=tenl.T,
        tenl_i=teni.T,
        pclc=pclc.T,
        pfplsl=pfplsl,
        pfplsn=pfplsn,
        pfhpsl=pfhpsl,
        pfhpsn=pfhpsn,
        pcovptot=pcovptot.T,
    )
