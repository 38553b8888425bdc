"""Saturation adjustment (Newton iteration on the saturation curve).

JAX re-design of ``src/cloudsc2_nl/cuadjtqs.F90`` (KCALL branches at
:212/:132/:172/:246).  Two Newton iterations adjust (T, q) onto the
saturation curve; the liquid-vs-ice constant set is chosen *once* from the
initial temperature (cuadjtqs.F90:118-130) and reused for both iterations.

The function is written once in differentiable JAX; the reference's
hand-coded TL (cuadjtqstl.F90) and AD (cuadjtqsad.F90) variants are obtained
via ``jax.jvp`` / ``jax.vjp`` of this single source of truth.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import Params

__all__ = ["cuadjtqs", "cuadjtqs_tl", "cuadjtqs_ad"]

_ZQMAX = 0.5


def _newton_step(t, q, zqp, z3es, z4es, z5alcp, zaldcp, params: Params):
    cst, thf = params.yomcst, params.yoethf
    foeew = thf.r2es * jnp.exp(z3es * (t - cst.rtt) / (t - z4es))
    qsat = zqp * foeew
    qsat = jnp.where(qsat > _ZQMAX, _ZQMAX, qsat)
    cor = 1.0 / (1.0 - cst.retv * qsat)
    qsat = qsat * cor
    z2s = z5alcp / (t - z4es) ** 2
    cond = (q - qsat) / (1.0 + qsat * cor * z2s)
    return cond


def cuadjtqs(psp, t, q, params: Params, *, kcall: int = 0):
    """Adjust (t, q) to saturation at pressure ``psp``.

    ``kcall`` semantics follow the reference:
      - 0: unconstrained adjustment (cuadjtqs.F90:212-244) — the variant
        manually inlined in the CLOUDSC2 NL kernel (cloudsc2.F90:628-669);
      - 1: condensation only, first increment clamped >= 0 (:132-170);
      - 2: evaporation only, first increment clamped <= 0 (:172-210);
      - 4: like 0 (:246-278).

    Returns the adjusted ``(t, q)``.
    """
    cst, thf = params.yomcst, params.yoethf
    liquid = t > cst.rtt
    z3es = jnp.where(liquid, thf.r3les, thf.r3ies)
    z4es = jnp.where(liquid, thf.r4les, thf.r4ies)
    z5alcp = jnp.where(liquid, thf.r5alvcp, thf.r5alscp)
    zaldcp = jnp.where(liquid, thf.ralvdcp, thf.ralsdcp)
    zqp = 1.0 / psp

    cond = _newton_step(t, q, zqp, z3es, z4es, z5alcp, zaldcp, params)
    if kcall == 1:
        cond = jnp.maximum(cond, 0.0)
    elif kcall == 2:
        cond = jnp.minimum(cond, 0.0)
    t = t + zaldcp * cond
    q = q - cond

    cond1 = _newton_step(t, q, zqp, z3es, z4es, z5alcp, zaldcp, params)
    if kcall in (1, 2):
        # Second increment suppressed when the first was clamped away
        # (cuadjtqs.F90:165, :205).
        cond1 = jnp.where(cond == 0.0, 0.0, cond1)
    t = t + zaldcp * cond1
    q = q - cond1
    return t, q


def cuadjtqs_tl(psp, t, q, d_psp, d_t, d_q, params: Params, *, kcall: int = 0):
    """Tangent-linear saturation adjustment.

    API-parity equivalent of CUADJTQSTL (src/cloudsc2_tl/cuadjtqstl.F90:
    10-14: trajectory PSP5/PT5/PQ5 + increments), derived from the single
    nonlinear source via ``jax.jvp``.  Returns ((t, q), (d_t, d_q)).
    """
    f = lambda p, tt, qq: cuadjtqs(p, tt, qq, params, kcall=kcall)
    return jax.jvp(f, (psp, t, q), (d_psp, d_t, d_q))


def cuadjtqs_ad(psp, t, q, a_t, a_q, params: Params, *, kcall: int = 0):
    """Adjoint saturation adjustment.

    API-parity equivalent of CUADJTQSAD (src/cloudsc2_ad/cuadjtqsad.F90:
    the forward trajectory is recomputed internally, then reversed),
    derived via ``jax.vjp``.  Seeded with output adjoints ``(a_t, a_q)``;
    returns ((t, q), (a_psp, a_t_in, a_q_in)).
    """
    f = lambda p, tt, qq: cuadjtqs(p, tt, qq, params, kcall=kcall)
    out, vjp_fn = jax.vjp(f, psp, t, q)
    return out, vjp_fn((a_t, a_q))
