"""Saturation specific humidity.

JAX re-design of the reference kernel ``src/cloudsc2_nl/satur.F90``
(three identical copies live under cloudsc2_{nl,tl,ad}).  Arrays are
``(..., nlev)`` with grid columns leading; the whole computation is
elementwise and differentiable, so TL/AD come from ``jax.jvp``/``jax.vjp``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import Params
from .. import thermo

__all__ = ["satur"]

_ZQMAX = 0.5  # satur.F90:98


def satur(pap, t, params: Params, *, lphylin: bool = True, kflag: int = 2):
    """Saturation specific humidity qsat(T, p).

    Parameters mirror ``SATUR(KIDIA,KFDIA,KLON,KTDIA,KLEV,LDPHYLIN,PAPRSF,
    PT,PQSAT,KFLAG)`` (satur.F90:10-11); the column/level bounds collapse
    into array shape, and LDPHYLIN/KFLAG are static switches.

    - ``lphylin=True`` (the drivers' configuration, e.g.
      cloudsc_driver_mod.F90:91-92) mixes explicit liquid/ice saturation
      pressures with the FOEALFA liquid fraction (satur.F90:106-123).
    - otherwise FOEEWMCU (kflag=1, convection) or FOEEWM is used
      (satur.F90:124-140).
    """
    cst, thf = params.yomcst, params.yoethf
    if lphylin:
        alfa = thermo.foealfa(t, thf)
        ew_liq = thf.r2es * jnp.exp(thf.r3les * (t - cst.rtt) / (t - thf.r4les))
        ew_ice = thf.r2es * jnp.exp(thf.r3ies * (t - cst.rtt) / (t - thf.r4ies))
        ew = alfa * ew_liq + (1.0 - alfa) * ew_ice
        qs = ew / pap
        qs = jnp.where(qs > _ZQMAX, _ZQMAX, qs)
    else:
        ew = (
            thermo.foeewmcu(t, cst, thf)
            if kflag == 1
            else thermo.foeewm(t, cst, thf)
        )
        qs = jnp.minimum(_ZQMAX, ew / pap)
    return qs / (1.0 - cst.retv * qs)
