"""cloudsc2jax — the CLOUDSC2 cloud scheme, its tangent-linear and its
adjoint, in JAX.

A JAX/XLA/Pallas re-design of the capabilities of the ECMWF
``dwarf-p-cloudsc2-tl-ad`` mini-app: the CLOUDSC2 cloud/large-scale
condensation scheme (nonlinear), its tangent-linear and adjoint, the
validation harnesses (golden regression, Taylor test, adjoint symmetry
test), the state I/O (.npz, or HDF5 through the optional h5py), GPU
kernels for the three sweeps, and distributed execution over device
meshes.
"""

from .constants import (
    NCLDQI,
    NCLDQL,
    NCLDQR,
    NCLDQS,
    NCLDQV,
    NCLV,
    Params,
    Yoethf,
    Yomcst,
    Yomncl,
    Yophnc,
    Yrecldp,
    Yrephli,
)
from .physics.cloudsc2 import Cloudsc2Inputs, Cloudsc2Outputs, cloudsc2
from .physics.cuadjtqs import cuadjtqs
from .physics.satur import satur
from .tlad import cloudsc2_ad, cloudsc2_tl

__version__ = "0.1.0"

__all__ = [
    "NCLV", "NCLDQL", "NCLDQI", "NCLDQR", "NCLDQS", "NCLDQV",
    "Params", "Yomcst", "Yoethf", "Yrecldp", "Yrephli", "Yophnc", "Yomncl",
    "Cloudsc2Inputs", "Cloudsc2Outputs", "cloudsc2",
    "cuadjtqs", "satur",
    "cloudsc2_tl", "cloudsc2_ad",
]
