"""Input/reference file I/O and synthetic-state generation.

Re-designs the reference I/O stack (``src/common/module/file_io_mod.F90``,
``hdf5_file_mod.F90``, ``expand_mod.F90``):

* Archives are NumPy ``.npz`` (always available) or HDF5 ``.h5`` (read and
  written through the optional h5py, imported only for an ``.h5`` path);
  both keep the reference schema exactly
  (datasets stored ``(nlev[, +1], nlon)`` C-order float64, scalars as
  1-element datasets — see cloudsc2_array_state_mod.F90:161-199 and
  Appendix A of SURVEY.md).  :func:`write_input_h5` emits every dataset
  named by the reference's readers — all 14 field groups + run scalars
  (cloudsc2_array_state_mod.F90:161-199) and the complete constant
  groups: 9 YOMCST + 19 YOETHF + 122 YRECLDP scalars, the
  RBETA/RBETAP1(0:100) arrays, and 16 YREPHLI entries (yomcst.F90:
  167-177, yoethf.F90:79-99, yoecldp.F90:242-370, yoephli.F90:79-97) —
  verified dataset-by-dataset against the Fortran loader sources by
  ``tests/test_io.py::test_input_schema_matches_reference_loaders``.
* The reference's NPROMA-block "expand" machinery (expand_mod.F90:173-335)
  collapses to a cyclic ``np.tile`` over the flat column axis — our layout
  is simply ``(ncol, nlev)``.
* The upstream ``input.h5`` artifact is **not shipped** with the reference
  snapshot (only ``reference.h5`` is, cf. src/cloudsc2_nl/CMakeLists.txt:28
  which symlinks it from config-files/).  :func:`synthetic_state` therefore
  generates a physically-plausible 100-column atmospheric state with the
  exact input schema, and :func:`write_input_h5` materialises it as an
  ``input.h5`` the *reference* binaries could also consume.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from .constants import NCLDQI, NCLDQL, NCLV, Params

__all__ = [
    "synthetic_state",
    "expand_columns",
    "write_input_h5",
    "load_input_h5",
    "load_reference_h5",
    "write_reference_h5",
    "INPUT_FIELDS",
    "REFERENCE_FIELDS",
]

# field name -> per-column trailing shape, as functions of (nlev,)
INPUT_FIELDS = {
    "PT": lambda nlev: (nlev,),
    "PQ": lambda nlev: (nlev,),
    "PAP": lambda nlev: (nlev,),
    "PAPH": lambda nlev: (nlev + 1,),
    "PLU": lambda nlev: (nlev,),
    "PLUDE": lambda nlev: (nlev,),
    "PMFU": lambda nlev: (nlev,),
    "PMFD": lambda nlev: (nlev,),
    "PA": lambda nlev: (nlev,),
    "PCLV": lambda nlev: (NCLV, nlev),
    "PSUPSAT": lambda nlev: (nlev,),
    "TENDENCY_CML_T": lambda nlev: (nlev,),
    "TENDENCY_CML_A": lambda nlev: (nlev,),
    "TENDENCY_CML_Q": lambda nlev: (nlev,),
    "TENDENCY_CML_CLD": lambda nlev: (NCLV, nlev),
}

REFERENCE_FIELDS = {
    "PLUDE": lambda nlev: (nlev,),
    "PCOVPTOT": lambda nlev: (nlev,),
    "PFPLSL": lambda nlev: (nlev + 1,),
    "PFPLSN": lambda nlev: (nlev + 1,),
    "PFHPSL": lambda nlev: (nlev + 1,),
    "PFHPSN": lambda nlev: (nlev + 1,),
    "TENDENCY_LOC_A": lambda nlev: (nlev,),
    "TENDENCY_LOC_T": lambda nlev: (nlev,),
    "TENDENCY_LOC_Q": lambda nlev: (nlev,),
    "TENDENCY_LOC_CLD": lambda nlev: (NCLV, nlev),
}


class _NpzStore:
    """Dict-like wrapper so .npz archives satisfy the h5py read surface
    (f[k], k in f) used by the constant-group loaders."""

    def __init__(self, path):
        self._z = np.load(path)

    def __getitem__(self, k):
        return self._z[k]

    def __contains__(self, k):
        return k in self._z.files

    def keys(self):
        return self._z.files

    def close(self):
        self._z.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_store(path, mode="r"):
    """Open an input/reference archive: HDF5 (.h5) or NumPy (.npz).

    The storage-backend switch replacing the reference's compile-time
    Serialbox-vs-HDF5 selection (file_io_mod.F90:13-37) — here a runtime
    dispatch on extension, same field schema in both formats.
    """
    path = str(path)
    if path.endswith(".npz"):
        if mode != "r":
            raise ValueError("npz stores are written with write_store()")
        return _NpzStore(path)
    return _h5py().File(path, mode)


def _h5py():
    """h5py, needed only for ``.h5`` archives."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading or writing an .h5 archive needs h5py (pip install "
            "'cloudsc2jax[hdf5]'); the bundled fixtures also exist as .npz"
        ) from e
    return h5py


def write_store(path, datasets) -> None:
    """Write a field/scalar dict to .h5 or .npz with the same schema."""
    path = str(path)
    if path.endswith(".npz"):
        np.savez(path, **{k: np.asarray(v) for k, v in datasets.items()})
        return
    with _h5py().File(path, "w") as f:
        for k, v in datasets.items():
            f.create_dataset(k, data=np.asarray(v))


def _standard_atmosphere_t(z):
    """Piecewise-linear ICAO-like temperature profile T(z[m])."""
    # (z_base, T_base, lapse K/m)
    layers = [
        (0.0, 288.15, -6.5e-3),
        (11000.0, 216.65, 0.0),
        (20000.0, 216.65, 1.0e-3),
        (32000.0, 228.65, 2.8e-3),
        (47000.0, 270.65, 0.0),
        (51000.0, 270.65, -2.8e-3),
        (71000.0, 214.65, -2.0e-3),
    ]
    t = np.empty_like(z)
    for zb, tb, lr in layers:
        sel = z >= zb
        t[sel] = tb + lr * (z[sel] - zb)
    t[z < 0] = 288.15
    return t


def synthetic_state(
    nlon: int = 100,
    nlev: int = 137,
    seed: int = 2026,
    ptsphy: float = 3600.0,
) -> Tuple[Dict[str, np.ndarray], Params]:
    """Generate a physically-plausible input state.

    Returns ``(fields, params)`` where ``fields`` maps the reference input
    dataset names to float64 arrays in file order (trailing column axis,
    per INPUT_FIELDS), and ``params`` carries all constant groups with the
    CETA coordinate derived exactly as the reference entry program does
    (dwarf_cloudsc.F90:100-102: CETA(jk)=PAP(1,jk,1)/PAPH(1,KLEV+1,1)).
    """
    rng = np.random.default_rng(seed)

    # --- vertical grid: half levels quadratically refined towards the
    # surface (an IFS-like density), top at ~80 km.
    s = np.linspace(0.0, 1.0, nlev + 1)
    z_half = 80000.0 * (1.0 - s) ** 1.7  # (nlev+1,), z_half[-1]=0 (surface)

    ps = 101325.0 * (1.0 + 0.02 * rng.standard_normal(nlon)).clip(0.94, 1.04)

    # hydrostatic half-level pressure from the standard atmosphere
    t_prof = _standard_atmosphere_t(z_half)
    rd, g = 287.0597, 9.80665
    # integrate ln p upward from the surface
    lnp = np.zeros(nlev + 1)
    for k in range(nlev - 1, -1, -1):
        dz = z_half[k] - z_half[k + 1]
        tbar = 0.5 * (t_prof[k] + t_prof[k + 1])
        lnp[k] = lnp[k + 1] - g * dz / (rd * tbar)
    sigma_half = np.exp(lnp)  # 1 at surface, ~3e-6 at top
    paph = ps[None, :] * sigma_half[:, None]  # (nlev+1, nlon)
    pap = 0.5 * (paph[:-1] + paph[1:])  # (nlev, nlon)

    z_full = 0.5 * (z_half[:-1] + z_half[1:])
    t_base = _standard_atmosphere_t(z_full)  # (nlev,)

    # column-to-column variability: warm/cold columns, boundary-layer noise
    dt_col = 8.0 * rng.standard_normal(nlon)
    pt = t_base[:, None] + dt_col[None, :] * np.exp(-((z_full[:, None]) / 12000.0))
    pt += 0.8 * rng.standard_normal((nlev, nlon))
    pt = pt.clip(180.0, 320.0)

    # humidity: fraction of saturation with a moist lower troposphere;
    # qsat via the kernel's own SATUR (single source of the saturation
    # formula — elementwise, so the (nlev, nlon) file layout is fine)
    params0 = Params.ifs_defaults(ceta=pap[:, 0] / paph[nlev, 0], ptsphy=ptsphy)
    from .physics.satur import satur

    qs = np.asarray(satur(pap, pt, params0, lphylin=True, kflag=2), np.float64)
    rh = (
        0.55
        + 0.35 * np.exp(-z_full[:, None] / 3000.0)
        + 0.12 * np.sin(z_full[:, None] / 2500.0)
        + 0.18 * rng.standard_normal((1, nlon))
        + 0.06 * rng.standard_normal((nlev, nlon))
    ).clip(0.05, 1.05)
    # dry stratosphere: relax towards ~3 ppmv above ~200 hPa
    pfrac_full = pap / ps[None, :]
    strat = (pfrac_full < 0.2).astype(float)
    pq = (rh * qs).clip(1e-9, 0.03)
    pq = np.where(strat > 0, np.minimum(pq, 3.0e-6), pq)

    # cloud condensate: liquid in the 600-950 hPa band, ice at 200-600 hPa,
    # present in cloudy columns only
    cloudy = (rng.random(nlon) < 0.65).astype(float)
    pfrac = pap / ps[None, :]
    liq_band = np.exp(-(((pfrac - 0.8) / 0.12) ** 2))
    ice_band = np.exp(-(((pfrac - 0.4) / 0.15) ** 2))
    amp = rng.random(nlon) * cloudy
    ql = 2.5e-4 * liq_band * amp[None, :] * rng.random((nlev, nlon))
    qi = 1.2e-4 * ice_band * amp[None, :] * rng.random((nlev, nlon))

    pclv = np.zeros((NCLV, nlev, nlon))
    pclv[NCLDQL] = ql
    pclv[NCLDQI] = qi

    # cloud fraction consistent-ish with condensate
    pa = ((ql + qi) > 1e-7).astype(float) * (0.3 + 0.7 * rng.random((nlev, nlon)))

    # convection: updraught condensate/mass flux in ~40% of columns,
    # confined to the troposphere (taper to zero above ~300 hPa)
    conv = (rng.random(nlon) < 0.4).astype(float)
    conv_band = np.exp(-(((pfrac - 0.65) / 0.25) ** 2))
    conv_band *= np.clip((pfrac - 0.3) / 0.1, 0.0, 1.0)
    plu = 1.5e-4 * conv_band * conv[None, :] * rng.random((nlev, nlon))
    plude = 2.0e-5 * conv_band * conv[None, :] * rng.random((nlev, nlon))
    pmfu = 8.0e-3 * conv_band * conv[None, :] * rng.random((nlev, nlon))
    pmfd = -2.0e-3 * conv_band * conv[None, :] * rng.random((nlev, nlon))

    # accumulated tendencies from "other processes": small smooth fields,
    # vanishing in the upper stratosphere/mesosphere
    taper = np.clip(pfrac / 0.05, 0.0, 1.0)
    ten_t = 2.0e-5 * rng.standard_normal((nlev, nlon)) * (1.0 + 2.0 * pfrac) * taper
    ten_q = 1.0e-8 * rng.standard_normal((nlev, nlon)) * taper * (pfrac > 0.2)
    ten_cld = np.zeros((NCLV, nlev, nlon))
    ten_cld[NCLDQL] = 2.0e-9 * rng.standard_normal((nlev, nlon)) * (ql > 0)
    ten_cld[NCLDQI] = 1.0e-9 * rng.standard_normal((nlev, nlon)) * (qi > 0)
    ten_a = np.zeros((nlev, nlon))

    # supersaturation memory: small, only in cold tropospheric levels
    psupsat = np.where(
        (pt < 250.0) & (pfrac > 0.2), 2.0e-6 * rng.random((nlev, nlon)), 0.0
    )

    fields = {
        "PT": pt,
        "PQ": pq,
        "PAP": pap,
        "PAPH": paph,
        "PLU": plu,
        "PLUDE": plude,
        "PMFU": pmfu,
        "PMFD": pmfd,
        "PA": pa,
        "PCLV": pclv,
        "PSUPSAT": psupsat,
        "TENDENCY_CML_T": ten_t,
        "TENDENCY_CML_A": ten_a,
        "TENDENCY_CML_Q": ten_q,
        "TENDENCY_CML_CLD": ten_cld,
    }
    fields = {k: np.asarray(v, dtype=np.float64) for k, v in fields.items()}
    return fields, params0


def expand_columns(
    fields: Dict[str, np.ndarray], ngptot: int, columns_first: bool = False
) -> Dict[str, np.ndarray]:
    """Cyclically tile the stored columns up to ``ngptot`` grid points.

    Equivalent of EXPAND_R2/R3 (expand_mod.F90:270-335) without the NPROMA
    block gymnastics.  ``columns_first=True`` returns framework order
    ``(ngptot, …)`` directly — the native memcpy sweep produces exactly
    that layout, so the large back-and-forth transposes are skipped (the
    slow-host rule: never pay avoidable ngptot-scale numpy passes).
    """
    from .native import hostinfo

    out = {}
    for k, v in fields.items():
        nlon = v.shape[-1]
        # src prep touches only the ~100 stored columns — cheap
        src = np.ascontiguousarray(np.moveaxis(np.asarray(v, np.float64), -1, 0))
        dst = np.empty((ngptot,) + src.shape[1:], dtype=np.float64)
        if hostinfo.expand_f64(src, dst):
            out[k] = dst if columns_first else np.ascontiguousarray(
                np.moveaxis(dst, 0, -1)
            )
        else:
            reps = -(-ngptot // nlon)
            tiled = np.tile(v, (1,) * (v.ndim - 1) + (reps,))[..., :ngptot]
            out[k] = _columns_first(tiled) if columns_first \
                else np.ascontiguousarray(tiled)
    return out


def write_input_h5(path, fields: Dict[str, np.ndarray], params: Params) -> None:
    """Write an input archive (.h5 or .npz) with the exact reference schema
    (cloudsc2_array_state_mod.F90:161-199, yo*_LOAD_PARAMETERS readers)."""
    nlev = fields["PT"].shape[0]
    nlon = fields["PT"].shape[-1]
    ds: Dict[str, np.ndarray] = {
        "KLON": np.array([nlon], dtype=np.int32),
        "KLEV": np.array([nlev], dtype=np.int32),
        "PTSPHY": np.array([params.ptsphy]),
        "LDSLPHY": np.array([0], dtype=np.int32),
        "LDMAINCALL": np.array([0], dtype=np.int32),
    }
    for k, v in fields.items():
        ds[k] = np.asarray(v, dtype=np.float64)
    for grp in (params.yomcst, params.yoethf, params.yrecldp, params.yrephli):
        for k, v in grp.h5_items().items():
            if isinstance(v, (tuple, list, np.ndarray)):
                # array-valued parameters (YRECLDP_RBETA/RBETAP1(0:100),
                # read via LOAD_ARRAY, yoecldp.F90:367-369)
                ds[k] = np.asarray(v, dtype=np.float64)
            elif isinstance(v, (bool, int, np.integer)):
                # logicals and integers are int datasets (file_io_mod's
                # load_scalar logical/int readers)
                ds[k] = np.array([int(v)], dtype=np.int32)
            else:
                ds[k] = np.array([float(v)])
    write_store(path, ds)


def _columns_first(arr: np.ndarray) -> np.ndarray:
    """File order (…, nlev, nlon) -> framework order (nlon, …, nlev)."""
    return np.ascontiguousarray(np.moveaxis(arr, -1, 0))


def load_input_h5(path, ngptot: Optional[int] = None):
    """Load (and optionally expand) an input file.

    Returns ``(fields, params)`` with fields in framework order
    ``(ncol, [nclv,] nlev)`` float64.
    """
    from .errors import abor1

    with open_store(path) as f:
        for key in ("KLON", "KLEV", "PTSPHY", "PT", "PAP", "PAPH"):
            if key not in f:
                abor1(f"input store {path} is missing dataset {key}")
        nlev = int(f["KLEV"][0])
        ptsphy = float(f["PTSPHY"][0])
        missing = [
            k for k in INPUT_FIELDS
            if k not in f and k != "TENDENCY_CML_A"  # defaults to zeros
        ]
        if missing:
            abor1(f"input store {path} is missing datasets {missing}")
        raw = {k: np.asarray(f[k], dtype=np.float64) for k in INPUT_FIELDS if k in f}
        from .constants import Yoethf, Yomcst, Yophnc, Yomncl, Yrecldp, Yrephli

        cst = Yomcst.from_h5(f)
        params = Params(
            yomcst=cst,
            yoethf=Yoethf.from_h5(f),
            yrecldp=Yrecldp.from_h5(f),
            yrephli=Yrephli.from_h5(f),
            yophnc=Yophnc.ifs_defaults(),
            yomncl=Yomncl.ifs_defaults(),
            ceta=tuple(
                (raw["PAP"][:, 0] / raw["PAPH"][nlev, 0]).tolist()
            ),
            ptsphy=ptsphy,
        )
    if "TENDENCY_CML_A" not in raw:
        raw["TENDENCY_CML_A"] = np.zeros_like(raw["PT"])
    if ngptot is not None:
        return expand_columns(raw, ngptot, columns_first=True), params
    return {k: _columns_first(v) for k, v in raw.items()}, params


def load_reference_h5(path, ngptot: Optional[int] = None):
    """Load golden outputs; returns fields in framework order."""
    with open_store(path) as f:
        raw = {k: np.asarray(f[k], dtype=np.float64) for k in REFERENCE_FIELDS if k in f}
    if ngptot is not None:
        return expand_columns(raw, ngptot, columns_first=True)
    return {k: _columns_first(v) for k, v in raw.items()}


def write_reference_h5(path, outputs: Dict[str, np.ndarray], extra: bool = True) -> None:
    """Write golden outputs with the reference schema (file order arrays,
    cf. cloudsc2_array_state_mod.F90:260-287 WRITE_REFERENCE)."""
    nlev_nlon = outputs["PCOVPTOT"].shape
    nlev, nlon = nlev_nlon[-2], nlev_nlon[-1]
    ds: Dict[str, np.ndarray] = {
        "KLON": np.array([nlon], dtype=np.int32),
        "KLEV": np.array([nlev], dtype=np.int32),
        "KFLDX": np.array([0], dtype=np.int32),
    }
    for k, v in outputs.items():
        ds[k] = np.asarray(v, dtype=np.float64)
    if extra:
        # placeholder flux datasets present in the reference file
        for k in (
            "PFSQLF", "PFSQIF", "PFCQLNG", "PFCQNNG", "PFSQRF",
            "PFSQSF", "PFCQRNG", "PFCQSNG", "PFSQLTUR", "PFSQITUR",
        ):
            ds.setdefault(k, np.zeros((nlev + 1, nlon)))
        ds.setdefault("PRAINFRAC_TOPRFZ", np.zeros((nlon,)))
    write_store(path, ds)
