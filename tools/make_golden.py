#!/usr/bin/env python
"""One-off golden fixture generator.

The reference snapshot ships no ``input.h5`` (only ``reference.h5``,
which holds outputs for an input state we don't have).  This tool:

1. generates the framework's synthetic 100-column input state and writes
   ``tests/fixtures/input.h5`` with the exact reference input schema;
2. executes the *reference's own validated NumPy port* of the nonlinear
   kernel (``/root/reference/src/cloudsc2_nl_gt4py/cloudsc2_py.py``,
   loaded from the read-only reference tree at generation time only —
   no reference code is copied into this repository) on that state;
3. writes the resulting outputs as ``tests/fixtures/reference.h5`` in the
   reference golden-file schema;
4. writes an ``.npz`` twin of every ``.h5`` it writes — the same datasets
   under the same names (``io.write_store``), so the CLI and the tests
   read the fixtures without h5py.

The committed fixtures are pure *data*.  The framework's golden regression
test (tests/test_nl_golden.py) then validates the JAX kernel against an
independently-written implementation of the same mathematics.

Usage: python tools/make_golden.py [--nlon 100] [--nlev 137]
       python tools/make_golden.py --npz-twins   # twins of the committed .h5
"""

import argparse
import importlib.util
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from cloudsc2jax import io as cio  # noqa: E402
from cloudsc2jax.constants import NCLDQI, NCLDQL  # noqa: E402

REFERENCE_PY = pathlib.Path("/root/reference/src/cloudsc2_nl_gt4py/cloudsc2_py.py")


def load_reference_numpy_port():
    spec = importlib.util.spec_from_file_location("cloudsc2_py_ref", REFERENCE_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def as_attr_group(dc):
    class G:
        pass

    g = G()
    import dataclasses

    for f in dataclasses.fields(dc):
        setattr(g, f.name, getattr(dc, f.name))
    return g


def run_reference_port(fields, params, ldrain1d: bool = False):
    """Execute the reference's own NumPy NL port on a synthetic state.

    Returns the golden-file outputs dict (file order, levels-major).
    Used by fixture generation AND the runtime crosscheck test
    (tests/test_crosscheck_reference.py) so our kernel can be compared
    against the reference implementation on arbitrary fresh states.
    """
    klev, klon = fields["PT"].shape
    ref = load_reference_numpy_port()

    # reference numpy port indexes arrays as [jk, jl]
    F = lambda a: np.asarray(a, dtype=np.float64)
    pt, pq = F(fields["PT"]), F(fields["PQ"])
    pap, paph = F(fields["PAP"]), F(fields["PAPH"])
    pclv = F(fields["PCLV"])
    ten_cld = F(fields["TENDENCY_CML_CLD"])

    yrmcst = as_attr_group(params.yomcst)
    yrethf = as_attr_group(params.yoethf)
    yrecldp = as_attr_group(params.yrecldp)
    yrephli = as_attr_group(params.yrephli)

    class YRECLD:
        pass

    yrecld = YRECLD()
    yrecld.ceta = np.asarray(params.ceta)

    pqsat = np.zeros((klev, klon))
    ref.satur(0, klon, klon, 0, klev, True, pap, pt, pqsat, 2, yrethf, yrmcst)

    ptent = np.zeros((klev, klon))
    ptenq = np.zeros((klev, klon))
    ptenl = np.zeros((klev, klon))
    pteni = np.zeros((klev, klon))
    pclc = np.zeros((klev, klon))
    pfplsl = np.zeros((klev + 1, klon))
    pfplsn = np.zeros((klev + 1, klon))
    pfhpsl = np.zeros((klev + 1, klon))
    pfhpsn = np.zeros((klev + 1, klon))
    pcovptot = np.zeros((klev, klon))

    ref.cloudsc2_py(
        0, klon, klon, 0, klev, bool(ldrain1d), params.ptsphy,
        paph, pap, pq, pqsat, pt,
        pclv[NCLDQL], pclv[NCLDQI],
        # The reference numpy port indexes plu[jk+1] without the Fortran
        # JK<KLEV guard (cloudsc2_py.py:329-330 uses `jk < klev`, an
        # off-by-one for 0-based jk); padding a zero row reproduces the
        # Fortran semantics (LLO1 false on the last level) exactly.
        F(fields["PLUDE"]),
        np.vstack([F(fields["PLU"]), np.zeros((1, klon))]),
        F(fields["PMFU"]), F(fields["PMFD"]),
        ptent, F(fields["TENDENCY_CML_T"]),
        ptenq, F(fields["TENDENCY_CML_Q"]),
        ptenl, ten_cld[NCLDQL],
        pteni, ten_cld[NCLDQI],
        F(fields["PSUPSAT"]),
        pclc, pfplsl, pfplsn, pfhpsl, pfhpsn, pcovptot,
        yrecldp, yrecld, yrmcst, yrethf, yrephli,
    )

    from cloudsc2jax.constants import NCLV

    tend_cld = np.zeros((NCLV, klev, klon))
    tend_cld[NCLDQL] = ptenl
    tend_cld[NCLDQI] = pteni
    return {
        "PLUDE": F(fields["PLUDE"]),  # IN-only for CLOUDSC2: passes through
        "PCOVPTOT": pcovptot,
        "PFPLSL": pfplsl,
        "PFPLSN": pfplsn,
        "PFHPSL": pfhpsl,
        "PFHPSN": pfhpsn,
        "TENDENCY_LOC_A": np.zeros((klev, klon)),
        "TENDENCY_LOC_T": ptent,
        "TENDENCY_LOC_Q": ptenq,
        "TENDENCY_LOC_CLD": tend_cld,
        "PQSAT": pqsat,  # extra: lets tests check SATUR independently
    }


def write_npz_twin(h5_path) -> pathlib.Path:
    """Copy every dataset of an ``.h5`` archive into ``<stem>.npz``."""
    h5_path = pathlib.Path(h5_path)
    with cio.open_store(h5_path) as f:
        datasets = {k: np.asarray(f[k]) for k in f.keys()}
    twin = h5_path.with_suffix(".npz")
    cio.write_store(twin, datasets)
    return twin


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nlon", type=int, default=100)
    ap.add_argument("--nlev", type=int, default=137)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--ldrain1d", action="store_true",
                    help="generate goldens with LDRAIN1D=.TRUE. (activates "
                    "the clear-sky precip-evaporation branch); writes "
                    "reference_ldrain1d.h5 and reuses the existing input.h5")
    ap.add_argument("--npz-twins", action="store_true",
                    help="only write the .npz twins of the committed .h5 "
                    "fixtures")
    args = ap.parse_args()

    fixtures = REPO / "tests" / "fixtures"
    fixtures.mkdir(parents=True, exist_ok=True)
    if args.npz_twins:
        for h5 in sorted(fixtures.glob("*.h5")):
            print(f"wrote {write_npz_twin(h5)}")
        return

    if args.ldrain1d and (fixtures / "input.h5").exists():
        # alternate goldens must correspond to the COMMITTED input state,
        # not a regenerated one (seed/nlon flags could silently diverge)
        fw, params = cio.load_input_h5(fixtures / "input.h5")
        fields = {k: np.moveaxis(v, 0, -1) for k, v in fw.items()}
        print(f"loaded state from {fixtures/'input.h5'}")
    else:
        fields, params = cio.synthetic_state(
            nlon=args.nlon, nlev=args.nlev, seed=args.seed
        )
        if not args.ldrain1d:
            cio.write_input_h5(fixtures / "input.h5", fields, params)
            print(f"wrote {fixtures/'input.h5'} and "
                  f"{write_npz_twin(fixtures / 'input.h5')}")

    t0 = time.time()
    outputs = run_reference_port(fields, params, ldrain1d=args.ldrain1d)
    print(f"reference numpy port ran in {time.time()-t0:.1f}s")
    name = "reference_ldrain1d.h5" if args.ldrain1d else "reference.h5"
    cio.write_reference_h5(fixtures / name, outputs)
    print(f"wrote {fixtures/name} and {write_npz_twin(fixtures / name)}")


if __name__ == "__main__":
    main()
