"""Card-only tests: they need a GPU and skip elsewhere (the ``gpu`` marker,
decided in conftest at run time).  ``chip_smoke.py`` runs them on the card
in its own process (phase 7):

    python chip_smoke.py
"""

import pathlib

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


def test_nl_golden_f64_on_device(state):
    """The card runs f64 natively, so the XLA path validates against the
    golden at the reference's own 10 eps64 (validate_mod.F90:285-289)."""
    import jax

    from cloudsc2jax.drivers import run_nl

    assert jax.config.jax_enable_x64
    inputs = state.device_kernel_inputs(state.ngptot, dtype=np.float64)
    out = run_nl(inputs, state.params)
    assert state.validate_device(out, inputs, FIXTURES / "reference.npz",
                                 threshold=10.0, quiet=True)


def test_kernels_match_xla_at_full_width(state):
    """Each compiled kernel against what XLA makes of the plain version on
    identical f32 inputs at 163,840 columns (tools/kernel_ab.py bounds)."""
    from tools import kernel_ab

    inputs = state.device_kernel_inputs(163840, dtype=np.float32)
    for name, (kern, xla, args, pick) in kernel_ab.sweeps(
            state.params, inputs).items():
        errs = kernel_ab.max_rel_errors(pick(kern(*args)), pick(xla(*args)))
        assert max(errs.values()) <= kernel_ab.TOLERANCES[name], (name, errs)
