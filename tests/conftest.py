"""Test configuration.

Tests run on CPU with 8 virtual devices (the documented recipe for
validating multi-chip sharding without hardware) and 64-bit floats, the
reference's JPRB precision.  Must run before jax is imported anywhere.

Inside a process that already holds a device (``chip_smoke.py`` runs the
``gpu``-marked tests in its own process, with CLOUDSC2_TESTS_IN_PROCESS
set), the platform is left as that process chose it.
"""

import os
import pathlib

if not os.environ.get("CLOUDSC2_TESTS_IN_PROCESS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not os.environ.get("CLOUDSC2_TESTS_IN_PROCESS"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
from cloudsc2jax.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(scope="session")
def state():
    from cloudsc2jax.state import Cloudsc2State

    return Cloudsc2State.load(FIXTURES / "input.npz")


@pytest.fixture(scope="session")
def inputs(state):
    return state.kernel_inputs()


@pytest.fixture(scope="session")
def reference():
    from cloudsc2jax import io as cio

    return cio.load_reference_h5(FIXTURES / "reference.npz")


@pytest.fixture(scope="session")
def nl_outputs(state, inputs):
    from cloudsc2jax.drivers import run_nl

    return run_nl(inputs, state.params)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` need a GPU: decided here, at run time, never
    while a module is imported."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
