"""Test configuration: run on a virtual 8-device CPU mesh with f64 enabled.

This mirrors the reference's testing stance (single-process MPI stub as the
de-facto parallel fake, SURVEY.md §4): multi-chip logic is exercised on
XLA's forced host-platform device count without real hardware.

Tests marked ``card`` need a GPU. They take the ``gpu`` fixture, which
skips them on any other platform. To run them on the card, set
``PAM_TEST_CARD=1`` (which leaves the platform choice to JAX) and use one
pytest process, since a JAX process reserves most of the card's memory:

    PAM_TEST_CARD=1 python -m pytest tests/ -m card -p no:xdist -q
"""

import os

ON_CARD = os.environ.get("PAM_TEST_CARD") == "1"

if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = \
            flags + " --xla_force_host_platform_device_count=8"

import jax
import pytest

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first device, if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run with PAM_TEST_CARD=1 on the card)")
    return dev


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked slow")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or config.getoption("-m"):
        return
    skip = pytest.mark.skip(reason="slow: use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
