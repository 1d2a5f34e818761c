"""Test configuration: the tests run on the CPU backend with 8 simulated
devices, so multi-device sharding paths run without accelerator hardware
(SURVEY.md section 4's "genuine upgrade the reference lacks"). The GPU
path is checked by ``python chip_smoke.py`` on the card.

jax.config is set here, before any backend initialises, so the choice
holds whatever JAX_PLATFORMS says.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)
