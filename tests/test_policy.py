"""Route and engine policies, the compile-cache location, and the removed
kernel options."""

import os
import subprocess
import sys

import jax.numpy as jnp
import pytest

import ldpc_decoders_tpu
from ldpc_decoders_tpu.codes import get_code
from ldpc_decoders_tpu.decoders.admm import ADMMDecoder
from ldpc_decoders_tpu.decoders.bp import BPDecoder
from ldpc_decoders_tpu.fountain.lt import LTSimulator
from ldpc_decoders_tpu.harness import RunConfig
from ldpc_decoders_tpu.main import setup_parser
from ldpc_decoders_tpu.ops import perm as perm_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("code_name", ["1200_3_6_ldpc", "margulis"])
@pytest.mark.parametrize("dtype,route", [("float32", "gather"),
                                         ("bfloat16", "incidence")])
def test_bp_auto_route_policy(code_name, dtype, route):
    """perm="auto" resolves to the route measured fastest on the H100 for
    the message dtype (PERF.md "Bring-up on the H100"), and the decoder
    takes it."""
    g = get_code(code_name).graph
    assert perm_ops.auto_bp_perm(g, jnp.dtype(dtype)) == route
    assert BPDecoder(g, "MSA", msg_dtype=jnp.dtype(dtype)).perm == route


def test_bp_auto_route_gathers_beyond_incidence_tables():
    """Codes whose incidence tables would exceed INCIDENCE_MAX_SLOTS
    gather even in bfloat16."""
    from types import SimpleNamespace

    big = SimpleNamespace(n_chk=4000, max_chk_deg=6, n_var=8000,
                          max_var_deg=3)
    assert perm_ops.padded_slots(big) > perm_ops.INCIDENCE_MAX_SLOTS
    assert perm_ops.auto_bp_perm(big, jnp.bfloat16) == "gather"


@pytest.mark.parametrize("code_name", ["1200_3_6_ldpc", "margulis"])
def test_admm_auto_route_policy(code_name):
    assert ADMMDecoder(get_code(code_name).graph).perm == "gather"


def test_lt_auto_engine_is_sparse():
    """engine="auto" is the sparse engine (faster on the H100, native on
    the CPU); the dense engine stays selectable."""
    assert LTSimulator(50, 100, 0.1, 0.5).engine == "sparse"
    assert LTSimulator(50, 100, 0.1, 0.5, engine="dense").engine == "dense"
    with pytest.raises(ValueError):
        LTSimulator(50, 100, 0.1, 0.5, engine="mxu")


def _cache_dir_in_fresh_process(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax, ldpc_decoders_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    return out


def test_compile_cache_follows_env(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX uses it and the package sets
    nothing of its own."""
    want = str(tmp_path / "cache")
    assert _cache_dir_in_fresh_process(want) == [want]


def test_compile_cache_defaults_inside_checkout():
    """Unset: one fixed directory inside the checkout (listed in
    .gitignore)."""
    want = os.path.join(REPO, ".jax_cache")
    assert ldpc_decoders_tpu.CACHE_DIR == want
    assert _cache_dir_in_fresh_process(None) == [want]
    with open(os.path.join(REPO, ".gitignore")) as fp:
        assert ".jax_cache/" in fp.read().split()


@pytest.mark.parametrize("flag", ["--kernel", "--presort"])
def test_removed_kernel_options(flag):
    """The fused-kernel route switch and ADMM presort are gone from the
    CLI and from RunConfig."""
    with pytest.raises(SystemExit):
        setup_parser().parse_args(["bec", "7_4_hamming", "SPA", flag,
                                   "auto"])
    with pytest.raises(TypeError):
        RunConfig("bec", "7_4_hamming", "SPA", **{flag[2:]: "auto"})
