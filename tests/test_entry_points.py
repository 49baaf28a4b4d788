"""Entry-point contracts that hold on the CPU: chip_smoke.py refuses to run
without a GPU, the compile-cache helper honours JAX_COMPILATION_CACHE_DIR,
every contraction of the CRM step is pinned to full precision, and the
standalone config reader agrees with YAML on every shipped config."""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from pam_tpu import compile_cache
from pam_tpu.driver import standalone

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def test_chip_smoke_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PAM_TEST_CARD", None)
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_cache_helper_leaves_env_choice_alone(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_helper_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("micro,sgs", [("kessler", "none"), ("p3", "shoc")])
def test_step_contractions_are_highest_precision(micro, sgs):
    """On a GPU an f32 dot_general at default precision may run in TF32;
    every one in the lowered CRM step must ask for HIGHEST."""
    from pam_tpu.driver.mmf import setup_supercell_mmf
    from pam_tpu.modules import gcm_forcing
    drv, state = setup_supercell_mmf(
        nx=8, ny=1, nz=10, nens=2, xlen=16000.0, micro=micro, sgs=sgs,
        dt_gcm=40.0, dt_crm_phys=20.0, dycore="spam", dtype=jnp.float32)
    state = gcm_forcing.compute_gcm_forcing_tendencies(drv.coupler, state,
                                                       drv.dt_gcm)
    text = jax.jit(drv.crm_phys_step).lower(state).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots, "expected the SI DFTs to lower to dot_general"
    loose = [ln.strip() for ln in dots if "HIGHEST" not in ln]
    assert not loose, loose[:3]


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_yaml(path):
    yaml = pytest.importorskip("yaml")
    cfg = standalone.load_config(path)
    with open(path) as f:
        ref = yaml.safe_load(f)
    assert cfg == ref
    assert {k: type(v) for k, v in cfg.items()} == \
        {k: type(v) for k, v in ref.items()}


@pytest.mark.parametrize("line", ["a:\n", "  b: 1\n", "- c\n", "d 1\n"])
def test_load_config_rejects_other_yaml(tmp_path, line):
    p = tmp_path / "bad.yaml"
    p.write_text("nens: 2\n" + line)
    with pytest.raises(ValueError):
        standalone.load_config(str(p))
