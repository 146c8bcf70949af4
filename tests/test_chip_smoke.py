"""chip_smoke.py's phases at tiny sizes on the CPU, its device check, and
the compile-cache placement.

On the CPU the "card" run and the CPU reference run on the same backend, so
these tests check each phase's plumbing and its comparisons (which must all
pass exactly); the card's numbers come from running chip_smoke.py on it."""
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs
import compv_tpu.device as cdev
from compv_tpu.features.orb import OrbConfig
from compv_tpu.slam.frontend import FrontendConfig

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_ok(items):
    for name, item in items.items():
        assert item.get("exact", True) and item.get("ok", True), name


def test_phase_frontend():
    rec = cs.phase_frontend(
        n_pairs=1, h=240, w=320, reps=1, corner_bar=3.0,
        config=FrontendConfig(orb=OrbConfig(max_features=300, levels=3)))
    _all_ok(rec["checks"])
    assert rec["compile_s"] > 0 and rec["ms_per_call"] > 0


def test_phase_ba():
    recs = cs.phase_ba(n_cams=6, n_lms=120, n_obs=1200, cg=6, reps=1)
    for rec in recs.values():
        _all_ok(rec["checks"])
        assert rec["cost_per_step"][-1] < rec["cost_per_step"][0]


def test_phase_paths():
    recs = cs.phase_paths(h=96, w=128, th=80, tw=112, reps=1)
    assert set(recs) == {"ccl_label", "ccl_boxes", "mser", "hough_sht",
                         "hough_kht"}
    for rec in recs.values():
        _all_ok(rec["checks"])


def test_phase_sfm():
    rec = cs.phase_sfm(n_frames=8, h=240, w=320)
    _all_ok(rec["checks"])


def test_phase_four_cards():
    devs = jax.devices()[:4]
    assert len(devs) == 4
    recs = cs.phase_four_cards(
        devices=devs, n_frames=8, h=64, w=96,
        orb_config=OrbConfig(max_features=48, levels=2), n_cams=6,
        n_lms=80, n_obs=640, cg=4, reps=1)
    _all_ok(recs["orb_match_checks"])
    for mode in ("psum", "reduce_scatter"):
        _all_ok(recs[f"ba_{mode}"]["checks"])
        assert recs[f"ba_{mode}"]["collectives_per_step"]
    assert recs["match_collectives"]["ring"]


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cdev.require_gpu()
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main([])


def test_script_fails_without_gpu():
    """Run as a user would: non-zero exit, and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and '"phase"' not in p.stdout


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_set(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cdev.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # JAX's own


def test_compile_cache_env_unset(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cdev.enable_compile_cache()
    assert path == os.path.join(_ROOT, ".jax_cache") == cdev.CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    assert cdev.enable_compile_cache() == path               # fixed path


@pytest.mark.gpu
def test_paths_on_card(gpu):
    """The integer paths on the card, bit for bit against the CPU."""
    for rec in cs.phase_paths(h=240, w=320, th=240, tw=320, reps=1).values():
        _all_ok(rec["checks"])
