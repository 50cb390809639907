# Device-facing runtime seams: the accelerator probe and capability report
# describe the backend truthfully, the persistent compilation cache lives
# where JAX_COMPILATION_CACHE_DIR says (else at one fixed path in the
# checkout), chip_smoke.py refuses to run without a GPU, the viewer
# launcher refuses to start a second JAX process on a card this process
# already holds, timers wait on their real device outputs, and the sweep's
# frame batch is sized from the device memory limit.

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import forge3d_tpu as f3d
from forge3d_tpu import profiling

REPO = Path(__file__).resolve().parents[1]


def _subprocess_env(**overrides):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "PYTHONPATH")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(overrides)
    return env


# ---------------------------------------------------------------------------
# probe and capabilities


def test_has_gpu_is_false_on_the_cpu_backend():
    assert jax.devices()[0].platform == "cpu"
    assert f3d.has_gpu() is False


def test_capabilities_report_the_cpu_truthfully():
    caps = f3d.capabilities()
    assert caps["platform"] == "cpu"
    assert caps["device_count"] == len(jax.devices())
    assert caps["features"] == {"float64": True, "bfloat16": True}
    # the CPU backend reports no memory statistics
    assert caps["memory"] == {}


def test_gpu_probe_is_the_only_accelerator_probe():
    from forge3d_tpu import device

    assert [n for n in dir(device) if n.startswith("has_")] == ["has_gpu"]


# ---------------------------------------------------------------------------
# persistent compilation cache


def _cache_dir_in_subprocess(env, cwd):
    out = subprocess.run(
        [sys.executable, "-c",
         "import forge3d_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=cwd, capture_output=True, text=True, timeout=120,
        check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_jax_compilation_cache_dir(tmp_path):
    want = str(tmp_path / "cc")
    env = _subprocess_env(JAX_COMPILATION_CACHE_DIR=want,
                          PYTHONPATH=str(REPO))
    assert _cache_dir_in_subprocess(env, tmp_path) == want


def test_compile_cache_defaults_to_a_fixed_path_in_the_checkout(tmp_path):
    env = _subprocess_env(PYTHONPATH=str(REPO))
    got = _cache_dir_in_subprocess(env, tmp_path)
    assert got == str(REPO / "jit_cache")
    # git-ignored by the repository's `*_cache/` rule
    assert "*_cache/" in (REPO / ".gitignore").read_text().splitlines()


# ---------------------------------------------------------------------------
# chip_smoke.py refuses to run without a GPU


def _run_smoke(args, cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_chip_smoke_fails_on_the_cpu(args):
    r = _run_smoke(args, REPO, _subprocess_env())
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke([], tmp_path, _subprocess_env())
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


# ---------------------------------------------------------------------------
# the viewer launcher and the one-process-per-card rule


def test_viewer_probe_sees_no_gpu_on_the_cpu_backend():
    from forge3d_tpu import viewer

    jax.devices()                      # backend initialised
    assert viewer._holds_gpu() is False


@pytest.mark.parametrize("env,opens", [
    ({}, True),
    ({"JAX_PLATFORMS": "cuda"}, True),
    ({"JAX_PLATFORMS": "cuda,cpu"}, True),
    ({"JAX_PLATFORMS": "cpu"}, False),
    ({"XLA_PYTHON_CLIENT_MEM_FRACTION": "0.2"}, False),
])
def test_viewer_child_gpu_rule(env, opens):
    from forge3d_tpu import viewer

    assert viewer._child_may_open_gpu(env) is opens


def _no_popen(*a, **k):
    raise AssertionError("the viewer process must not be started")


def test_viewer_launch_refused_when_this_process_holds_the_gpu(monkeypatch):
    from forge3d_tpu import viewer

    monkeypatch.setattr(viewer, "_holds_gpu", lambda: True)
    monkeypatch.setattr(viewer.subprocess, "Popen", _no_popen)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.delenv("XLA_PYTHON_CLIENT_MEM_FRACTION", raising=False)
    with pytest.raises(viewer.ViewerError, match="device memory"):
        viewer.open_viewer_async(width=64, height=48)


def test_viewer_launch_allowed_off_the_card(monkeypatch):
    from forge3d_tpu import viewer

    class Launched(Exception):
        pass

    def fake_popen(cmd, env=None, **k):
        raise Launched(env["JAX_PLATFORMS"])

    monkeypatch.setattr(viewer, "_holds_gpu", lambda: True)
    monkeypatch.setattr(viewer.subprocess, "Popen", fake_popen)
    with pytest.raises(Launched, match="cpu"):
        viewer.open_viewer_async(width=64, height=48,
                                 env={"JAX_PLATFORMS": "cpu"})


# ---------------------------------------------------------------------------
# timers block on the real outputs and let device errors through


def test_device_sync_returns_ready_outputs():
    x = jax.jit(lambda a: a * 2.0)(jnp.ones((256,)))
    out = profiling.device_sync({"x": x})
    assert out["x"] is x and x.is_ready()


def test_device_sync_lets_errors_through():
    class Broken:
        def block_until_ready(self):
            raise RuntimeError("device fault")

    with pytest.raises(RuntimeError, match="device fault"):
        profiling.device_sync([Broken()])


def test_timer_scope_waits_on_registered_outputs():
    t = profiling.Timer()
    f = jax.jit(lambda a: jnp.cumsum(a))
    with t.scope("work") as s:
        y = s.done(f(jnp.ones((4096,))))
    assert y.is_ready()
    assert t.timings_ms["work"] > 0.0


# ---------------------------------------------------------------------------
# sweep frame batch sized from the device memory limit


def test_device_memory_limit_on_cpu_is_host_memory():
    from forge3d_tpu.pt import terrain_sweep as ts

    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert ts._device_memory_limit() == host


@pytest.mark.parametrize("limit,expect", [(1 << 50, None), (1 << 20, 1)])
def test_sweep_batch_follows_memory_budget(monkeypatch, limit, expect):
    from forge3d_tpu.pt import terrain_sweep as ts

    monkeypatch.setattr(ts, "_device_memory_limit", lambda: limit)
    ts._build_pipeline.cache_clear()
    try:
        frame_fn = ts._build_pipeline(
            (33, 33), (1.0, 1.0), 1.0, (16.0, 14.0, 46.0), (16.0, 0.0, 16.0),
            (0.0, 1.0, 0.0), 42.0, 64, 48, 8, 4, -0.55, 315.0, 45.0, True,
            None)[3]
    finally:
        ts._build_pipeline.cache_clear()
    assert frame_fn.batch_n == (ts.BATCH_CAP if expect is None else expect)


# ---------------------------------------------------------------------------
# chip_smoke's stage comparison, exercised between two CPU devices


def _small_job():
    n = 33
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (4.0 * np.sin(xx * 0.2) * np.cos(yy * 0.17)).astype(np.float32)
    cam = dict(origin=(16.0, 14.0, 46.0), look_at=(16.0, 0.0, 16.0),
               fov_y=42.0)
    return dem, 64, 48, cam


def test_stage_checks_agree_between_two_cpu_devices():
    import chip_smoke

    devs = jax.devices()
    results = chip_smoke.sweep_stage_checks(_small_job(), devs[0], devs[1])
    assert [r["name"] for r in results] == list(chip_smoke.STAGE_TOLERANCES)
    assert all(r["ok"] and r["max_abs"] == 0.0 for r in results)


def test_stage_compare_rejects_a_changed_no_terrain_mask():
    import chip_smoke

    want = np.array([1.0, -1e30, 2.0], np.float32)
    got = np.array([1.0, 5.0, 2.0], np.float32)
    with pytest.raises(chip_smoke.SmokeFailure, match="no-terrain"):
        chip_smoke._compare("profiles", got, want)
    r = chip_smoke._compare("profiles", want * np.float32(1 + 1e-3), want)
    assert not r["ok"] and r["rel_max"] == pytest.approx(1e-3, rel=1e-2)


@pytest.mark.gpu
def test_stage_checks_gpu_against_cpu_backend():
    """The sweep stages on the card match the CPU backend's full-f32
    results (chip_smoke.py's stages phase runs this at full size)."""
    import chip_smoke

    results = chip_smoke.sweep_stage_checks(
        _small_job(), jax.devices("gpu")[0], jax.devices("cpu")[0])
    assert all(r["ok"] for r in results), results
