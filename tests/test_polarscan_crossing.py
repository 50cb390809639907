# Property tests for the polar first-crossing synthesis
# (forge3d_tpu/ops/polarscan.py synthesize_polar): the soft cumulative
# indicator must reproduce the exact sub-row crossing lerp, keep the
# hit/miss decision hard, and stay consistent with the per-ray model
# (reference estimator: hybrid_terrain_traversal.wgsl first-hit march).

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from forge3d_tpu.ops.polarscan import PolarStatic, synthesize_polar  # noqa: E402


def _ps(e_count, k_count, *, fy=0.0, uyhh=1.0, fv=1.0, uvhh=0.0):
    """Minimal PolarStatic: with fv=1, uvhh=0 the reduced tangent of row
    e is q = fy + ndc_y * uyhh, linear in ndc — easy to reason about."""
    return PolarStatic(
        a_count=1, e_count=e_count, e_pad=0, row_ss=1, k_count=k_count,
        k0=0, t_lo=0.0, t_step=1.0, y_step=2.0 / e_count, hw=1.0,
        fy=fy, uyhh=uyhh, fv=fv, uvhh=uvhh, cam_y=0.0,
        e_u=(1.0, 0.0, 0.0), e_v=(0.0, 0.0, 1.0), cam_iu=0.0, cam_iv=0.0,
        spacing=1.0)


def _synth(q_prof, values, ps, miss=0.0):
    K, A = q_prof.shape
    C = values.shape[-1]
    miss_v = jnp.full((ps.e_count, A, C), float(miss), jnp.float32)
    return np.asarray(synthesize_polar(
        jnp.asarray(values, jnp.float32), jnp.asarray(q_prof, jnp.float32),
        miss_v, ps))


def test_crossing_lerps_between_straddling_rows():
    # profile tangents rise 0.1 -> 0.9; a ray with Q between two samples
    # must get the exact lerp of their values
    K = 9
    q_prof = np.linspace(0.1, 0.9, K)[:, None]
    values = np.arange(K, dtype=np.float32)[:, None, None] * 10.0
    ps = _ps(e_count=8, k_count=K)
    qs = np.asarray(ps.q_rows())          # row tangents
    out = _synth(q_prof, values, ps)
    for e, q in enumerate(qs):
        if q <= q_prof[0, 0]:
            continue  # hit at/before first sample
        if q > q_prof[-1, 0]:
            assert out[e, 0, 0] == 0.0    # miss
            continue
        k = int(np.searchsorted(q_prof[:, 0], q))
        f = (q - q_prof[k - 1, 0]) / (q_prof[k, 0] - q_prof[k - 1, 0])
        expect = (1 - f) * values[k - 1, 0, 0] + f * values[k, 0, 0]
        assert out[e, 0, 0] == pytest.approx(expect, abs=1e-3), e


def test_hit_miss_decision_is_hard():
    # max profile tangent sits between two row tangents: rows above it
    # miss EXACTLY (full miss value, no partial bleed)
    K = 4
    q_prof = np.array([0.1, 0.2, 0.3, 0.35])[:, None]
    values = np.ones((K, 1, 1), np.float32) * 7.0
    ps = _ps(e_count=16, k_count=K)
    qs = np.asarray(ps.q_rows())
    out = _synth(q_prof, values, ps, miss=-5.0)
    for e, q in enumerate(qs):
        if q > 0.35:
            assert out[e, 0, 0] == pytest.approx(-5.0), (e, q)
        else:
            assert out[e, 0, 0] == pytest.approx(7.0, abs=1e-3), (e, q)


def test_first_crossing_wins_over_later_peaks():
    # two peaks; rays below the first peak's tangent must take values
    # from the first peak's rows, never the higher far peak
    q_prof = np.array([0.0, 0.5, 0.2, 0.1, 0.9])[:, None]
    values = np.array([1, 2, 3, 4, 5], np.float32)[:, None, None]
    ps = _ps(e_count=8, k_count=5)
    qs = np.asarray(ps.q_rows())
    out = _synth(q_prof, values, ps)
    sel = (qs > 0.0) & (qs <= 0.5)
    # crossing between rows 0 and 1 -> lerp of values 1 and 2 only
    assert (out[sel, 0, 0] <= 2.0 + 1e-3).all()
    assert (out[sel, 0, 0] >= 1.0 - 1e-3).all()


def test_flat_runningmax_does_not_divide_by_zero():
    q_prof = np.array([0.3, 0.3, 0.3, 0.3])[:, None]
    values = np.ones((4, 1, 2), np.float32)
    ps = _ps(e_count=8, k_count=4)
    out = _synth(q_prof, values, ps)
    assert np.isfinite(out).all()
