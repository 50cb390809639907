# The polar scan's lookups are 2-tap gathers + lerps
# (forge3d_tpu/ops/polarscan.py extract_profiles / warp_to_screen). They
# must equal the dense hat-weight products (tests/_polar_hat_reference.py,
# the textbook linear interpolant over every column) inside the grid, at
# its edges and outside it, for every radial / azimuth jitter. A jaxpr
# check keeps every matrix product left on the sweep path at an explicit
# precision: on a GPU an unspecified f32 product may run in TF32.

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _polar_hat_reference import extract_profiles_hat, warp_to_screen_hat
from forge3d_tpu.camera import camera_basis
from forge3d_tpu.ops.polarscan import (PolarStatic, extract_profiles,
                                       plan_polar, warp_to_screen)
from forge3d_tpu.ops.sweep import plan_rot_grid, rotate_heights

_N = 65


def _scene(cam_o=(32.0, 25.0, 85.0), look=(32.0, 0.0, 32.0), W=96, H=64):
    yy, xx = np.mgrid[0:_N, 0:_N].astype(np.float32)
    dem = (6.0 * np.sin(xx * 0.15) * np.cos(yy * 0.12)).astype(np.float32)
    right, up_v, fwd = camera_basis(cam_o, look, (0, 1, 0))
    cam_xz = (cam_o[0], cam_o[2])
    rg = plan_rot_grid(_N - 1, _N - 1, origin_xz=(0., 0.),
                       spacing_xz=(1., 1.), cam_xz=cam_xz,
                       fwd_xz=(float(fwd[0]), float(fwd[2])))
    h, _valid, du, dv = rotate_heights(
        jnp.asarray(dem), rg, origin_xz=(0., 0.), spacing_xz=(1., 1.),
        cam_xz=cam_xz, with_derivatives=True)
    ps = plan_polar(width=W, height=H, fov_y_deg=40.0, right=right, up=up_v,
                    fwd=fwd, cam_y=cam_o[1], rg_n_v=rg.n_v, rg_n_u=rg.n_u,
                    rg_spacing=rg.spacing, e_u=rg.e_u, e_v=rg.e_v,
                    cam_iu=rg.cam_iu, cam_iv=rg.cam_iv)
    return jnp.stack([h, du, dv], axis=-1), ps


def _assert_profiles_match(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    # "no terrain" (-1e30 sentinel, or a lerp onto one) agrees as a mask
    nt_got, nt_want = got[..., 0] < -1e20, want[..., 0] < -1e20
    assert np.array_equal(nt_got, nt_want)
    live = np.abs(want) < 1e20
    err = np.abs(got - want)[live]
    assert err.max() <= 1e-5 * max(1.0, np.abs(want[live]).max())


@pytest.mark.parametrize("xi,ja", [(0.0, 0.0), (0.3, -0.4), (0.5, 0.25),
                                   (0.99, 0.49), (0.01, -0.5)])
def test_extract_profiles_gather_equals_hat_product(xi, ja):
    rotbuf, ps = _scene()
    _assert_profiles_match(extract_profiles(rotbuf, ps, xi=xi, ja=ja),
                           extract_profiles_hat(rotbuf, ps, xi=xi, ja=ja))


@pytest.mark.parametrize("cam_o,look", [
    # camera outside the DEM, looking across a corner: many azimuths leave
    # the rotated grid on either side
    ((-30.0, 30.0, 110.0), (40.0, 0.0, 20.0)),
    # camera inside the DEM, wide frustum past both side edges
    ((32.0, 12.0, 40.0), (32.0, 0.0, 0.0)),
])
def test_extract_profiles_out_of_grid_matches_hat(cam_o, look):
    rotbuf, ps = _scene(cam_o=cam_o, look=look)
    prof = extract_profiles(rotbuf, ps, xi=0.6, ja=0.2)
    assert (np.asarray(prof[..., 0]) < -1e20).any(), "no out-of-grid case"
    _assert_profiles_match(prof,
                           extract_profiles_hat(rotbuf, ps, xi=0.6, ja=0.2))


def test_extract_profiles_taps_outside_grid_weigh_nothing():
    # one row, positions straddling both grid edges: a tap beyond the edge
    # contributes zero, exactly like the hat weight
    ps = PolarStatic(
        a_count=5, e_count=8, e_pad=0, row_ss=1, k_count=1, k0=0,
        t_lo=-2.5, t_step=1.0, y_step=0.25, hw=1.0, fy=0.0, uyhh=1.0,
        fv=1.0, uvhh=0.0, cam_y=0.0, e_u=(1.0, 0.0, 0.0),
        e_v=(0.0, 0.0, 1.0), cam_iu=1.5, cam_iv=0.0, spacing=1.0)
    rotbuf = jnp.asarray(np.arange(4 * 4 * 2, dtype=np.float32)
                         .reshape(4, 4, 2) + 1.0)
    got = np.asarray(extract_profiles(rotbuf, ps, xi=0.0, ja=0.0))
    want = np.asarray(extract_profiles_hat(rotbuf, ps, xi=0.0, ja=0.0))
    # p = 1.5 + 1 * t with t = -2, -1, 0, 1, 2 -> p = -0.5 ... 3.5
    assert np.allclose(got[..., 1], want[..., 1], atol=1e-6)
    assert got[0, 0, 0] < -1e20 and got[0, -1, 0] < -1e20


def _smooth_polar(ps, C, phase=0.0):
    # smooth in azimuth, as a converged polar image is; the lerp position
    # itself rounds at f32 ulp, so a rough test image would measure that
    e = np.arange(ps.e_count, dtype=np.float32)[:, None, None]
    a = np.arange(ps.a_count, dtype=np.float32)[None, :, None]
    c = np.arange(C, dtype=np.float32)[None, None, :]
    return jnp.asarray(0.5 + 0.4 * np.sin(0.05 * a + 0.3 * c + phase)
                       * np.cos(0.07 * e))


@pytest.mark.parametrize("supersample", [1, 2, 3])
@pytest.mark.parametrize("C", [3, 5])
def test_warp_to_screen_gather_equals_hat_product(supersample, C):
    _, ps = _scene()
    polar = _smooth_polar(ps, C, phase=0.1 * supersample)
    got = warp_to_screen(polar, ps, width=96, height=64,
                         supersample=supersample)
    want = warp_to_screen_hat(polar, ps, width=96, height=64,
                              supersample=supersample)
    assert got.shape == (64, 96, C)
    assert float(jnp.abs(got - want).max()) <= 1e-5


def test_warp_to_screen_row_supersampled_and_clamped_edges():
    # row_ss = 2 and a polar grid narrower than the frustum: sub-pixel
    # positions clamp to the first / last azimuth column in both forms
    W, H = 40, 12
    ps = PolarStatic(
        a_count=16, e_count=2 * H + 8, e_pad=8, row_ss=2, k_count=8, k0=0,
        t_lo=-0.3, t_step=0.6 / 16, y_step=2.0 / (2 * H), hw=0.5, fy=-0.2,
        uyhh=0.4, fv=0.95, uvhh=0.1, cam_y=10.0, e_u=(1.0, 0.0, 0.0),
        e_v=(0.0, 0.0, 1.0), cam_iu=4.0, cam_iv=-2.0, spacing=1.0)
    polar = _smooth_polar(ps, 4)
    got = warp_to_screen(polar, ps, width=W, height=H, supersample=2)
    want = warp_to_screen_hat(polar, ps, width=W, height=H, supersample=2)
    assert got.shape == (H, W, 4)
    assert float(jnp.abs(got - want).max()) <= 1e-5
    with pytest.raises(ValueError):
        warp_to_screen(polar[:-1], ps, width=W, height=H)


# ---------------------------------------------------------------------------
# explicit precision on every matrix product of the sweep path


def _dot_generals(jaxpr):
    """Every dot_general equation in a (closed) jaxpr, sub-jaxprs included
    (scan / map / cond / pjit bodies)."""
    from jax.extend.core import ClosedJaxpr, Jaxpr

    def walk(j):
        j = j.jaxpr if isinstance(j, ClosedJaxpr) else j
        for eqn in j.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn
            for v in eqn.params.values():
                subs = v if isinstance(v, (list, tuple)) else (v,)
                for s in subs:
                    if isinstance(s, (ClosedJaxpr, Jaxpr)):
                        yield from walk(s)

    return list(walk(jaxpr))


def test_every_sweep_path_dot_states_its_precision():
    from forge3d_tpu.ops.shading import EnvMap
    from forge3d_tpu.pt import terrain_sweep as ts

    n = 33
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    dem = (4.0 * np.sin(xx * 0.2) * np.cos(yy * 0.17)).astype(np.float32)
    _, _, _, _, _, render_all = ts._build_pipeline(
        dem.shape, (1.0, 1.0), 1.0, (16.0, 14.0, 46.0), (16.0, 0.0, 16.0),
        (0.0, 1.0, 0.0), 42.0, 64, 48, 8, 4, -0.55, 315.0, 45.0, True, None)
    hj = jnp.asarray(dem)
    h_rot, _v, du, dv = render_all.rotate_only(hj)
    env = EnvMap(rgb=None, intensity=jnp.float32(0.35))
    f32 = jnp.float32
    jaxpr = jax.make_jaxpr(render_all.from_rot, static_argnums=(10, 11))(
        hj, h_rot, du, dv, env, jnp.ones(3, f32), jnp.ones(3, f32) * 0.6,
        f32(1e-3), f32(1.0), jnp.uint32(7), 2, 2)
    dots = _dot_generals(jaxpr)
    # the sky-bin sum and the first-crossing contraction at least
    assert len(dots) >= 2
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None, f"dot_general without precision: {eqn}"
        if all(v.aval.dtype == jnp.float32 for v in eqn.invars):
            assert all(p == jax.lax.Precision.HIGHEST for p in prec), eqn
