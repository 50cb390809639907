# tests/_polar_hat_reference.py
# Plain hat-weight matrix-product forms of the polar-scan lookups
# (ops/polarscan.extract_profiles / warp_to_screen). The engine reads the
# same interpolants as 2-tap gathers; these dense forms weight EVERY
# column with max(0, 1 - |p - j|), which is the textbook definition of
# linear interpolation, and serve as the independent reference the
# gather forms are checked against.

import jax
import jax.numpy as jnp
import numpy as np

_F32 = jnp.float32
_NEG = jnp.float32(-1.0e30)
_HIGHEST = jax.lax.Precision.HIGHEST


def extract_profiles_hat(rotbuf, ps, *, xi=0.0, ja=0.0, chunk: int = 128,
                         precision=_HIGHEST):
    n_v, n_u, C = rotbuf.shape
    K, A = ps.k_count, ps.a_count
    t = ps.t_lo + (jnp.arange(A, dtype=_F32) + 0.5 + ja) * ps.t_step
    src = (1.0 - xi) * jax.lax.dynamic_slice_in_dim(rotbuf, ps.k0 + 1, K, 0) \
        + xi * jax.lax.dynamic_slice_in_dim(rotbuf, ps.k0 + 2, K, 0)
    iota_j = jnp.arange(n_u, dtype=_F32)
    base = ps.k0 + 1.0 - ps.cam_iv

    def do_chunk(args):
        src_c, k_idx = args
        koff = k_idx.astype(_F32) + base + xi
        p = ps.cam_iu + koff[:, None] * t[None, :]          # (kc, A)
        w = jnp.maximum(
            0.0, 1.0 - jnp.abs(p[:, None, :] - iota_j[None, :, None]))
        prof = jnp.einsum("kjc,kja->kac", src_c, w, precision=precision,
                          preferred_element_type=_F32)
        oob = (p < 0.0) | (p > n_u - 1)
        h = jnp.where(oob, _NEG, prof[..., 0])
        return jnp.concatenate([h[..., None], prof[..., 1:]], axis=-1)

    n_chunks = (K + chunk - 1) // chunk
    Kp = n_chunks * chunk
    src_p = jnp.pad(src, ((0, Kp - K), (0, 0), (0, 0)))
    k_ids = jnp.arange(Kp, dtype=jnp.int32).reshape(n_chunks, chunk)
    prof = jax.lax.map(
        do_chunk, (src_p.reshape(n_chunks, chunk, n_u, C), k_ids))
    return prof.reshape(Kp, A, C)[:K]


def warp_to_screen_hat(polar, ps, *, width: int, height: int,
                       supersample: int = 2, row_chunk: int = 32,
                       precision=_HIGHEST):
    E, A, C = polar.shape
    ss = max(int(supersample), 1)
    ndc_rows = 1.0 - (np.arange(E, dtype=np.float64) + 0.5) * ps.y_step
    cv_rows = jnp.asarray(np.maximum(ps.fv + ndc_rows * ps.uvhh, 0.02), _F32)
    sub = (np.arange(ss, dtype=np.float64) + 0.5) / ss
    ndc_x = ((np.arange(width, dtype=np.float64)[:, None] + sub[None, :])
             / width) * 2.0 - 1.0
    ndc_x = jnp.asarray(ndc_x, _F32)
    iota_a = jnp.arange(A, dtype=_F32)

    n_chunks = (E + row_chunk - 1) // row_chunk
    Ep = n_chunks * row_chunk
    pol_p = jnp.pad(polar, ((0, Ep - E), (0, 0), (0, 0)))
    cv_p = jnp.pad(cv_rows, (0, Ep - E), constant_values=1.0)

    def do_chunk(args):
        pol_c, cv_c = args
        tanb = ndc_x[None, :, :] * (ps.hw / cv_c)[:, None, None]
        a_f = (tanb - ps.t_lo) / ps.t_step - 0.5
        a_f = jnp.clip(a_f, 0.0, A - 1.0)
        w = jnp.maximum(
            0.0, 1.0 - jnp.abs(a_f[:, None, :, :]
                               - iota_a[None, :, None, None]))
        w = w.sum(axis=-1) * (1.0 / ss)                    # (R, A, W)
        return jnp.einsum("raw,rac->rwc", w, pol_c, precision=precision,
                          preferred_element_type=_F32)

    out = jax.lax.map(
        do_chunk,
        (pol_p.reshape(n_chunks, row_chunk, A, C),
         cv_p.reshape(n_chunks, row_chunk)))
    out = out.reshape(Ep, width, C)[:E - ps.e_pad]
    return out.reshape(height, ps.row_ss, width, C).mean(axis=1)
