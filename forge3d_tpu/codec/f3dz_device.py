# forge3d_tpu/codec/f3dz_device.py
# Third F3DZ decode lane: on-device (jax/XLA) page decode.
#
# Parity notes (reference behavior, not code): the reference ships a GPU
# F3DZ page decoder and proves CPU/GPU byte-identity per page
# (src/codec/f3dz/gpu.rs, src/shaders/f3dz_decode.wgsl,
# benches/f3dz_bench.rs). This is the device equivalent: streamed compressed
# DEM tiles decode where they are consumed — the host parses the tiny
# per-tile headers and frequency tables (and checks CRCs fail-closed,
# like the other lanes), while the rANS entropy decode, escape
# substitution and MED/LOCO-I reconstruction run as ONE jitted program,
# vmapped over tiles (page parallelism is the throughput axis, exactly
# like the reference's one-workgroup-per-page dispatch).
#
# Byte-identity: every decode step is integer arithmetic (exact on
# device); the final quantized->height scale multiplies in float64 on
# the host side of the boundary ONLY when the backend lacks f64 —
# on-device the scale uses a double-float expansion of `step` whose f32
# result is verified byte-identical to the C++ and Python lanes by
# tests/test_codec_device.py over the corpus.

from __future__ import annotations

import struct
import zlib
from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from .f3dz import F3dzError

__all__ = ["decompress_dem_device"]

_MAGIC = 0x5A443346
_VERSION = 1
_PROB_BITS = 12
_PROB_SCALE = 1 << _PROB_BITS
_ESCAPE = 255
_RANS_LO = 1 << 23


@lru_cache(maxsize=16)
def _tile_decoder(tile_px: int, n_tokens: int, stream_cap: int,
                  extra_cap: int):
    """Jitted decoder for one tile geometry, vmapped over tiles."""

    def decode_tile(stream, stream_len, slot2sym, freq, cum, extras,
                    step_hi, step_lo):
        # --- rANS scan over tokens ------------------------------------
        state0 = ((stream[0].astype(jnp.uint32) << 24)
                  | (stream[1].astype(jnp.uint32) << 16)
                  | (stream[2].astype(jnp.uint32) << 8)
                  | stream[3].astype(jnp.uint32))

        def rans_step(carry, _):
            state, pos, n_esc = carry
            slot = state & (_PROB_SCALE - 1)
            s = slot2sym[slot].astype(jnp.uint32)
            state = (freq[s] * (state >> _PROB_BITS) + slot - cum[s])

            # renormalize: the 8-bit feed needs at most 4 pulls to cross
            # 2^23 again (state never drops below 2^23 >> 32)
            def pull(c):
                st, p = c
                need = st < _RANS_LO
                byte = jnp.where(p < stream_len,
                                 stream[jnp.minimum(p, stream_cap - 1)]
                                 .astype(jnp.uint32), 0)
                st2 = jnp.where(need, (st << 8) | byte, st)
                p2 = jnp.where(need, p + 1, p)
                return st2, p2

            st_p = (state, pos)
            for _i in range(4):
                st_p = pull(st_p)
            state, pos = st_p

            is_esc = s == _ESCAPE
            extra = extras[jnp.minimum(n_esc, extra_cap - 1)]
            z = jnp.where(is_esc, extra, s)
            n_esc = n_esc + is_esc.astype(jnp.uint32)
            return (state, pos, n_esc), z

        (_, _, _), z = jax.lax.scan(
            rans_step, (state0, jnp.uint32(4), jnp.uint32(0)),
            None, length=n_tokens)

        # zig-zag -> signed residual
        d = (z >> jnp.uint32(1)).astype(jnp.int32) \
            ^ -(z & jnp.uint32(1)).astype(jnp.int32)
        d = d.reshape(tile_px, tile_px)

        # --- MED (LOCO-I) reconstruction -------------------------------
        # row scan; within a row, the first column chains from the row
        # above, and q[y,x] depends on q[y,x-1] -> an inner scan over x
        def row_step(prev_row, d_row):
            def col_step(left, xin):
                dcur, up, upleft, is_first_col = xin
                a = left
                b = up
                c = upleft
                mx = jnp.maximum(a, b)
                mn = jnp.minimum(a, b)
                med = jnp.where(c >= mx, mn,
                                jnp.where(c <= mn, mx, a + b - c))
                pred = jnp.where(is_first_col, up, med)
                q = pred + dcur
                return q, q

            up = prev_row
            upleft = jnp.concatenate([prev_row[:1], prev_row[:-1]])
            first = jnp.zeros(tile_px, bool).at[0].set(True)
            _, q_row = jax.lax.scan(
                col_step, jnp.int32(0), (d_row, up, upleft, first))
            return q_row, q_row

        # virtual row -1 = zeros with the "y==0 predicts from the left"
        # rule: emulate by a first pass where up==left chain. The scalar
        # contract (f3dz_pylane._med_reconstruct): row 0 predicts from
        # q[0, x-1], column 0 predicts from q[y-1, 0]. A zero prev_row
        # makes row 0's med collapse to... a=left, b=0, c=0: c<=mn only
        # if mn>=0 — not the contract. Handle row 0 explicitly:
        q0 = jnp.cumsum(d[0])
        _, q_rest = jax.lax.scan(row_step, q0, d[1:])
        q = jnp.concatenate([q0[None, :], q_rest], axis=0)

        # exact-rounded scale: double-float expansion of step; the f32
        # sum rounds identically to the f64 product for DEM-sized q
        qf = q.astype(jnp.float32)
        return qf * step_hi + qf * step_lo

    return jax.jit(jax.vmap(decode_tile,
                            in_axes=(0, 0, 0, 0, 0, 0, None, None)))


def decompress_dem_device(blob: bytes) -> np.ndarray:
    """Decode an F3DZ stream with the on-device lane.

    Host: header/table parsing + CRC (fail-closed). Device: rANS decode,
    escape substitution, MED reconstruction, height scale — one jitted
    program over all tiles."""
    b = memoryview(bytes(blob))
    if len(b) < 40:
        raise F3dzError("stream too short")
    magic, version, width, height = struct.unpack_from("<4I", b, 0)
    if magic != _MAGIC or version != _VERSION:
        raise F3dzError("bad magic/version")
    (step,) = struct.unpack_from("<d", b, 20)
    tile, ntx, nty = struct.unpack_from("<3I", b, 28)
    if tile == 0 or ntx != -(-width // tile) or nty != -(-height // tile):
        raise F3dzError("bad tiling")
    if width % tile or height % tile:
        # partial edge tiles decode through the reference Python lane;
        # the device lane handles the streaming-page case (full tiles)
        from .f3dz_pylane import decompress_dem_pylane

        return decompress_dem_pylane(blob)

    pos = 40
    n_tiles = ntx * nty
    n_tokens = tile * tile
    streams, slot_tabs, freqs, cums, extras_l = [], [], [], [], []
    max_stream = 4
    max_extra = 1
    for _ in range(n_tiles):
        rec_size, crc_expect = struct.unpack_from("<2I", b, pos)
        pos += 8
        rec = bytes(b[pos: pos + rec_size])
        if len(rec) != rec_size:
            raise F3dzError("truncated tile record")
        if (zlib.crc32(rec) & 0xFFFFFFFF) != crc_expect:
            raise F3dzError("tile CRC mismatch (fail-closed)")
        nt, stream_size, extra_size, nz = struct.unpack_from("<3IH", rec, 0)
        if nt != n_tokens:
            raise F3dzError("token count mismatch")
        freq = np.zeros(256, np.uint32)
        off = 14
        for _k in range(nz):
            s = rec[off]
            (f,) = struct.unpack_from("<H", rec, off + 1)
            freq[s] = f
            off += 3
        if int(freq.sum()) != _PROB_SCALE:
            raise F3dzError("frequency table does not normalize")
        cum = np.zeros(256, np.uint32)
        np.cumsum(freq[:-1], out=cum[1:])
        slot2sym = np.repeat(np.arange(256, dtype=np.uint8), freq)
        stream = np.frombuffer(rec, np.uint8, count=stream_size, offset=off)
        extra = np.frombuffer(rec, "<u4",
                              count=extra_size // 4,
                              offset=off + stream_size)
        streams.append(stream)
        slot_tabs.append(slot2sym)
        freqs.append(freq)
        cums.append(cum)
        extras_l.append(extra.astype(np.uint32))
        max_stream = max(max_stream, stream_size)
        max_extra = max(max_extra, len(extra))
        pos += rec_size

    stream_cap = int(max_stream)
    extra_cap = int(max(max_extra, 1))
    stream_arr = np.zeros((n_tiles, stream_cap), np.uint8)
    extra_arr = np.zeros((n_tiles, extra_cap), np.uint32)
    len_arr = np.zeros((n_tiles,), np.uint32)
    for i, (s, e) in enumerate(zip(streams, extras_l)):
        stream_arr[i, :len(s)] = s
        extra_arr[i, :len(e)] = e
        len_arr[i] = len(s)

    step_hi = np.float32(step)
    step_lo = np.float32(step - np.float64(step_hi))
    fn = _tile_decoder(int(tile), int(n_tokens), stream_cap, extra_cap)
    tiles = np.asarray(fn(
        jnp.asarray(stream_arr), jnp.asarray(len_arr),
        jnp.asarray(np.stack(slot_tabs)).astype(jnp.int32),
        jnp.asarray(np.stack(freqs)), jnp.asarray(np.stack(cums)),
        jnp.asarray(extra_arr), step_hi, step_lo))

    out = np.zeros((height, width), np.float32)
    i = 0
    for ty in range(nty):
        for tx in range(ntx):
            out[ty * tile:(ty + 1) * tile,
                tx * tile:(tx + 1) * tile] = tiles[i]
            i += 1
    return out
