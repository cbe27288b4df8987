"""Bit-exact integer WBFM ops — the conformance path.

These ops reproduce, sample for sample, the integer DSP semantics of the
reference WBFM chain (``/root/reference/examples/simple_fm.rs``):

* fs/4 rotation as the u8 byte map with ``255 - x`` negation
  (simple_fm.rs:276-299),
* stateful boxcar decimator (``low_pass_complex``, simple_fm.rs:337-352),
* quadrature discriminator with exact atan2 on the first sample of every
  block and the integer ``fast_atan2`` on the rest (simple_fm.rs:355-405),
* stateful boxcar audio resampler with fractional-index carry
  (``low_pass_real``, simple_fm.rs:408-426).

They are validated against the golden vectors the reference embeds from the
original C ``rtl_fm`` (simple_fm.rs:461-556).

Unlike the reference — a per-sample mutable loop — every op here is a pure,
jittable function with **static shapes**: streaming state is an explicit
carry pytree and the data-dependent output length is returned as a traced
count next to a padded output array.  That shape discipline is what lets the
whole chain compile once under ``jax.jit`` / ``lax.scan`` and run on the device.

Integer subtleties reproduced exactly:

* Rust ``as i32`` / ``as i16`` casts wrap (two's complement) — modeled with
  ``astype`` on signed ints.
* Rust integer division truncates toward zero — modeled with
  :func:`trunc_div` (``lax.div`` semantics), *not* ``jnp.floor_divide``.
* ``fast_atan2`` multiplies in i64 and wraps the product to i32 *before*
  dividing (simple_fm.rs:397-399).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


def trunc_div(a, b):
    """Integer division truncating toward zero (Rust `/` on i32).

    ``jnp.floor_divide`` rounds toward -inf, which differs on negative
    results; ``lax.div`` has C semantics (truncation), matching Rust.
    """
    return lax.div(a, b)


# ---------------------------------------------------------------------------
# fs/4 rotation (ref simple_fm.rs:276-299)
# ---------------------------------------------------------------------------

def rotate_90_u8(buf: jax.Array) -> jax.Array:
    """Apply the reference's in-place fs/4 spectrum shift on raw u8 I/Q bytes.

    Pattern over each group of 8 bytes (4 complex samples), where negation is
    the u8 map ``255 - x`` (ref simple_fm.rs:284-296)::

        out = [b0, b1, 255-b3, b2, 255-b4, 255-b5, b7, 255-b6]

    i.e. successive complex samples are multiplied by ``[1, j, -1, -j]`` (up
    to the +1 offset that ``255-x`` introduces relative to the signed center
    127).  The length must be a multiple of 8.
    """
    assert buf.dtype == jnp.uint8
    n = buf.shape[0]
    assert n % 8 == 0, "rotate_90_u8 requires a multiple of 8 bytes"
    g = buf.reshape(n // 8, 8)
    neg = 255 - g
    out = jnp.stack(
        [g[:, 0], g[:, 1], neg[:, 3], g[:, 2], neg[:, 4], neg[:, 5], g[:, 7], neg[:, 6]],
        axis=1,
    )
    return out.reshape(n)


def u8_to_complex_i32(buf: jax.Array) -> tuple[jax.Array, jax.Array]:
    """u8 interleaved I/Q -> (re, im) int32 pairs, offset by -127.

    Mirrors the ``*val as i16 - 127`` signed conversion and pairing
    (ref simple_fm.rs:258-259,441-450).
    """
    s = buf.astype(jnp.int32) - 127
    return s[0::2], s[1::2]


# ---------------------------------------------------------------------------
# Boxcar decimator (ref low_pass_complex, simple_fm.rs:337-352)
# ---------------------------------------------------------------------------

class BoxcarState(NamedTuple):
    """Carry of the complex boxcar decimator: partial sum + phase.

    Mirrors ``lp_now``/``prev_index`` (ref simple_fm.rs:234,237).  Invariant:
    ``lp_*`` is the sum of the last ``prev_index`` unconsumed samples, so
    ``prev_index == 0`` implies ``lp_re == lp_im == 0``.
    """

    prev_index: jax.Array  # int32 scalar in [0, downsample)
    lp_re: jax.Array  # int32 scalar
    lp_im: jax.Array  # int32 scalar


def boxcar_init() -> BoxcarState:
    z = jnp.int32(0)
    return BoxcarState(z, z, z)


def boxcar_decimate(
    re: jax.Array, im: jax.Array, state: BoxcarState, downsample: int
) -> tuple[jax.Array, jax.Array, jax.Array, BoxcarState]:
    """Sum groups of ``downsample`` consecutive complex samples, emit one per
    group (no divide — gain = downsample), carrying the partial group across
    block boundaries (ref simple_fm.rs:337-352).

    Returns ``(out_re, out_im, count, new_state)`` where the outputs are
    padded to the static maximum number of groups and only ``out[:count]``
    is valid.

    Vectorization strategy (instead of the reference's per-sample loop): lay
    the carry partial-sum at position 0 of a zero buffer, place the block at
    dynamic offset ``prev_index``, pad to a multiple of ``downsample``, and
    reduce each row of a ``(groups, downsample)`` reshape.  One reshape+sum —
    fully fusable by XLA, no gathers.
    """
    n = re.shape[0]
    d = int(downsample)
    buf_len = n + d - 1
    n_groups = -(-buf_len // d)  # cdiv
    padded_len = n_groups * d

    offset = state.prev_index

    def place(x, carry_sum):
        b = jnp.zeros(padded_len, dtype=jnp.int32).at[0].set(carry_sum)
        b = lax.dynamic_update_slice(b, x, (offset,))
        return b.reshape(n_groups, d).sum(axis=1)

    groups_re = place(re, state.lp_re)
    groups_im = place(im, state.lp_im)

    total = offset + n
    count = total // d
    new_prev = total - count * d
    # Partial sum of the trailing incomplete group (zeros beyond the data, so
    # the row sum at index `count` is exactly the partial sum).
    tail_re = jnp.where(new_prev > 0, groups_re[jnp.minimum(count, n_groups - 1)], 0)
    tail_im = jnp.where(new_prev > 0, groups_im[jnp.minimum(count, n_groups - 1)], 0)

    new_state = BoxcarState(new_prev.astype(jnp.int32), tail_re.astype(jnp.int32), tail_im.astype(jnp.int32))
    return groups_re, groups_im, count.astype(jnp.int32), new_state


# ---------------------------------------------------------------------------
# FM discriminator (ref fm_demod / fast_atan2, simple_fm.rs:355-405)
# ---------------------------------------------------------------------------

class DiscriminatorState(NamedTuple):
    """``demod_pre`` carry: the last complex sample of the previous block
    (ref simple_fm.rs:238,365)."""

    pre_re: jax.Array  # int32 scalar
    pre_im: jax.Array  # int32 scalar


def discriminator_init() -> DiscriminatorState:
    z = jnp.int32(0)
    return DiscriminatorState(z, z)


_PI_SCALE = 1 << 14  # pi == 2^14 in the reference's fixed-point (simple_fm.rs:386)


def fast_atan2_i32(y: jax.Array, x: jax.Array) -> jax.Array:
    """The reference's integer ``fast_atan2`` (simple_fm.rs:383-405), exactly.

    * pi is scaled to 2^14; pi/4 = 4096, 3pi/4 = 12288.
    * The product ``pi4 * (x -/+ yabs)`` is computed in i64 and **wrapped to
      i32 before the division** (``as i32 / denom`` in Rust), then divided
      with truncation toward zero.  The low 32 bits of that i64 product are
      exactly XLA's wrapping i32 product, so i32 operands need no i64 (and
      no x64); wider operands are multiplied wide and truncated.
    * ``(0, 0)`` maps to 0.
    """
    pi4 = jnp.int32(1 << 12)
    pi34 = jnp.int32(3 * (1 << 12))
    yabs = jnp.abs(y)

    num_pos = (pi4 * (x - yabs)).astype(jnp.int32)
    den_pos = x + yabs
    num_neg = (pi4 * (x + yabs)).astype(jnp.int32)
    den_neg = yabs - x

    # Guard zero denominators (only reachable in the x==0,y==0 lane, which is
    # masked to 0 below — but integer div-by-zero must not be emitted).
    one = jnp.int32(1)
    den_pos = jnp.where(den_pos == 0, one, den_pos).astype(jnp.int32)
    den_neg = jnp.where(den_neg == 0, one, den_neg).astype(jnp.int32)

    angle = jnp.where(
        x >= 0,
        pi4 - trunc_div(num_pos, den_pos),
        pi34 - trunc_div(num_neg, den_neg),
    )
    angle = jnp.where(y < 0, -angle, angle)
    return jnp.where((x == 0) & (y == 0), 0, angle).astype(jnp.int32)


def exact_atan2_scaled(y: jax.Array, x: jax.Array) -> jax.Array:
    """``(atan2(im, re) / pi * 2^14) as i32`` (ref simple_fm.rs:370-374).

    Uses float64 when x64 is enabled (bit-exact vs the reference's f64 path);
    degrades to float32 otherwise (the accelerator path runs without x64)
    with sub-LSB error.
    """
    ftype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    ang = jnp.arctan2(y.astype(ftype), x.astype(ftype))
    scaled = ang / jnp.pi * _PI_SCALE
    # Rust `as i32` on a float truncates toward zero.
    return jnp.trunc(scaled).astype(jnp.int32)


def fm_discriminate(
    re: jax.Array,
    im: jax.Array,
    count: jax.Array,
    state: DiscriminatorState,
) -> tuple[jax.Array, jax.Array, DiscriminatorState]:
    """Polar discriminant ``angle(a * conj(b))`` over a block (ref
    simple_fm.rs:355-367).

    The first sample of every block is computed against the carried
    ``demod_pre`` with the *exact* atan2; the rest use ``fast_atan2`` —
    mirroring the reference's per-block special case.  ``count`` is the
    number of valid samples in the padded ``re``/``im`` (the rest is
    ignored); the output is padded alike and the same ``count`` applies.
    """
    b_re = jnp.concatenate([state.pre_re[None], re[:-1]])
    b_im = jnp.concatenate([state.pre_im[None], im[:-1]])
    # a * conj(b): re = ar*br + ai*bi ; im = ai*br - ar*bi  (i32 wrap-mul)
    c_re = re * b_re + im * b_im
    c_im = im * b_re - re * b_im

    out = fast_atan2_i32(c_im, c_re)
    out = out.at[0].set(exact_atan2_scaled(c_im[0], c_re[0]))
    out = out.astype(jnp.int16)  # `pcm as i16` (simple_fm.rs:360-363)

    last = jnp.maximum(count - 1, 0)
    new_state = DiscriminatorState(re[last], im[last])
    return out, count, new_state


# ---------------------------------------------------------------------------
# Boxcar audio resampler (ref low_pass_real, simple_fm.rs:408-426)
# ---------------------------------------------------------------------------

class ResamplerState(NamedTuple):
    """``now_lpr``/``prev_lpr_index`` carry (ref simple_fm.rs:235-236)."""

    now_lpr: jax.Array  # int32 scalar, running sum
    prev_lpr_index: jax.Array  # int32 scalar in [0, rate_out)


def resampler_init() -> ResamplerState:
    z = jnp.int32(0)
    return ResamplerState(z, z)


def boxcar_resample(
    x: jax.Array,
    count: jax.Array,
    state: ResamplerState,
    rate_out: int,
    rate_resample: int,
) -> tuple[jax.Array, jax.Array, ResamplerState]:
    """Square-window resampler ``rate_out -> rate_resample`` with fractional
    index carry (ref simple_fm.rs:408-426).

    The reference accumulates ``slow`` per input sample and emits (sum /
    (fast/slow), truncated) whenever the accumulator crosses ``fast``.
    Emission positions have the closed form::

        e_j = ceil(((j+1)*fast - a) / slow) - 1

    for initial accumulator ``a`` — so the whole op vectorizes as one cumsum
    plus two gathers, no scan.  ``x`` may be padded; only ``x[:count]`` is
    consumed.  Output is padded to the static max; valid length is returned.
    """
    fast = jnp.int32(rate_out)
    slow = jnp.int32(rate_resample)
    n_max = x.shape[0]
    # Static bound on emissions per block.
    m_max = (n_max * rate_resample) // rate_out + 1

    a = state.prev_lpr_index
    x32 = x.astype(jnp.int32)
    # Mask padded tail so the cumulative sum is exact for any traced count.
    idx = jnp.arange(n_max, dtype=jnp.int32)
    x32 = jnp.where(idx < count, x32, 0)
    cs = state.now_lpr + jnp.cumsum(x32)

    total_acc = a + count * slow
    out_count = total_acc // fast
    new_a = total_acc - out_count * fast

    j = jnp.arange(m_max, dtype=jnp.int32)
    # e_j = ceil(((j+1)*fast - a)/slow) - 1 ; numerator > 0 always since a < fast
    e = (((j + 1) * fast - a) + slow - 1) // slow - 1
    e_cl = jnp.clip(e, 0, n_max - 1)
    cs_at_e = cs[e_cl]
    prev_cs = jnp.concatenate([jnp.zeros(1, jnp.int32), cs_at_e[:-1]])
    sums = cs_at_e - prev_cs

    div = jnp.int32(rate_out // rate_resample)
    out = trunc_div(sums, div).astype(jnp.int16)

    last_total = jnp.where(count > 0, cs[jnp.maximum(count - 1, 0)], state.now_lpr)
    consumed = jnp.where(out_count > 0, cs_at_e[jnp.maximum(out_count - 1, 0)], 0)
    new_now = last_total - consumed

    new_state = ResamplerState(new_now.astype(jnp.int32), new_a.astype(jnp.int32))
    return out, out_count.astype(jnp.int32), new_state
