"""Golden conformance vectors from the original C ``rtl_fm``, and a
plain-Python oracle of the reference's integer receive loop.

The vectors were captured by the reference with ``rtl_fm -f 92.5M -M fm -s
170k -A fast -r 32k -l 0`` and embedded at
/root/reference/examples/simple_fm.rs:461-556.  They are the correctness
oracle for the integer-exact WBFM path: each stage must match bit-for-bit,
on the CPU (tests/test_golden_exact.py) and on the accelerator
(``chip_smoke.py``).
"""

import math

import numpy as np

# Signed input samples (post-rotation, post −127 offset), interleaved I/Q
# (ref simple_fm.rs:481-507).
BUF_SIGNED = [
    71, -33, -7, -29, 19, 9, 6, -1, 24, 11, -5, 9, 12, 5, -5, -28, 33, 24, -5, 17, 8, 6, 9,
    -6, 0, -2, 8, 10, 14, 3, 10, 5, -6, 7, -18, -25, -16, -21, 16, -4, 9, 78, -24, 22, 7,
    18, 17, 14, -7, 3, -7, 9, 12, -13, 3, -8, -22, 1, 1, -6, -8, -8, -5, 1, 2, 18, 3, -22,
    -4, 11, 0, 19, -27, 2, 7, 2, -20, 4, -14, 27, -10, -9, -4, 16, -12, -27, -12, 7, -8,
    16, 6, 45, -32, -35, 9, -68, 42, -37, 3, 14, -25, 6, -10, -9, 9, -10, -7, -12, -3, 10,
    9, 10, -30, -5, 29, -15, -19, -3, 7, -10, 13, -21, 15, 18, 3, -10, 12, 2, -12, -7, -1,
    8, -19, -3, 12, 13, -20, -5, 6, 18, -11, 13, -28, 22, -6, -17, 23, -15, 86, 44, 42, 44,
    -31, 7, 5, 8, -3, -12, 17, 5, 7, -26, 19, 6, -39, 26, 27, -11, -48, -18, 17, -7, 2,
    -18, -18, -11, 9, -6, -12, -24, 11, 23, -23, -23, 0, -21, 7, 6, 5, -12, 6, 2, 12, -7,
    -13, -2, 21, -15, 22, -7, -17, -3, -72, -10, -19, -20, 0, 16, 2, 9, 24, 22, -9, 11, 8,
    24, -35, -6, -1, -9, 13, -2, 7, -3, -31, 10, 32, 14, -19, 10, 2, 26, -12, 7, 4, -16,
    10, 11, 13, -5, -5, 9, -10, 19, 10, -21, -11, -7, 56, -28, -11, 11, -12, -2, 2, 22, 1,
    51, -9, 60, 26, 35, -8, 58, 34, 0, 15, -9, -14, -4, -5, 14, -6, 1, -27, 35, 12, -37,
    -23, 2, 22, -16, -28, 35, 4, -15, -44, -1, 30, -38, 6, 18, -25, 4, -7, 8, -12, -7, -17,
    21, 17, -3, 2, 19, -10, -5, 17, -8, -13, 16, -45, 28, -40, -41, -15, 20, 3, 17, -30,
    -25, 42, 2, -12, -23, 28, -16, -12, -17, 0, -14, -35, 21, -10, -8, -20, -14, -8, -24,
    -18, -32, 3, -9, -16, 6, -16, -1, -8, -28, 4, -12, 1, 1, -10, -24, 21, -5, -6, 15, -16,
    -4, 31, 20, -27, 8, -23, -85, 67, -50, -10, -13, 3, 16, 3, 7, 44, -25, -34, -1, 17,
    -32, 22, -2, 1, 20, 21, -3, 0, 15, -9, -25, 3, -1, -5, -5, -20, -11, -33, 20, -7, 49,
    5, 47, -24, 21, -1, -9, -9, -24, 30, 16, -22, 4, -28, 21, -23, -14, 8, 15, -11, 56,
    -63, 26, 9, -7, -15, 12, -2, 1, -16, -12, 45, 8, -2, 2, -3, 18, -24, -1, -17, -18, -2,
    -7, -2, 32, -3, 10, -3, 28, -8, -23, -1, -43, 34, -9, 9, 29, -23, 5, 4, -8, -11, -2,
    37, -2, 31, 11, 19, -27, -50, -6, -16, 5, -47, -18, -37, -46, 11, 13, -7, 12, 1, -17,
    -17, 2, -1, 10, -2, -16, 4, -1, 20, 12, 15, 27, -15, 5, 8, 28, 29, 42, 24, 8, 20, 14,
    11, 18, 16, -17, -6, -3, 14, -5,
]

# Expected output of low_pass_complex (interleaved I/Q, gain = downsample)
# (ref simple_fm.rs:469-475).
LOWPASS = [
    108, -34, 52, 18, 8, -2, 9, 107, -20, -14, -12, 19, -68, 42, -49, -62, 12, -48, -7,
    -13, 30, -10, -60, 58, 119, 71, 28, -12, -50, -84, 6, -25, -47, -44, 6, 62, -15, 4, -2,
    33, 29, -17, 0, 224, -3, 37, -57, -32, -25, 6, -32, 47, -52, -50, -49, -48, -63, -88,
    -6, -29, 41, -104, 53, -33, -10, -30, -69, 104, -46, 98, -42, 28, -50, 26, 28, -8, 57,
    -23, -146, -40, 5, -10, 81, 124,
]

# Expected output of fm_demod over LOWPASS (ref simple_fm.rs:525-530).
DEMOD_EXPECTED = [
    0, 3489, -3236, 9337, 11916, -8564, 2688, 7340, 4624, -3906, 9406, 13730, -9938, -4746,
    -9153, 4043, -5222, -12548, 7028, -6147, -11481, 11220, 615, 10771, -3940, -3900, 9381,
    76, 1228, 2517, 3241, 3490, -6608, -11786, -1057, 3088, 805, -14996, -783, -12842,
    9551, 11213,
]

# Expected output of low_pass_real over DEMOD_EXPECTED (ref simple_fm.rs:531,548).
RESULT = [2588, 4030, -1212, -3430, 2585, 2110, -6110]


def rotate_90_numpy(buf: np.ndarray) -> np.ndarray:
    """Direct port of the reference byte shuffle (simple_fm.rs:284-296)."""
    buf = buf.copy()
    for i in range(0, len(buf), 8):
        tmp = 255 - buf[i + 3]
        buf[i + 3] = buf[i + 2]
        buf[i + 2] = tmp
        buf[i + 4] = 255 - buf[i + 4]
        buf[i + 5] = 255 - buf[i + 5]
        tmp = 255 - buf[i + 6]
        buf[i + 6] = buf[i + 7]
        buf[i + 7] = tmp
    return buf


def oracle_demodulate(blocks, downsample=6, fast=170_000, slow=32_000):
    """Direct python port of the reference Demod loop (simple_fm.rs:232-426),
    used only as a test oracle."""
    prev_index = 0
    lp_now = [0, 0]
    demod_pre = [0, 0]
    now_lpr = 0
    prev_lpr_index = 0
    audio = []

    def wrap32(v):
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= (1 << 31) else v

    def tdiv(a, b):
        q = abs(a) // abs(b)
        return q if (a >= 0) == (b >= 0) else -q

    def fast_atan2(y, x):
        pi4, pi34 = 1 << 12, 3 * (1 << 12)
        if x == 0 and y == 0:
            return 0
        yabs = abs(y)
        if x >= 0:
            angle = pi4 - tdiv(wrap32(pi4 * (x - yabs)), x + yabs)
        else:
            angle = pi34 - tdiv(wrap32(pi4 * (x + yabs)), yabs - x)
        return -angle if y < 0 else angle

    for block in blocks:
        buf = rotate_90_numpy(np.asarray(block, dtype=np.uint8)).astype(np.int64) - 127
        comp = [(int(buf[i]), int(buf[i + 1])) for i in range(0, len(buf), 2)]
        # low_pass_complex
        lowpassed = []
        for c in comp:
            lp_now[0] += c[0]
            lp_now[1] += c[1]
            prev_index += 1
            if prev_index < downsample:
                continue
            lowpassed.append((lp_now[0], lp_now[1]))
            lp_now = [0, 0]
            prev_index = 0
        if not lowpassed:
            continue
        # fm_demod
        demod = []
        a, b = lowpassed[0], demod_pre
        cr = wrap32(a[0] * b[0] + a[1] * b[1])
        ci = wrap32(a[1] * b[0] - a[0] * b[1])
        ang = math.atan2(ci, cr)
        demod.append(int(ang / math.pi * (1 << 14)))
        for i in range(1, len(lowpassed)):
            a, b = lowpassed[i], lowpassed[i - 1]
            cr = wrap32(a[0] * b[0] + a[1] * b[1])
            ci = wrap32(a[1] * b[0] - a[0] * b[1])
            demod.append(fast_atan2(ci, cr))
        demod_pre = list(lowpassed[-1])
        # low_pass_real
        for v in demod:
            v16 = np.int16(np.int32(v) & 0xFFFF)  # `pcm as i16`
            now_lpr += int(v16)
            prev_lpr_index += slow
            if prev_lpr_index < fast:
                continue
            audio.append(np.int16(np.int32(tdiv(now_lpr, fast // slow)) & 0xFFFF))
            prev_lpr_index -= fast
            now_lpr = 0
    return np.asarray(audio, dtype=np.int16)


def fast_atan2_i32_oracle(y: int, x: int) -> int:
    """Big-integer oracle of the reference's ``fast_atan2``
    (simple_fm.rs:383-405) with its i64-multiply-then-i32-truncate wrap,
    valid at the i32 extremes; the result is wrapped to i32 like the
    kernel's return type."""

    def wrap32(v):
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= (1 << 31) else v

    def tdiv(a, b):
        q = abs(a) // abs(b)
        return q if (a >= 0) == (b >= 0) else -q

    pi4, pi34 = 1 << 12, 3 << 12
    if x == 0 and y == 0:
        return 0
    yabs = abs(y)
    if x >= 0:
        angle = pi4 - tdiv(wrap32(pi4 * wrap32(x - yabs)),
                           wrap32(x + yabs) or 1)
    else:
        angle = pi34 - tdiv(wrap32(pi4 * wrap32(x + yabs)),
                            wrap32(yabs - x) or 1)
    return wrap32(-angle if y < 0 else angle)
