"""Sharded-chain correctness on the virtual 8-device CPU mesh.

Boundary exactness (SURVEY.md §5 "hard parts"): the sharded chain must
produce the same audio as the serial chain — off-by-one-sample halo errors
are silent SNR killers, so these tests compare sample counts exactly and
values to float tolerance.
"""

import numpy as np
import jax
import pytest

from tpu_sdr.models import wbfm
from tpu_sdr.parallel import mesh as mesh_mod
from tpu_sdr.parallel.wbfm_sharded import make_sharded_wbfm, sharded_wbfm_apply
from tpu_sdr.utils import synth

# bytes per (station, whole block); must split across sp=4/8 into multiples
# of 8 bytes * decim
N_BYTES = 2 * 6 * 4096 * 8  # 196608 complex samples


def _serial_reference(u8_2d: np.ndarray, config: wbfm.WbfmConfig) -> np.ndarray:
    """Serial audio via ONE direct demodulate_block call per station.

    Deliberately not WbfmStreamer: the sharded chain consumes the whole
    stream in one jitted step, so the reference must too — the streamer
    trims input to its 2*decim*down quantum (the aligned-resampler quantum) and
    would emit fewer samples for these capture lengths."""
    import jax.numpy as jnp

    rows = []
    params = wbfm.make_params(config)
    for row in u8_2d:
        out = wbfm.demodulate_block(
            jnp.asarray(row), wbfm.init_state(config), params, config)
        audio, count = out[0], out[1]
        rows.append(np.asarray(audio)[: int(count)])
    return np.stack(rows)


def _make_input(stations: int) -> np.ndarray:
    rows = []
    for i in range(stations):
        u8, _ = synth.synth_wbfm_u8(
            N_BYTES // 2, capture_rate=1_020_000,
            audio_freq=500.0 * (i + 1), seed=i, noise_std=0.01,
        )
        rows.append(u8)
    return np.stack(rows)


@pytest.mark.parametrize("dp,sp,filter_mode", [
    (1, 8, "boxcar"),
    (2, 4, "boxcar"),
    (1, 8, "fir"),
    (2, 4, "fir"),
])
def test_sharded_matches_serial(dp, sp, filter_mode):
    config = wbfm.WbfmConfig(filter_mode=filter_mode)
    m = mesh_mod.make_mesh(dp=dp, sp=sp)
    chain = make_sharded_wbfm(m, config)

    stations = dp  # one station row per dp shard
    blocks = _make_input(stations)
    audio, counts = sharded_wbfm_apply(chain, blocks)
    got = chain.assemble(audio, counts)

    expected = _serial_reference(blocks, config)

    assert got.shape == expected.shape, (got.shape, expected.shape)
    np.testing.assert_allclose(got, expected, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("filter_mode", ["boxcar", "fir"])
def test_sharded_matches_serial_aligned(filter_mode):
    """Aligned shard sizes (n_out_loc % 85 == 0) take the frame-matmul
    resampler path — verify it against the serial chain too."""
    config = wbfm.WbfmConfig(filter_mode=filter_mode)
    m = mesh_mod.make_mesh(dp=1, sp=8)
    chain = make_sharded_wbfm(m, config)

    n_loc = 2040 * 12  # % 24 == 0 and /6 % 85 == 0
    n_bytes = 2 * n_loc * 8
    u8, _ = synth.synth_wbfm_u8(n_bytes // 2, capture_rate=1_020_000, noise_std=0.01)
    blocks = u8[None, :]
    audio, counts = sharded_wbfm_apply(chain, blocks)
    got = chain.assemble(audio, counts)
    expected = _serial_reference(blocks, config)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dp,sp", [(1, 8), (2, 4)])
def test_sharded_carry_io_streams_across_blocks(dp, sp):
    """carry_io=True: two consecutive blocks, each seeded with the
    previous block's end carries, must match the serial chain streaming
    its WbfmState across the same two blocks (without
    it the XLA sharded chain restarted the stream every block)."""
    import jax.numpy as jnp

    from tpu_sdr.parallel.wbfm_sharded import initial_xla_carry

    config = wbfm.WbfmConfig(filter_mode="fir")
    m = mesh_mod.make_mesh(dp=dp, sp=sp)
    chain = make_sharded_wbfm(m, config, carry_io=True)

    stations = dp
    rng = np.random.default_rng(23)
    # aligned geometry per shard (n_out_loc % 85 == 0) AND two blocks
    n_loc = 2040 * 12
    blocks = [rng.integers(0, 256, (stations, 2 * n_loc * sp),
                           dtype=np.uint8) for _ in range(2)]

    carry = initial_xla_carry(stations, config)
    got_parts = []
    for b in blocks:
        x = jax.device_put(b, chain.in_sharding)
        audio, counts, carry = chain.fn(x, carry)
        got_parts.append(chain.assemble(audio, counts))
    got = np.concatenate(got_parts, axis=1)

    params = wbfm.make_params(config)
    exp_rows = []
    for s in range(stations):
        state = wbfm.init_state(config)
        outs = []
        for b in blocks:
            audio, count, state = wbfm.demodulate_block(
                jnp.asarray(b[s]), state, params, config)
            outs.append(np.asarray(audio)[: int(count)])
        exp_rows.append(np.concatenate(outs))
    expected = np.stack(exp_rows)

    assert got.shape == expected.shape, (got.shape, expected.shape)
    np.testing.assert_allclose(got, expected, rtol=2e-4, atol=2e-4)


def test_counts_partition_total():
    """Per-shard emission counts must sum to the serial total — the
    closed-form ownership rule leaves no gaps or overlaps."""
    config = wbfm.WbfmConfig(filter_mode="boxcar")
    m = mesh_mod.make_mesh(dp=1, sp=8)
    chain = make_sharded_wbfm(m, config)
    blocks = _make_input(1)
    audio, counts = sharded_wbfm_apply(chain, blocks)
    serial = _serial_reference(blocks, config)
    assert int(np.asarray(counts).sum()) == serial.shape[1]


def test_halo_pull_left():
    """pull_left_halo moves each shard's tail to its right neighbor."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_sdr.parallel.halo import pull_left_halo

    m = mesh_mod.make_mesh(dp=1, sp=8)
    n_loc = 16
    x = np.arange(8 * n_loc, dtype=np.float32)

    def f(x_loc):
        return pull_left_halo(x_loc, 3, "sp")

    with m:
        out = jax.jit(jax.shard_map(
            f, mesh=m, in_specs=P("sp"), out_specs=P("sp")
        ))(x)
    out = np.asarray(out).reshape(8, 3)
    np.testing.assert_array_equal(out[0], [0, 0, 0])  # left edge: zeros
    for s in range(1, 8):
        np.testing.assert_array_equal(out[s], x[s * n_loc - 3 : s * n_loc])
