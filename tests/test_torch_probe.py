"""The matrix-unit probe (probes/mma.py) on the CPU: its plain chain
against the same chain in numpy f64, the operand layouts the CUDA kernel
reads, and the wrapper's CPU path.  The kernel itself runs only on the
card (chip_smoke.py, tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from libpll2_tpu_torch.probes import mma


@pytest.mark.parametrize("variant", range(len(mma.VARIANTS)))
def test_chain_reference_matches_numpy(variant):
    """rtol 1e-5 of the largest entry: 32 f32 products summed in another
    order than numpy's f64."""
    a, b = mma.probe_inputs(variant, 64, seed=variant)
    got = mma.chain_reference(a, b, nrep=32)
    a64, b64 = a.double().numpy(), b.double().numpy()
    want = sum(a64 @ b64[j % mma.NBUF] for j in range(32))
    assert got.shape == (mma.VARIANTS[variant][1], 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("unit", mma.UNITS)
def test_wrapper_on_cpu_takes_plain_version(unit):
    a, b = mma.probe_inputs(1, 32)
    before = mma.chain.launches
    got = mma.chain(1, unit, a, b, grid=3, nrep=8)
    assert mma.chain.launches == before and got.shape == (3, 16, 32)
    want = mma.chain_reference(a, b, 8, unit)
    for blk in got:
        np.testing.assert_array_equal(blk.numpy(), want.numpy())
    if unit != "fma":       # rounded inputs give another result than f32
        assert not torch.equal(want, mma.chain_reference(a, b, 8, "fma"))


def test_wrapper_rejects_wrong_inputs():
    a, b = mma.probe_inputs(0, 32)
    with pytest.raises(ValueError, match="unknown unit"):
        mma.chain(0, "fp8", a, b)
    with pytest.raises(ValueError, match="takes A"):
        mma.chain(1, "tf32", a, b)
    with pytest.raises(TypeError, match="f32"):
        mma.chain(0, "tf32", a.double(), b.double())
    with pytest.raises(ValueError, match="CUDA device"):
        mma.chain(0, "tf32", a.to("meta"), b.to("meta"))


def test_round_unit():
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(512)
                        .astype(np.float32))
    assert torch.equal(mma.round_unit(x, "fma"), x)
    tf32, bf16 = mma.round_unit(x, "tf32"), mma.round_unit(x, "bf16")
    assert float(((tf32 - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert float(((bf16 - x).abs() / x.abs()).max()) <= 2.0 ** -8
    assert int((tf32.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((bf16.view(torch.int32) & 0xFFFF).abs().max()) == 0


def _unpack_bf16(words):
    """int32 [...] -> f32 [..., 2]: the low half first."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    halves = torch.stack([w & 0xFFFF, w >> 16], dim=-1)
    return (halves << 16).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("variant", [0, 2, 4])
def test_operand_layouts(variant):
    """Reading the packed operands back by the mma fragment layouts gives
    A and B (rounded to the unit's precision)."""
    _, M, K, _ = mma.VARIANTS[variant]
    tb = 32
    a, b = mma.probe_inputs(variant, tb)
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    at, bf = mma.pack_operands(a, b, "fma")
    assert torch.equal(at, a.t()) and torch.equal(bf, b)

    a_frag, b_tiles = mma.pack_operands(a, b, "tf32")
    ar, br = mma.round_unit(a, "tf32"), mma.round_unit(b, "tf32")
    assert a_frag.shape == (M // 16, K // 8, 32, 4)
    assert b_tiles.shape == (mma.NBUF, tb // 8, K, 8)
    mt, ks = M // 16 - 1, K // 8 - 1
    for reg, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
        np.testing.assert_array_equal(
            a_frag[mt, ks, :, reg].numpy(),
            ar[16 * mt + g + dr, 8 * ks + q + dc].numpy())
    # B fragment of tile 2: b0 at (k = 8 ks + q, site g)
    np.testing.assert_array_equal(
        b_tiles[1, 2, 8 * ks + q, g].numpy(),
        br[1, 8 * ks + q, 16 + g].numpy())

    a_frag, b_tiles = mma.pack_operands(a, b, "bf16")
    ar, br = mma.round_unit(a, "bf16"), mma.round_unit(b, "bf16")
    assert a_frag.shape == (M // 16, K // 16, 32, 4)
    assert b_tiles.shape == (mma.NBUF, tb // 8, K // 2, 8)
    ks = K // 16 - 1
    a_pairs = _unpack_bf16(a_frag)                # [MT, KS, 32, 4, 2]
    for reg, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
        for half in range(2):
            np.testing.assert_array_equal(
                a_pairs[mt, ks, :, reg, half].numpy(),
                ar[16 * mt + g + dr, 16 * ks + 2 * q + dc + half].numpy())
    b_pairs = _unpack_bf16(b_tiles)               # [NBUF, T, K/2, 8, 2]
    for half in range(2):
        np.testing.assert_array_equal(
            b_pairs[0, 3, 8 * ks + q, g, half].numpy(),
            br[0, 16 * ks + 2 * q + half, 24 + g].numpy())


def test_smem_bytes():
    assert mma.smem_bytes(4, "tf32", 128) == mma.NBUF * 192 * 128 * 4
    assert mma.smem_bytes(4, "bf16", 128) == mma.NBUF * 96 * 128 * 4
