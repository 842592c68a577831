"""The probes (probes/mma.py, probes/cache.py, probes/constructs.py) on
the CPU: each plain version against the same sums in numpy f64 and against
the JAX package's Pallas kernel in interpret mode (all three probes, the
construct probe's k0-k3 each); the operand layouts the CUDA kernels read; the wrappers' CPU paths; and the
naming of _build's libraries.  The kernels themselves run only on the card
(chip_smoke.py, tests/test_torch_cuda.py).

Tolerances: the build-cache probe's plain version equals the Pallas kernel
bit for bit (one exact doubling and one rounded addition in both); the
matrix-unit probe's slot 0 is within 1e-5 of the largest entry of
tools/mxu_probe.py's kernel (bf16 products, exact in f32, summed in another
order); the construct probe's plain versions are within 1e-5 of the
largest entry of the same sums in numpy f64 and in the Pallas kernel (bf16
or f32 products, exact in f32, summed in another order)."""
import functools
import hashlib
import importlib.util
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libpll2_tpu_torch import _build
from libpll2_tpu_torch.ops.partials_tree import split_tf32
from libpll2_tpu_torch.probes import cache, constructs, mma

REPO = pathlib.Path(__file__).resolve().parent.parent


def _mxu_probe(monkeypatch, nrep):
    """tools/mxu_probe.py loaded as a module, with NREP = `nrep` and its
    pallas_call in interpret mode.  It reads sys.argv[1] as TB when it is
    imported, and under pytest that is a path."""
    monkeypatch.setattr(sys, "argv", ["mxu_probe.py"])
    spec = importlib.util.spec_from_file_location(
        "mxu_probe", REPO / "tools" / "mxu_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    assert probe.NBUF == mma.NBUF
    probe.NREP = nrep
    probe.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    return probe


@pytest.mark.parametrize("variant", [0, 1, 5, 6, 7])
def test_chain_reference_slot0_is_the_jax_kernel(variant, monkeypatch):
    """tools/mxu_probe.py's kernel (acc[j % NBUF] += one product, out =
    acc[0]) in interpret mode on bf16 inputs, in both orientations, is slot
    0 of chain_reference(unit="bf16"), within 1e-5 of the largest entry;
    the other slots hold other sums."""
    probe = _mxu_probe(monkeypatch, 64)
    var, tb = mma.VARIANTS[variant], 64
    if var.sites_on_m:
        run, _, _ = probe.make_probe(tb, var.k, var.m, True)
    else:
        run, _, _ = probe.make_probe(var.m, var.k, tb, False)
    a, b = mma.probe_inputs(variant, tb, seed=10 + variant, device="cpu")
    c = b.transpose(1, 2) if var.sites_on_m else b
    got = np.asarray(run(jnp.asarray(a.numpy(), jnp.bfloat16),
                         jnp.asarray(c.numpy(), jnp.bfloat16)))
    want = mma.chain_reference(a, b, 64, "bf16", var.sites_on_m).numpy()
    assert got.shape == want.shape[1:]
    scale = np.abs(want[0]).max()
    np.testing.assert_allclose(got, want[0], rtol=0, atol=1e-5 * scale)
    for s in range(1, mma.NBUF):
        assert np.abs(got - want[s]).max() > 0.1 * scale


@pytest.mark.parametrize("variant", range(len(mma.VARIANTS)))
def test_chain_reference_matches_numpy(variant):
    """Every slot, rtol 1e-5 of the slot's largest entry: 8 f32 products
    summed in another order than numpy's f64."""
    var = mma.VARIANTS[variant]
    a, b = mma.probe_inputs(variant, 64, seed=variant, device="cpu")
    got = mma.chain_reference(a, b, nrep=32, sites_on_m=var.sites_on_m)
    a64, b64 = a.double().numpy(), b.double().numpy()
    assert got.shape == ((mma.NBUF, 64, var.m) if var.sites_on_m
                         else (mma.NBUF, var.m, 64))
    for s in range(mma.NBUF):
        one = b64[s].T @ a64 if var.sites_on_m else a64 @ b64[s]
        want = sum(one for j in range(32) if j % mma.NBUF == s)
        np.testing.assert_allclose(got[s].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("unit", mma.UNITS)
def test_wrapper_on_cpu_takes_plain_version(unit):
    for variant in (1, 6):
        if unit not in mma.units_of(variant):
            continue
        var = mma.VARIANTS[variant]
        a, b = mma.probe_inputs(variant, 64, device="cpu")
        before = mma.chain.launches, dict(mma.chain.launches_by_form)
        got = mma.chain(variant, unit, a, b, grid=3, nrep=8)
        assert (mma.chain.launches, mma.chain.launches_by_form) == before
        assert got.shape == (3, mma.NBUF) + ((64, 16) if var.sites_on_m
                                             else (16, 64))
        want = mma.chain_reference(a, b, 8, unit, var.sites_on_m)
        for blk in got:
            np.testing.assert_array_equal(blk.numpy(), want.numpy())
        if unit != "fma":       # rounded inputs give another result than f32
            assert not torch.equal(want, mma.chain_reference(
                a, b, 8, "fma", var.sites_on_m))


def test_wrapper_rejects_wrong_inputs():
    a, b = mma.probe_inputs(0, 32, device="cpu")
    with pytest.raises(ValueError, match="unknown unit"):
        mma.chain(0, "fp8", a, b)
    with pytest.raises(ValueError, match="takes A"):
        mma.chain(1, "tf32", a, b)
    with pytest.raises(TypeError, match="f32"):
        mma.chain(0, "tf32", a.double(), b.double())
    with pytest.raises(ValueError, match="CUDA device"):
        mma.chain(0, "tf32", a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="multiple of 4"):
        mma.chain(0, "tf32", a, b, nrep=6)
    # sites on M: P [K, N], no FFMA form
    a, b = mma.probe_inputs(6, 64, device="cpu")
    assert tuple(a.shape) == (48, 16) and tuple(b.shape) == (4, 48, 64)
    with pytest.raises(ValueError, match="no fma form"):
        mma.chain(6, "fma", a, b)
    with pytest.raises(ValueError, match="takes A"):
        mma.chain(6, "bf16", a.t().contiguous(), b)
    with pytest.raises(ValueError, match="CUDA device"):
        mma.chain(6, "bf16", a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="no fma form"):
        mma.pack_operands(a, b, "fma", sites_on_m=True)


def test_forms_configs_and_bounds():
    """21 rows: FFMA, mma.sync and wgmma where the table of
    csrc/mma_probe.cu's dispatch says, a configuration for each, and the
    bound 2 M K NREP SITES over the unit's peak."""
    rows = [(v, u) for v in range(len(mma.VARIANTS)) for u in mma.units_of(v)]
    assert len(rows) == 21 and set(rows) == set(mma.CONFIGS)
    forms = [mma.form(v, u) for v, u in rows]
    assert forms.count("ffma") == 5 and forms.count("mma_sync") == 10
    assert [r for r, f in zip(rows, forms) if f == "wgmma"] == [
        (5, "tf32"), (5, "bf16"), (6, "tf32"), (6, "bf16"), (7, "tf32"),
        (7, "bf16")]
    assert [v.name.split()[0] for v in mma.VARIANTS] == [
        "span16", "stacked3", "span80", "pack2", "pack4", "t_span16",
        "t_stacked3", "t_span80"]
    assert set(mma.chain.launches_by_form) == set(mma.FORMS)
    # mma.sync fragments held in registers only where a lane holds <= 48
    for (v, u), c in mma.CONFIGS.items():
        var = mma.VARIANTS[v]
        assert mma.NBUF % c.slots == 0
        tb = mma.site_block(v, u, 128, 232448)
        assert mma.threads(v, u, tb) <= mma.MAX_THREADS, (v, u)
        if mma.form(v, u) == "mma_sync":
            assert var.m // 16 % c.groups == 0 and c.warp_tiles in (2, 4)
            words = (var.m // 16 // c.groups * var.k
                     // (16 if u == "bf16" else 8) * 4)
            assert (c.a_source == "regs") == (words <= 48), (v, u)
        if mma.form(v, u) == "ffma":
            assert var.m // c.groups % 4 == 0
    assert mma.bound_ms(2, "fma") == pytest.approx(
        2 * 80 * 80 * 512 * 65536 / 67e12 * 1e3)
    assert mma.bound_ms(7, "bf16") == pytest.approx(
        2 * 80 * 80 * 512 * 65536 / 989e12 * 1e3)


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
    M, K = mma.VARIANTS[variant].m, mma.VARIANTS[variant].k
    tb = 32
    a, b = mma.probe_inputs(variant, tb, device="cpu")
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
    """The site buffers, plus A (P) where it is staged: what the C entry
    mma_probe_smem returns (held equal on the card)."""
    nb = mma.NBUF
    assert mma.smem_bytes(4, "tf32", 128) == nb * 192 * 128 * 4
    assert mma.smem_bytes(4, "bf16", 128) == nb * 96 * 128 * 4 + 64 * 192 * 2
    assert mma.smem_bytes(0, "tf32", 128) == nb * 16 * 128 * 4
    assert mma.smem_bytes(2, "fma", 128) == nb * 80 * 128 * 4 + 80 * 80 * 4
    assert mma.smem_bytes(7, "tf32", 128) == nb * 80 * 128 * 4 + 80 * 80 * 4
    assert mma.smem_bytes(6, "bf16", 64) == nb * 48 * 64 * 2 + 48 * 16 * 2
    with pytest.raises(ValueError, match="no fma form"):
        mma.smem_bytes(5, "fma", 128)
    # the H100's 232,448-byte limit: pack4 runs at TB 64 in f32 and TF32
    # (196,608 bytes), every other row at TB 128
    limit = 232448
    blocks = {(v, u): mma.site_block(v, u, 128, limit)
              for v, u in mma.CONFIGS}
    assert {k for k, tb in blocks.items() if tb != 128} == {
        (4, "fma"), (4, "tf32")}
    assert blocks[(4, "fma")] == 64
    assert mma.smem_bytes(4, "fma", 64) == 196608
    assert all(mma.smem_bytes(v, u, tb) <= limit
               for (v, u), tb in blocks.items())
    assert mma.threads(2, "fma", 128) == 256
    assert mma.threads(7, "bf16", 128) == 256
    assert mma.threads(1, "tf32", 128) == 128
    assert mma.threads(2, "tf32", 128) == 256       # 2 tiles a warp
    assert mma.threads(4, "tf32", 64) == 256        # 4 warps share sites


@pytest.mark.parametrize("unit", ["tf32", "bf16"])
@pytest.mark.parametrize("variant", [5, 6, 7])
def test_wgmma_core_matrix_packing(variant, unit):
    """The wgmma operands against a numpy re-index: site (row) r and k of
    B[j]^T at core matrix (r / 8, k / E), row r % 8, element k % E (E = 16
    bytes: 4 TF32, 8 bf16), and P^T the same with n for r; values rounded
    to the unit."""
    var, tb = mma.VARIANTS[variant], 128
    a, b = mma.probe_inputs(variant, tb, seed=3, device="cpu")
    p_cm, s_cm = mma.pack_operands(a, b, unit, sites_on_m=True)
    e = 8 if unit == "bf16" else 4
    assert s_cm.shape == (mma.NBUF, tb // 8, var.k // e, 8, e)
    assert p_cm.shape == (var.m // 8, var.k // e, 8, e)
    assert s_cm.element_size() * e == 16 and s_cm.is_contiguous()
    flat_s = s_cm.float().flatten().numpy()
    flat_p = p_cm.float().flatten().numpy()
    br = mma.round_unit(b, unit).numpy()
    ar = mma.round_unit(a, unit).numpy()
    buf, site, k = np.meshgrid(np.arange(mma.NBUF), np.arange(tb),
                               np.arange(var.k), indexing="ij")
    kc = var.k // e
    off = (((buf * (tb // 8) + site // 8) * kc + k // e) * 8
           + site % 8) * e + k % e
    np.testing.assert_array_equal(flat_s[off], br[buf, k, site])
    n, k = np.meshgrid(np.arange(var.m), np.arange(var.k), indexing="ij")
    off = ((n // 8 * kc + k // e) * 8 + n % 8) * e + k % e
    np.testing.assert_array_equal(flat_p[off], ar[k, n])
    # the bytes of one 32-byte k-step of a row: two core-matrix columns
    # 128 bytes apart (the descriptors' leading byte offset)
    row = s_cm[0].reshape(-1).view(torch.uint8).numpy()
    step = row[: 2 * 128].reshape(2, 8, 16)[:, 0].reshape(-1)
    first = torch.as_tensor(np.ascontiguousarray(
        br[0, : 32 // s_cm.element_size(), 0]))
    if unit == "bf16":
        first = first.to(torch.bfloat16)
    np.testing.assert_array_equal(step, first.view(torch.uint8).numpy())


# ---- the build-cache probe (probes/cache.py) -----------------------------


def test_scale_shift_reference_equals_pallas_kernel():
    """tools/cacheprobe.py's kernel, rebuilt here (it lives in a string
    there), in interpret mode on the same numpy input: exact equality."""
    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0 + 1.0

    x = cache.probe_input(seed=3, device="cpu")
    assert x.shape == cache.SHAPE and x.dtype == torch.float32
    want = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(jnp.asarray(x.numpy()))
    got = cache.scale_shift_reference(x)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert "x_ref[...] * 2.0 + 1.0" in (REPO / "tools" /
                                         "cacheprobe.py").read_text()


def test_scale_shift_on_cpu_takes_plain_version():
    x = cache.probe_input(device="cpu")
    before = cache.scale_shift.launches
    got = cache.scale_shift(x)
    assert cache.scale_shift.launches == before
    assert torch.equal(got, cache.scale_shift_reference(x))
    assert cache.digest(got) == hashlib.sha256(
        (x.numpy() * 2 + 1).astype(np.float32).tobytes()).hexdigest()
    with pytest.raises(TypeError, match="f32"):
        cache.scale_shift(x.double())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cache.scale_shift(x.to("meta"))


def test_library_path_follows_sources_and_directories(tmp_path):
    """The digest and path logic of _build (no nvcc needed): the name
    changes with one source byte, the place with the build directory."""
    default = _build.library_path()
    assert default.parent == _build.BUILD_DIR.resolve()
    assert default == _build.library_path(_build.BUILD_DIR,
                                          str(_build.SOURCE_DIR))
    moved = _build.library_path(tmp_path / "b")
    assert moved.parent == (tmp_path / "b").resolve()
    assert moved.name == default.name
    edited = cache.edited_copy(_build.SOURCE_DIR, tmp_path / "csrc")
    assert sorted(f.name for f in edited.iterdir()) == \
        sorted(_build.SOURCE_NAMES + _build.HEADER_NAMES)
    a = _build.library_path(tmp_path / "b", edited)
    assert a.parent == moved.parent and a.name != moved.name
    again = (edited / "cache_probe.cu").read_bytes()
    (edited / "cache_probe.cu").write_bytes(again[:-1])     # edit undone
    assert _build.library_path(tmp_path / "b", edited).name == moved.name
    assert _build.SOURCES == tuple(_build.SOURCE_DIR / n
                                   for n in _build.SOURCE_NAMES)
    assert {"cache_probe.cu", "construct_probe.cu"} <= set(
        _build.SOURCE_NAMES)


def test_library_path_follows_headers(tmp_path):
    """A header the sources include is hashed with them: one byte more in
    it renames the library, and undoing the edit restores the name."""
    import shutil
    src = tmp_path / "csrc"
    shutil.copytree(_build.SOURCE_DIR, src)
    name = _build.library_path(tmp_path / "b", src).name
    for header in _build.HEADER_NAMES:
        text = (src / header).read_bytes()
        assert b"#pragma once" in text
        (src / header).write_bytes(text + b"\n")
        assert _build.library_path(tmp_path / "b", src).name != name
        (src / header).write_bytes(text)
        assert _build.library_path(tmp_path / "b", src).name == name


def test_build_keys_on_its_directories(tmp_path, monkeypatch):
    """build() with no nvcc in reach: an existing library is a cache hit
    (0.0 s) per pair of directories; a missing one raises."""
    hit = _build.library_path(tmp_path / "hit")
    hit.parent.mkdir()
    hit.write_bytes(b"")
    info = _build.build(tmp_path / "hit")
    assert info.path == hit and info.seconds == 0.0
    assert _build.build(str(tmp_path / "hit")) is info
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(tmp_path / "miss")


def test_without_nvcc_drops_the_compiler(tmp_path):
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text("")
    env = cache._without_nvcc(
        {"PATH": f"{tmp_path / 'bin'}:/usr/bin", "HOME": "/h"},
        str(tmp_path / "empty"))
    assert env == {"PATH": "/usr/bin", "HOME": "/h",
                   "CUDA_HOME": str(tmp_path / "empty")}


# ---- the construct probe (probes/constructs.py) --------------------------


def _numpy_sum(p, pool, n_ops, gathered):
    p64, pool64 = p.double().numpy(), pool.double().numpy()
    return sum(p64[(w * 7) % 64 if gathered else 0] @ pool64[w % 8]
               for w in range(n_ops))


@pytest.mark.parametrize("variant", ["c0", "c1", "c2"])
def test_constructs_reference_matches_numpy(variant):
    p, pool = constructs.probe_inputs(64, seed=1, device="cpu")
    got, scal = constructs.constructs_reference(variant, p, pool, 40)
    want = _numpy_sum(p, pool, 40, gathered=variant == "c2")
    assert got.shape == (16, 64) and int(scal.abs().max()) == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_constructs_reference_c3_chain_with_rescue():
    """The chain in numpy f64 with the same rescue rule; a site whose
    decision sits at the threshold may flip, so compare after undoing the
    scalers' difference."""
    p, pool = constructs.probe_inputs(64, seed=2, device="cpu")
    n_ops = 100
    got, scal = constructs.constructs_reference("c3", p, pool, n_ops)
    x = pool[0].double().numpy()
    want_s = np.zeros(64, np.int64)
    for w in range(n_ops):
        y = p[(w * 7) % 64].double().numpy() @ x
        below = y.max(axis=0) < constructs.THRESH
        x = np.where(below, y * constructs.FACTOR, y)
        want_s += below
    assert int(scal.max()) >= 2                   # the rescue did fire
    err, mismatches = constructs.site_error(
        (got, scal), (torch.as_tensor(x), torch.as_tensor(want_s)))
    assert err <= 1e-5 and mismatches <= 2
    assert float(got.max()) < 1.0 and float(got.amax(0).min()) >= 2.0 ** -30


def test_constructs_reference_c4_is_the_c3_chain():
    """c4 is c3 with the parent carried in registers: one chain, one plain
    version, bit for bit."""
    p, pool = constructs.probe_inputs(64, seed=3, device="cpu")
    a = constructs.constructs_reference("c3", p, pool, 70)
    b = constructs.constructs_reference("c4", p, pool, 70)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(a[1].max()) >= 1
    assert constructs.tolerance("c4", 128) == constructs.tolerance("c3", 128)
    assert constructs.VARIANTS[-1] == "c4"


def test_c4_shuffle_schedule_turns_a_c_fragment_into_b_fragments():
    """The four shuffles csrc/construct_probe.cu:carry_tile makes per tile,
    emulated lane by lane: from the C-fragment layout of a 16 x 8 parent
    tile (lane 4g + q: rows g, g + 8 at sites 2q, 2q + 1) to the B-fragment
    layout of the next product (lane 4g + q: rows 8ks + 4h + q at site g).
    In step s the lanes with g < 4 offer registers 0, 2, 1, 3 and the
    others 1, 3, 0, 2; a lane reads steps 0, 1 from lane
    4 (4 (g & 1) + q) + g / 2 and steps 2, 3 from 4 (4 (1 - (g & 1)) + q)
    + g / 2."""
    tile = np.arange(128).reshape(16, 8)
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    y = np.array([[tile[g, 2 * q], tile[g, 2 * q + 1], tile[g + 8, 2 * q],
                   tile[g + 8, 2 * q + 1]] for g, q in lanes])
    upper = np.array([g >= 4 for g, _ in lanes])
    e = np.array([g & 1 for g, _ in lanes])
    same = np.array([4 * (4 * (g & 1) + q) + (g >> 1) for g, q in lanes])
    other = np.array([4 * (4 * (1 - (g & 1)) + q) + (g >> 1)
                      for g, q in lanes])
    r0 = np.where(upper, y[:, 1], y[:, 0])[same]
    r1 = np.where(upper, y[:, 3], y[:, 2])[same]
    r2 = np.where(upper, y[:, 0], y[:, 1])[other]
    r3 = np.where(upper, y[:, 2], y[:, 3])[other]
    b = np.empty((32, 2, 2), dtype=tile.dtype)
    b[:, 0, 0], b[:, 0, 1] = np.where(e, r2, r0), np.where(e, r0, r2)
    b[:, 1, 0], b[:, 1, 1] = np.where(e, r3, r1), np.where(e, r1, r3)
    for lane, (g, q) in enumerate(lanes):
        for ks in range(2):
            for h in range(2):
                assert b[lane, ks, h] == tile[8 * ks + 4 * h + q, g]


def test_constructs_reference_matches_static2probe_k0():
    """tools/static2probe.py's k0 (one product per op, gathered pm) in
    interpret mode is the sum c2's plain version computes, on the bf16
    operands it takes (exact in f32)."""
    spec = importlib.util.spec_from_file_location(
        "static2probe", REPO / "tools" / "static2probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    assert (probe.SPAN, probe.P_ROWS) == (constructs.SPAN,
                                          constructs.P_ROWS)
    rng = np.random.default_rng(4)
    n_ops, tb = 24, 32
    pcm = jnp.asarray(rng.random((64, 16, 96)), jnp.bfloat16)
    pool = jnp.asarray(rng.random((8, 48, tb)), jnp.bfloat16)
    want = pl.pallas_call(
        probe.make_kernel("k0", n_ops),
        out_shape=jax.ShapeDtypeStruct((16, tb), jnp.float32),
        interpret=True)(pcm, pool)
    p32 = torch.as_tensor(np.array(pcm[:, :, :16].astype(jnp.float32)))
    pool32 = torch.as_tensor(np.array(pool[:, :16].astype(jnp.float32)))
    got, _ = constructs.constructs_reference("c2", p32, pool32, n_ops)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("variant", constructs.VARIANTS)
def test_constructs_on_cpu_takes_plain_version(variant):
    p, pool = constructs.probe_inputs(32, device="cpu")
    before = constructs.constructs.launches
    out, scal = constructs.constructs(variant, p, pool, n_ops=9, grid=3)
    assert constructs.constructs.launches == before
    assert out.shape == (3, 16, 32) and scal.shape == (3, 32)
    want, want_s = constructs.constructs_reference(variant, p, pool, 9)
    for blk, s in zip(out, scal):
        assert torch.equal(blk, want) and torch.equal(s, want_s)


def test_constructs_rejects_wrong_inputs():
    p, pool = constructs.probe_inputs(32, device="cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        constructs.constructs("c5", p, pool)
    with pytest.raises(ValueError, match="takes P"):
        constructs.constructs("c0", p[:, :8], pool)
    with pytest.raises(TypeError, match="f32"):
        constructs.constructs("c0", p.double(), pool.double())
    with pytest.raises(ValueError, match="CUDA device"):
        constructs.constructs("c0", p.to("meta"), pool.to("meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        constructs.launch_packed("c0", *constructs.pack_operands(p, pool),
                                 4, 1)
    assert constructs.tolerance("c0", 128) == pytest.approx(
        constructs.C0_TOL + 128 * 1.5e-7)
    assert constructs.tolerance("c2", 128) == pytest.approx(2e-5 + 128 * 4e-7)
    assert constructs.tolerance("c3", 128) == pytest.approx(2e-5 + 128 * 1.5e-7)


def test_constructs_operand_layouts():
    """Reading the packed operands back by the mma fragment layouts gives
    P (head and remainder) and the pool, and the products of those
    fragments give the plain version's sum."""
    tb = 32
    p, pool = constructs.probe_inputs(tb, device="cpu")
    pfrag, tiled = constructs.pack_operands(p, pool)
    assert pfrag.shape == (64, 2, 2, 32, 4) and tiled.shape == (8, 4, 16, 8)
    hi, lo = split_tf32(p)
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    for ks in range(2):
        for reg, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
            for h, part in enumerate((hi, lo)):
                np.testing.assert_array_equal(
                    pfrag[37, ks, h, :, reg].numpy(),
                    part[37, g + dr, 8 * ks + q + dc].numpy())
        # B fragment of tile 3, slot 5: b0 at (k = 8 ks + q, site g)
        np.testing.assert_array_equal(
            tiled[5, 3, 8 * ks + q, g].numpy(),
            pool[5, 8 * ks + q, 24 + g].numpy())
    # rebuild A and B from the fragments and redo c2's sum
    a = torch.zeros((64, 16, 16))
    for ks in range(2):
        for reg, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
            a[:, g + dr, 8 * ks + q + dc] = pfrag[:, ks, :, :, reg].sum(1)
    b = tiled.permute(0, 2, 1, 3).reshape(8, 16, tb)
    got, _ = constructs.constructs_reference("c2", a, b, 16)
    want, _ = constructs.constructs_reference("c2", p, pool, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


# ---- k0-k3: tools/static2probe.py's function ------------------------------


def _static2probe():
    spec = importlib.util.spec_from_file_location(
        "static2probe", REPO / "tools" / "static2probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


@pytest.mark.parametrize("variant", constructs.K_VARIANTS)
def test_static2_reference_matches_static2probe(variant):
    """tools/static2probe.py's kernel `variant` in interpret mode and
    static2_reference on the same bf16 inputs (tb = 64, 24 ops): within
    1e-5 of the largest entry (bf16 products are exact in f32; the sums
    differ in order only)."""
    probe = _static2probe()
    assert (probe.SPAN, probe.P_ROWS) == (constructs.SPAN, constructs.P_ROWS)
    n_ops, tb = 24, 64
    pcm, pool = constructs.static2_inputs(tb, seed=4, device="cpu")
    want = np.asarray(pl.pallas_call(
        probe.make_kernel(variant, n_ops),
        out_shape=jax.ShapeDtypeStruct((16, tb), jnp.float32),
        interpret=True)(jnp.asarray(pcm.float().numpy(), jnp.bfloat16),
                        jnp.asarray(pool.float().numpy(), jnp.bfloat16)))
    got = constructs.static2_reference(variant, pcm, pool, n_ops)
    assert got.dtype == torch.float32 and got.shape == (16, tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_static2_inputs_are_the_jax_probes():
    """Uniform in [0, 1) and bf16, at the JAX probe's shapes."""
    probe = _static2probe()
    pcm, pool = constructs.static2_inputs(128, seed=0, device="cpu")
    assert pcm.dtype == pool.dtype == torch.bfloat16
    assert pcm.shape == (probe.P_ROWS, probe.SPAN, constructs.PCM_COLS)
    assert pool.shape == (8, 3 * probe.SPAN, 128)
    assert float(pool.min()) >= 0.0 and float(pool.max()) <= 1.0
    again = constructs.static2_inputs(128, seed=0, device="cpu")
    assert torch.equal(pcm, again[0]) and torch.equal(pool, again[1])


def _wgmma_b(b_cm, row_bytes, kc, row, col):
    """The 16 x 16 B operand ([k, n]) a K-major descriptor without swizzle
    reads at pcm row `row`, column `col`, from the staged bytes: core
    matrix (n / 8, k / 8) at start + (n / 8) SBO + (k / 8) LBO, LBO 128,
    SBO kc x 128, element (n % 8, k % 8) 16 (n % 8) + 2 (k % 8) into it."""
    raw = b_cm.contiguous().view(torch.int16).numpy().reshape(-1).view(
        np.uint8)
    start = row * row_bytes + 16 * col
    k, n = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    off = (start + (n // 8) * kc * 128 + (k // 8) * 128 + (n % 8) * 16
           + (k % 8) * 2)
    lo, hi = raw[off].astype(np.uint32), raw[off + 1].astype(np.uint32)
    return ((hi << 8 | lo) << 16).view(np.float32)


def _wgmma_a(a_frag, tile, slot, ks):
    """The 64 x 16 A operand ([site, k]) of k-step `ks` that the
    warpgroup's registers hold, read back by the wgmma A layout: warp w,
    lane (g, q), register r: site 16 w + g + 8 (r & 1), k = 2 q + 8 (r >> 1)
    and k + 1, the lower k in the low half of the word."""
    words = a_frag[tile, slot, ks].numpy().view(np.uint32)   # [4, 32, 4]
    a = np.zeros((64, 16), np.float32)
    for w in range(4):
        for lane in range(32):
            g, q = lane // 4, lane % 4
            for r in range(4):
                word = words[w, lane, r]
                site, k = 16 * w + g + 8 * (r & 1), 2 * q + 8 * (r >> 1)
                a[site, k] = np.array(word << 16, np.uint32).view(np.float32)
                a[site, k + 1] = np.array(word & 0xFFFF0000,
                                          np.uint32).view(np.float32)
    return a


@pytest.mark.parametrize("variant", constructs.K_VARIANTS)
def test_static2_operand_layouts(variant):
    """pack_static2's operands read back as the kernel reads them (A from
    each thread's fragment registers, B through the descriptors at the
    column and row offsets csrc/construct_probe.cu:static2_op gives each
    product), and the kernel's products redone from them in its order:
    the plain version's sum, within 1e-5 of the largest entry."""
    sites, n_ops = 128, 19
    pcm, pool = constructs.static2_inputs(sites, seed=5, device="cpu")
    b_cm, a_frag = constructs.pack_static2(variant, pcm, pool)
    k, rows, cols = constructs.static2_shape(variant)
    assert b_cm.dtype == torch.bfloat16 and a_frag.dtype == torch.int32
    assert b_cm.shape == (rows, 2, cols // 8, 8, 8) and b_cm.is_contiguous()
    assert a_frag.shape == (sites // 64, 8, k // 16, 4, 32, 4)
    assert a_frag.is_contiguous()
    kc, row_bytes = cols // 8, 2 * (cols // 8) * 128
    assert b_cm.numel() * 2 + 16 * cols * 2 == \
        constructs.static2_smem_bytes(variant)
    # A of every tile, slot and k-step is the pool's tile
    pool32 = pool.float().numpy()
    for tile in range(sites // 64):
        for slot in range(8):
            for ks in range(k // 16):
                np.testing.assert_array_equal(
                    _wgmma_a(a_frag, tile, slot, ks),
                    pool32[slot, 16 * ks:16 * ks + 16,
                           64 * tile:64 * tile + 64].T)
    # the products in the kernel's order: (k-step of A, column of B)
    steps = ([(0, 0)] if variant == "k0" else
             [(0, 0), (1, 16), (2, 32)] if variant == "k1" else
             [(0, 0), (0, 16), (1, 32), (0, 48), (1, 64), (2, 80)])
    acc = np.zeros((sites, 16), np.float64)
    for w in range(n_ops):
        pm = 0 if variant == "k2" else (7 * w) % 64
        for ks, col in steps:
            b = _wgmma_b(b_cm, row_bytes, kc, pm, col)
            for tile in range(sites // 64):
                acc[64 * tile:64 * tile + 64] += \
                    _wgmma_a(a_frag, tile, w % 8, ks).astype(np.float64) @ b
    want = constructs.static2_reference(variant, pcm, pool, n_ops).numpy()
    np.testing.assert_allclose(acc.T, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("variant", constructs.K_VARIANTS)
def test_static2_on_cpu_takes_plain_version(variant):
    pcm, pool = constructs.static2_inputs(64, seed=6, device="cpu")
    before = constructs.static2.launches
    got = constructs.static2(variant, pcm, pool, n_ops=11)
    assert constructs.static2.launches == before
    assert torch.equal(got, constructs.static2_reference(variant, pcm, pool,
                                                         11))
    assert torch.equal(constructs.static2(variant, pcm, pool, n_ops=0),
                       torch.zeros(16, 64))


def test_static2_rejects_wrong_inputs():
    pcm, pool = constructs.static2_inputs(128, seed=7, device="cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        constructs.static2("k4", pcm, pool)
    with pytest.raises(ValueError, match="unknown variant"):
        constructs.static2_reference("c0", pcm, pool)
    for dtype in (torch.float32, torch.float16):
        with pytest.raises(TypeError, match="bf16"):
            constructs.static2("k0", pcm.to(dtype), pool.to(dtype))
    with pytest.raises(TypeError, match="bf16"):
        constructs.static2("k0", pcm, pool.float())
    with pytest.raises(ValueError, match="takes pcm"):
        constructs.static2("k0", pcm[:, :, :48], pool)
    with pytest.raises(ValueError, match="takes pcm"):
        constructs.static2("k1", pcm, pool[:, :16])
    with pytest.raises(ValueError, match="takes pcm"):
        constructs.static2("k1", pcm, pool[0])
    with pytest.raises(ValueError, match="multiple of 64"):
        constructs.static2("k2", pcm, pool[:, :, :96])
    with pytest.raises(ValueError, match="multiple of 64"):
        constructs.static2("k2", pcm, pool[:, :, :0])
    with pytest.raises(ValueError, match="negative"):
        constructs.static2("k3", pcm, pool, n_ops=-1)
    with pytest.raises(ValueError, match="one CUDA device"):
        constructs.static2("k3", pcm, pool.to("meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        constructs.static2("k3", pcm.to("meta"), pool.to("meta"))


def test_static2_work_bounds_and_tolerance():
    """Bytes and FLOP at 65,536 sites and 128 ops (the pool rows read, the
    pcm part staged, [16, sites] f32 out; 2 x 16 x K x sites a product),
    and the shared memory of both forms: k3's pcm leaves no room for the
    A tiles in a CTA's 232,448 bytes."""
    work = {v: constructs.static2_work(v, 65536, 128)
            for v in constructs.K_VARIANTS}
    assert work["k0"] == (8 * 16 * 65536 * 2 + 64 * 16 * 16 * 2
                          + 16 * 65536 * 4, 2 * 16 * 16 * 65536 * 128)
    assert work["k1"][1] == 3 * work["k0"][1] == 12884901888
    assert work["k2"][1] == work["k3"][1] == 2 * 16 * 96 * 65536 * 128
    assert work["k2"][0] == work["k1"][0] - 64 * 16 * 48 * 2 + 16 * 96 * 2
    assert round(work["k0"][0] / 1e6, 1) == 21.0
    assert round(work["k1"][0] / 1e6, 1) == 54.6
    assert round(work["k3"][0] / 1e6, 1) == 54.7
    smem = {v: constructs.static2_smem_bytes(v)
            for v in constructs.K_VARIANTS}
    assert smem == {"k0": 32768 + 512, "k1": 98304 + 1536,
                    "k2": 3072 + 3072, "k3": 196608 + 3072}
    limit = 232448
    assert constructs.WARPGROUPS == 2
    assert constructs.static2_smem_bytes("k1", False) == 198144 <= limit
    assert constructs.static2_smem_bytes("k0", False) == 33280 + 32768
    assert constructs.static2_smem_bytes("k3", False) > limit
    assert constructs.static2_tolerance(128) == pytest.approx(
        2e-5 + 128 * 4e-7)
    got = torch.tensor([[1.0, 2.0], [0.5, -4.0]])
    want = torch.tensor([[1.0, 2.0], [0.0, -4.0]])
    assert constructs.static2_error(got, want) == 0.5


def test_variant_patches_apply_to_the_sources():
    """probes/variants.py builds its kernel variants by exact text
    replacements on csrc/: every one still occurs exactly once, changes the
    text, and an experiment name that does not exist is refused."""
    from libpll2_tpu_torch import _build
    from libpll2_tpu_torch.probes import variants
    assert set(variants.EXPERIMENTS) == {"blocks", "passes", "registers",
                                         "clocks", "fma_staging",
                                         "fma_clocks", "static2_smem_a",
                                         "generic_sweep", "generic_blocks",
                                         "generic_bounds", "generic_scorer"}
    for name, (file, patches) in variants.PATCHES.items():
        original = (_build.SOURCE_DIR / file).read_text()
        text = variants.patched_source(name)
        assert (text != original) == bool(patches), name
        for old, new in patches:
            assert original.count(old) == 1 and new in text, (name, old)
    assert "clock64" in variants.patched_source("clocks")
    assert "constexpr int RESIDENT_CTAS = 3;" in variants.patched_source(
        "three_ctas_an_sm")
    assert "constexpr int RESIDENT_CTAS_GENERIC = 2;" in \
        variants.patched_source("two_ctas_an_sm")
    first = variants.patched_source("generic_scorer_first")
    assert first.count("site_lk_any<SMAX") == 2 and \
        "site_lk_regs<SMAX" not in first.split("// The \"reread\" form.")[1]
    assert "scratch_floats(S)) *" in first and "if constexpr (false)" in first
    assert "(THREADS, V == 4 ? 2 : 1)" in first
    assert "site_lk_any<SMAX" not in (_build.SOURCE_DIR /
                                      "edge_score.cu").read_text()
    p_l1 = variants.patched_source("generic_p_l1")
    assert "GENERIC_STAGE_BYTES = 0;" in p_l1
    assert "return launch_scalar<8>(" in p_l1 and \
        "if constexpr (true)\n    return launch_groups_kernel" in p_l1
    bounds = variants.patched_source("generic_bounds_cta")
    assert bounds.count("dbg_smem(") == 13 and "__syncwarp()" not in bounds
    assert "launch_scalar<8>(" not in (_build.SOURCE_DIR /
                                       "tree_sweep_generic.cu").read_text()
    assert "constexpr bool A_IN_REGISTERS = false;" in \
        variants.patched_source("static2_smem_a")
    assert variants.main(["no_such_experiment"]) == 2
    if not torch.cuda.is_available():
        assert variants.main(["blocks"]) == 1

