"""Alignment I/O of the port against libpll2_tpu: FASTA and PHYLIP
readers, site-pattern compression, the native binding and checkpoints.
Every case of tests/test_io.py and tests/test_native.py goes through both
packages, which must give equal alignments, patterns, weights and site
maps, and raise errors of the same type; the port's native and numpy
paths must agree with each other.

Tolerances: none (text, integers and exact copies of f64 values)."""
import io
import time

import numpy as np
import pytest
import torch

import libpll2_tpu as pll
from libpll2_tpu import fit as jfit
from libpll2_tpu import io as jio
from libpll2_tpu import native as jnative
from libpll2_tpu_torch import MAPS, fit, native
from libpll2_tpu_torch import io as pio
from libpll2_tpu_torch.utils import checkpoint

from .test_io import FASTA, PHYLIP_INT, PHYLIP_SEQ, rand_case


@pytest.fixture(scope="module")
def native_libraries():
    """Both packages' native libraries, loaded when the first test that
    needs them runs (not while the module is imported).  The JAX package
    builds its library in place with g++ -o, so a pytest worker can find
    it half-written while another worker's g++ is still linking it, fail
    to load it once and remember the failure: such a load is retried,
    a few seconds apart, before the tests skip."""
    ok = native.ensure_native()
    for attempt in range(6):
        if not ok:
            break
        if jnative.ensure_native(force=attempt > 0):
            return
        time.sleep(2.0)
    pytest.skip("native build unavailable")


needs_native = pytest.mark.usefixtures("native_libraries")


@pytest.fixture
def numpy_path(monkeypatch):
    """The port's numpy path, as LIBPLL2_TPU_NATIVE=0 selects it."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


def same_error(call_port, call_jax):
    with pytest.raises(ValueError) as got:
        call_port()
    with pytest.raises(ValueError) as want:
        call_jax()
    assert type(got.value).__name__ == type(want.value).__name__
    assert [c.__name__ for c in type(got.value).__mro__] == \
        [c.__name__ for c in type(want.value).__mro__]


# --------------------------------------------------------------------------
# readers (tests/test_io.py)
# --------------------------------------------------------------------------

READERS = {
    "fasta": (lambda m: m.load_fasta_string(FASTA)),
    "phylip_sequential": (lambda m: m.load_phylip_string(
        PHYLIP_SEQ, interleaved=False)),
    "phylip_interleaved": (lambda m: m.load_phylip_string(
        PHYLIP_INT, interleaved=True)),
}


@pytest.mark.parametrize("reader", sorted(READERS))
def test_readers_equal(reader):
    got, want = READERS[reader](pio), READERS[reader](jio)
    assert isinstance(got, pio.MSA)
    assert (got.labels, got.sequences, got.count, got.length) == \
        (want.labels, want.sequences, want.count, want.length)


@pytest.mark.parametrize("text,interleaved", [
    ("2 8\nt1 ACGTACGT\nt2 ACGTA\n", False),
    ("2 8\nt1 ACGT\nt2 ACGTACGT\nACGTAC\n", True),
    ("x 8\nt1 ACGTACGT\n", False), ("", False)])
def test_phylip_errors_equal(text, interleaved):
    same_error(lambda: pio.load_phylip_string(text, interleaved),
               lambda: jio.load_phylip_string(text, interleaved))


def test_fasta_streaming_equal(tmp_path):
    path = tmp_path / "msa.fa"
    path.write_text(FASTA)
    with pio.FastaFile(str(path)) as got, jio.FastaFile(str(path)) as want:
        assert got.filesize == want.filesize == len(FASTA)
        for _ in range(4):
            assert got.getnext() == want.getnext()
            assert got.getfilepos() == want.getfilepos()
        assert (got.stripped_count, got.stripped) == \
            (want.stripped_count, want.stripped)
        got.rewind()
        want.rewind()
        assert got.getnext() == want.getnext()
        assert list(got) == list(want)


@pytest.mark.parametrize("text", ["ACGT\n>x\nACGT\n", ">x\nAC{T\n"])
def test_fasta_streaming_errors_equal(tmp_path, text):
    path = tmp_path / "bad.fa"
    path.write_text(text)

    def first(module):
        with module.FastaFile(str(path)) as fd:
            fd.getnext()
    same_error(lambda: first(pio), lambda: first(jio))
    same_error(lambda: list(pio.iter_fasta(io.StringIO(text))),
               lambda: list(jio.iter_fasta(io.StringIO(text))))


# --------------------------------------------------------------------------
# compression (tests/test_io.py, tests/test_native.py)
# --------------------------------------------------------------------------

COMPRESS = {
    "basic": (["ACCA", "AGGA", "ATTA"], "nt"),
    "map_roundtrip": (["ACGTACGT", "ACGTACGA", "CCGTACGT"], "nt"),
    "gap_canonical": (["A?", "A-"], "nt"),
    "logl_case": (rand_case(), "nt"),
    "native_case": (["".join("ACGT-RY"[b] for b in np.random.default_rng(
        3).integers(0, 7, 300)) for _ in range(20)], "nt"),
    "protein": (["".join("ARNDCQEGHILKMFPSTWYVBZX-"[b] for b in
                         np.random.default_rng(4).integers(0, 24, 150))
                 for _ in range(9)], "aa"),
}


@needs_native
@pytest.mark.parametrize("case", sorted(COMPRESS))
def test_compress_equal(case, monkeypatch):
    seqs, name = COMPRESS[case]
    want = jio.compress_site_patterns(seqs, pll.MAPS[name], return_map=True)
    got = pio.compress_site_patterns(seqs, MAPS[name], return_map=True)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    plain = pio.compress_site_patterns(seqs, MAPS[name], return_map=True)
    for out in (got, plain):
        assert out[0] == want[0]
        for a, b in zip(out[1:], want[1:]):
            assert a.dtype == b.dtype == np.uint32
            np.testing.assert_array_equal(a, b)
    short = pio.compress_site_patterns(seqs, MAPS[name])
    assert len(short) == 2 and short[0] == want[0]
    # the map rebuilds every column's codes; the weights count every site
    for row, orig in zip(got[0], seqs):
        rebuilt = "".join(row[k] for k in got[2])
        np.testing.assert_array_equal(
            MAPS[name][np.frombuffer(rebuilt.encode(), np.uint8)],
            MAPS[name][np.frombuffer(orig.encode(), np.uint8)])
    assert int(got[1].sum()) == len(seqs[0])


def test_compress_errors_equal():
    for seqs in ([], ["ACGT", "ACG"], ["AC@T", "ACGT"]):
        same_error(
            lambda: pio.compress_site_patterns(seqs, MAPS["nt"]),
            lambda: jio.compress_site_patterns(seqs, pll.MAPS["nt"]))


# --------------------------------------------------------------------------
# the native binding (tests/test_native.py)
# --------------------------------------------------------------------------

@needs_native
def test_native_builds_its_own_library():
    assert native._LIB.parent.name == "libpll2_tpu_torch"
    assert native._LIB.parent.parent.name == "build"
    assert native._LIB.exists() and native._LIB != jnative._LIB
    assert native._SRC == jnative._SRC


@needs_native
def test_fasta_native_equal(tmp_path):
    text = (">seq one  \nACGT\nACG-\n\n>s2\n??AC GT*!\n"
            ">s3\nACGTACGTAC\n")
    path = tmp_path / "x.fa"
    path.write_text(text)
    got = native.fasta_load(str(path))
    assert got == jnative.fasta_load(str(path))
    py = list(pio.iter_fasta(str(path)))
    assert got == ([h for h, _ in py], [s for _, s in py])


@needs_native
def test_fasta_msa_equal(tmp_path, numpy_path):
    rng = np.random.default_rng(11)
    recs = [(f"taxon_{i}", "".join("ACGT"[b]
                                   for b in rng.integers(0, 4, 120)))
            for i in range(40)]
    path = tmp_path / "m.fa"
    path.write_text("".join(f">{h}\n{s[:60]}\n{s[60:]}\n" for h, s in recs))
    plain = pio.load_fasta_msa(str(path))         # numpy path
    native._lib, native._tried = None, False
    assert native.available()
    got = pio.load_fasta_msa(str(path))           # native path
    want = jio.load_fasta_msa(str(path))
    for msa in (got, plain):
        assert msa.labels == want.labels == [h for h, _ in recs]
        assert msa.sequences == want.sequences == [s for _, s in recs]


@needs_native
@pytest.mark.parametrize("text", [">a\nAC@T\n", "", ">a\nACGT\n>b\nAC\n"])
def test_fasta_errors_equal(tmp_path, text):
    path = tmp_path / "bad.fa"
    path.write_text(text)
    same_error(lambda: pio.load_fasta_msa(str(path)),
               lambda: jio.load_fasta_msa(str(path)))
    if "@" in text:
        same_error(lambda: native.fasta_load(str(path)),
                   lambda: jnative.fasta_load(str(path)))


@needs_native
def test_encode_tip_equal():
    seq = b"ACGTRYSWKMBDHVN-acgt"
    got = native.encode_tip(seq, MAPS["nt"])
    np.testing.assert_array_equal(got, jnative.encode_tip(seq, pll.MAP_NT))
    np.testing.assert_array_equal(
        got, MAPS["nt"][np.frombuffer(seq, np.uint8)].astype(np.uint64))
    same_error(lambda: native.encode_tip(b"AC@T", MAPS["nt"]),
               lambda: jnative.encode_tip(b"AC@T", pll.MAP_NT))


def test_native_switch(monkeypatch):
    monkeypatch.setenv("LIBPLL2_TPU_NATIVE", "0")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()
    with pytest.raises(RuntimeError):
        native.compress_patterns(np.ones((2, 3), np.uint8))


# --------------------------------------------------------------------------
# checkpoints (tests/test_fit.py::test_checkpoint_roundtrip)
# --------------------------------------------------------------------------

SUBST = [1.2, 2.1, 0.7, 1.3, 2.5, 1.0]
FREQS = [0.3, 0.25, 0.2, 0.25]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_checkpoint_roundtrip(tmp_path, dtype):
    import jax.numpy as jnp
    params = fit.pack([SUBST], [FREQS], [0.1, 0.2, 0.3], alpha=1.5,
                      dtype=dtype, device="cpu")
    checkpoint.save(tmp_path / "ck", params)
    like = fit.pack([[1.0] * 6], [[0.25] * 4], [1.0, 1.0, 1.0],
                    dtype=dtype, device="cpu")
    restored = checkpoint.restore(tmp_path / "ck", like)
    assert type(restored) is fit.FitParams
    for a, b in zip(params, restored):
        assert b.dtype == dtype and b.device == a.device
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    # the same values as the JAX package's pack, and restored into f64
    jparams = jfit.pack([SUBST], [FREQS], [0.1, 0.2, 0.3], alpha=1.5,
                        dtype=jnp.float64)
    wide = checkpoint.restore(tmp_path / "ck", fit.pack(
        [[1.0] * 6], [[0.25] * 4], [1.0, 1.0, 1.0], dtype=torch.float64,
        device="cpu"))
    for a, b in zip(wide, jparams):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b),
            rtol=0 if dtype == torch.float64 else 1e-7)


def test_checkpoint_nested(tmp_path):
    tree = {"bl": torch.arange(5, dtype=torch.float64),
            "steps": (np.int64(7), [torch.ones(2, 3, dtype=torch.int32)])}
    checkpoint.save(tmp_path, tree)
    assert (tmp_path / "structure.json").exists()
    like = {"bl": torch.zeros(5, dtype=torch.float32),
            "steps": (np.int32(0), [torch.zeros(2, 3, dtype=torch.int64)])}
    back = checkpoint.restore(tmp_path, like)
    assert back["bl"].dtype == torch.float32
    assert back["bl"].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert back["steps"][0] == 7 and back["steps"][0].dtype == np.int32
    assert back["steps"][1][0].dtype == torch.int64
    assert back["steps"][1][0].tolist() == [[1] * 3] * 2
    with pytest.raises(ValueError):
        checkpoint.restore(tmp_path, {"bl": like["bl"]})


@pytest.mark.parametrize("other", ["branches", "container"])
def test_checkpoint_refuses_another_structure(tmp_path, other):
    """A checkpoint restores only into `like` of its own containers and
    shapes: FitParams of another branch count has as many leaves, and so
    has a tuple of the same tensors."""
    params = fit.pack([SUBST], [FREQS], [0.1, 0.2, 0.3], alpha=1.5,
                      dtype=torch.float64, device="cpu")
    checkpoint.save(tmp_path, params)
    if other == "branches":
        like = fit.pack([SUBST], [FREQS], [0.1] * 5, alpha=1.5,
                        dtype=torch.float64, device="cpu")
    else:
        like = tuple(params)
    with pytest.raises(ValueError):
        checkpoint.restore(tmp_path, like)
