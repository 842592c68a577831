"""Rate of the small dense products a tree sweep could use, on the card.

Counterpart of the JAX package's tools/mxu_probe.py, and the same function:
NREP products over NBUF = 4 rotating operand buffers B[0..3] and NBUF
accumulator slots, product j adding A . B[j % NBUF] into slot j % NBUF, all
inside one kernel launch (csrc/mma_probe.cu), one CTA per TB sites as in
the sweep.  The slots are independent chains: they expose the unit's
pipelined rate, as the JAX comment says.  The JAX kernel returns slot 0;
`chain` and `chain_reference` return every slot, so `chain(...)[:, 0]` is
what the JAX kernel returns.

Two orientations, as the JAX probe's transposed=False and True:
  P on M      A = P [M, K], B[j] [K, TB] sites   -> slot [M, TB]
              (span16, stacked3, span80, pack2, pack4);
  sites on M  B[j]^T [TB, K] . P [K, N]          -> slot [TB, N]
              (t_span16 = JAX F, t_stacked3 = JAX B at the 3-term depth,
              t_span80 = JAX J at the protein span: the layout of the "mma"
              sweep, and the only one that fills a wgmma's 64-row tile).
Units and forms: "fma" runs FFMA (P on M only: sites on M would be the same
arithmetic), "tf32" and "bf16" run mma.sync m16n8k8 / m16n8k16 with P on M
and wgmma m64nNk8 / m64nNk16 with sites on M.

    python -m libpll2_tpu_torch.probes.mma [TB]

prints, beside the card's name and power limit, for each of the 21 rows
(variant x unit): the form, microseconds per product, site-ops per second,
its bound (2 M K NREP SITES over the unit's peak) and share of it, after
checking every slot against the plain version (`chain_reference`: the same
products as torch.matmul in a Python loop, on inputs rounded to the unit's
precision).
"""
from __future__ import annotations

import functools
import statistics
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import torch

from ..ops.partials_tree import split_tf32

NREP = 512
NBUF = 4                 # operand buffers and accumulator slots
SITES = 65536            # columns over the whole grid: the main path's width


class Variant(NamedTuple):
    name: str
    m: int               # rows of P [M, K]; sites on M: columns N of P [K, N]
    k: int
    ops: int             # sweep ops one product stands for
    sites_on_m: bool


VARIANTS = (
    Variant("span16     [16,16]@[16,TB]", 16, 16, 1, False),
    Variant("stacked3   [16,48]@[48,TB]", 16, 48, 1, False),
    Variant("span80     [80,80]@[80,TB]", 80, 80, 1, False),
    Variant("pack2      [32,96]@[96,TB]", 32, 96, 2, False),
    Variant("pack4      [64,192]@[192,TB]", 64, 192, 4, False),
    Variant("t_span16   [TB,16]@[16,16]", 16, 16, 1, True),
    Variant("t_stacked3 [TB,48]@[48,16]", 16, 48, 1, True),
    Variant("t_span80   [TB,80]@[80,80]", 80, 80, 1, True),
)
UNITS = ("fma", "tf32", "bf16")
FORMS = ("ffma", "mma_sync", "wgmma")
# published dense peaks of one H100 SXM at 700 W: f32 FFMA, TF32 and bf16
# tensor FLOP/s
PEAK = {"fma": 67e12, "tf32": 495e12, "bf16": 989e12}
class Config(NamedTuple):
    a_source: str        # "regs", "smem" or "global"
    slots: int           # accumulator slots in flight
    groups: int          # FFMA: row groups; mma.sync: warps sharing sites
    warp_tiles: int = 0  # mma.sync: 8-site tiles a warp


# (variant, unit) -> Config: the table of csrc/mma_probe.cu's dispatch.  A
# source: "regs" (mma.sync fragments held for the whole chain), "smem"
# (staged beside B), "global" (the read-only cache: pack4's f32 / TF32 A
# does not fit beside its site buffers).  Groups split M where one CTA
# fills an SM, so that it still has 8 warps.
CONFIGS = {
    (0, "fma"): Config("smem", 4, 1), (0, "tf32"): Config("regs", 4, 1, 4),
    (0, "bf16"): Config("regs", 4, 1, 4),
    (1, "fma"): Config("smem", 4, 2), (1, "tf32"): Config("regs", 4, 1, 4),
    (1, "bf16"): Config("regs", 4, 1, 4),
    (2, "fma"): Config("smem", 4, 4), (2, "tf32"): Config("smem", 1, 1, 2),
    (2, "bf16"): Config("smem", 1, 1, 2),
    (3, "fma"): Config("smem", 4, 4), (3, "tf32"): Config("regs", 2, 2, 4),
    (3, "bf16"): Config("regs", 2, 1, 4),
    (4, "fma"): Config("global", 4, 8),
    (4, "tf32"): Config("global", 1, 4, 4),
    (4, "bf16"): Config("smem", 1, 2, 4),
    (5, "tf32"): Config("smem", 4, 1), (5, "bf16"): Config("smem", 4, 1),
    (6, "tf32"): Config("smem", 4, 1), (6, "bf16"): Config("smem", 4, 1),
    (7, "tf32"): Config("smem", 2, 1), (7, "bf16"): Config("smem", 2, 1),
}
MAX_THREADS = 256
# |kernel - plain| / max|plain| of a slot: products of rounded inputs are
# exact in f32, so only the additions differ: their order, and the tensor
# cores round each accumulation toward zero where an FMA rounds to nearest,
# so their error grows with a slot's chain (NREP / NBUF products of K / 8
# steps; 9.0e-5 at pack4 TF32, 128 products of 24 steps, on an H100)
CHAIN_TOL = 1e-3


def units_of(variant: int) -> tuple:
    """The units a variant runs on: no FFMA form with sites on M."""
    return UNITS[1:] if VARIANTS[variant].sites_on_m else UNITS


def form(variant: int, unit: str) -> str:
    """"ffma", "mma_sync" or "wgmma": the instruction (variant, unit) runs."""
    if unit not in UNITS:
        raise ValueError(f"unknown unit {unit!r}, not one of {UNITS}")
    if unit not in units_of(variant):
        raise ValueError(f"{VARIANTS[variant].name.split()[0]} has no "
                         f"{unit} form: with sites on M the FFMA arithmetic "
                         f"is that of the P-on-M variant")
    if unit == "fma":
        return "ffma"
    return "wgmma" if VARIANTS[variant].sites_on_m else "mma_sync"


def a_shape(variant: int) -> tuple:
    """P's shape: [M, K], or [K, N] with sites on M."""
    v = VARIANTS[variant]
    return (v.k, v.m) if v.sites_on_m else (v.m, v.k)


def probe_inputs(variant: int, tb: int, seed: int = 0, device="cuda"):
    """(A = P [M, K] or [K, N], B [NBUF, K, tb]) f32 standard normal from
    numpy's generator at `seed`."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(a_shape(variant)).astype(np.float32)
    b = rng.standard_normal((NBUF, VARIANTS[variant].k, tb)).astype(
        np.float32)
    return (torch.as_tensor(a, device=device),
            torch.as_tensor(b, device=device))


def round_unit(x, unit: str):
    """x rounded to what `unit` multiplies: f32 as is, TF32 (nearest, ties
    away), bf16 (nearest even)."""
    if unit == "fma":
        return x
    if unit == "tf32":
        return split_tf32(x)[0]
    if unit == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown unit {unit!r}, not one of {UNITS}")


def chain_reference(a, b, nrep: int = NREP, unit: str = "fma",
                    sites_on_m: bool = False):
    """Plain version: slot j % NBUF += A . B[j % NBUF] (P on M) or
    B[j % NBUF]^T . A (sites on M) for j < nrep -> [NBUF, M, TB] or
    [NBUF, TB, N] f32.  Slot 0 is the JAX kernel's result."""
    a, b = round_unit(a, unit), round_unit(b, unit)
    tb = b.shape[-1]
    shape = (NBUF, tb, a.shape[1]) if sites_on_m else (NBUF, a.shape[0], tb)
    acc = torch.zeros(shape, dtype=torch.float32, device=a.device)
    for j in range(nrep):
        s = j % NBUF
        acc[s] += b[s].t() @ a if sites_on_m else a @ b[s]
    return acc


@functools.cache
def fragment_index(M: int, K: int, unit: str) -> np.ndarray:
    """Index into A.flatten() of each lane's A-fragment registers:
    TF32 m16n8k8 [M/16, K/8, 32, 4]; bf16 m16n8k16 [M/16, K/16, 32, 4, 2]
    (two consecutive k per register)."""
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    reg = np.arange(4)
    rows = g[:, None] + 8 * (reg & 1)                         # [32, 4]
    if unit == "tf32":
        kstep = 8
        cols = q[:, None] + 4 * (reg >> 1)                    # [32, 4]
    else:
        kstep = 16
        cols = (2 * q[:, None] + 8 * (reg >> 1))[..., None] \
            + np.arange(2)                                    # [32, 4, 2]
        rows = rows[..., None]
    mt = np.arange(M // 16).reshape(-1, 1, *([1] * rows.ndim))
    ks = np.arange(K // kstep).reshape(1, -1, *([1] * rows.ndim))
    return ((16 * mt + rows) * K + kstep * ks + cols).astype(np.int64)


def _pack_bf16(x):
    """[..., 2] f32 -> [...] int32: two bf16, the first in the low half."""
    return x.to(torch.bfloat16).contiguous().view(torch.int32).squeeze(-1)


def core_matrices(x, unit: str):
    """[..., R, K] rows with K contiguous -> [..., R/8, K/E, 8, E], E = 16
    bytes of `unit`'s element (4 TF32, 8 bf16): the 8-row x 16-byte core
    matrices of a K-major wgmma operand without swizzle, rounded to the
    unit (bf16 as torch.bfloat16)."""
    x = round_unit(x, unit)
    if unit == "bf16":
        x = x.to(torch.bfloat16)
    e = 8 if unit == "bf16" else 4
    *lead, rows, k = x.shape
    tiles = x.reshape(*lead, rows // 8, 8, k // e, e)
    return tiles.transpose(-3, -2).contiguous()


def pack_operands(a, b, unit: str, sites_on_m: bool = False):
    """A and B in the layouts csrc/mma_probe.cu reads for `unit`: with P
    on M, A^T [K, M] and B (FFMA) or the mma.sync fragments; with sites on
    M (wgmma), P^T [N, K] and each B[j]^T [TB, K] as core matrices."""
    if sites_on_m:
        if unit == "fma":
            raise ValueError("no fma form with sites on M: the FFMA "
                             "arithmetic is that of the P-on-M variant")
        return (core_matrices(a.t(), unit),
                core_matrices(b.transpose(1, 2), unit))
    M, K = a.shape
    nbuf, _, tb = b.shape
    if unit == "fma":
        return a.t().contiguous(), b.contiguous()
    idx = torch.as_tensor(fragment_index(M, K, unit), device=a.device)
    tiled = b.reshape(nbuf, K, tb // 8, 8)
    if unit == "tf32":
        a_frag = round_unit(a, unit).flatten()[idx]
        b_tiles = round_unit(tiled, unit).permute(0, 2, 1, 3)
        return a_frag.contiguous(), b_tiles.contiguous()
    a_frag = _pack_bf16(a.flatten()[idx])
    pairs = tiled.reshape(nbuf, K // 2, 2, tb // 8, 8).permute(0, 3, 1, 4, 2)
    return a_frag.contiguous(), _pack_bf16(pairs).contiguous()


def smem_bytes(variant: int, unit: str, tb: int) -> int:
    """Dynamic shared memory of the launch at site block `tb`: the NBUF
    site buffers, and A (P) where CONFIGS stages it there."""
    v = VARIANTS[variant]
    form(variant, unit)
    eb = 2 if unit == "bf16" else 4
    a_src = CONFIGS[(variant, unit)].a_source
    return NBUF * v.k * tb * eb + (v.m * v.k * eb if a_src == "smem" else 0)


def threads(variant: int, unit: str, tb: int) -> int:
    """Threads of a CTA: a site pair per row group (FFMA), a warp per
    8 warp_tiles sites and group (mma.sync), 128 per 64 sites (wgmma)."""
    f, c = form(variant, unit), CONFIGS[(variant, unit)]
    if f == "ffma":
        return tb // 2 * c.groups
    if f == "mma_sync":
        return tb // (8 * c.warp_tiles) * c.groups * 32
    return tb // 64 * 128


def chain(variant: int, unit: str, a, b, grid: int = 1, nrep: int = NREP):
    """Every slot of the products for `grid` CTAs -> [grid, NBUF, M, TB]
    (P on M) or [grid, NBUF, TB, N] (sites on M) f32; `chain(...)[:, 0]` is
    what the JAX kernel returns.  The kernel on CUDA tensors, the plain
    version (repeated over grid) on CPU tensors."""
    if unit not in UNITS:
        raise ValueError(f"unknown unit {unit!r}, not one of {UNITS}")
    v = VARIANTS[variant]
    f = form(variant, unit)
    tb = b.shape[-1]
    if tuple(a.shape) != a_shape(variant) \
            or tuple(b.shape) != (NBUF, v.k, tb):
        raise ValueError(f"variant {variant} takes A {list(a_shape(variant))}"
                         f" and B [{NBUF}, {v.k}, TB], got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("the probe takes f32 inputs")
    if nrep <= 0 or nrep % NBUF:
        raise ValueError(f"nrep must be a positive multiple of {NBUF}, got "
                         f"{nrep}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        want = chain_reference(a, b, nrep, unit, v.sites_on_m)
        return want[None].repeat(grid, 1, 1, 1)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"the probe needs both inputs on one CUDA device "
                         f"or both on the CPU, got {a.device}, {b.device}")
    step = 64 if v.sites_on_m else 32
    if tb % step or tb > 256 or threads(variant, unit, tb) > MAX_THREADS:
        raise ValueError(f"{f} at variant {variant} takes TB a multiple of "
                         f"{step} and at most {MAX_THREADS} threads, got TB "
                         f"{tb} ({threads(variant, unit, tb)} threads)")
    from .. import _build
    limit = _build.max_shared_memory(a.device)
    if smem_bytes(variant, unit, tb) > limit:
        raise ValueError(f"variant {variant} on {unit} at TB {tb} needs "
                         f"{smem_bytes(variant, unit, tb)} bytes of shared "
                         f"memory, above the {limit}-byte limit")
    a_dev, b_dev = pack_operands(a, b, unit, v.sites_on_m)
    shape = (grid, NBUF, tb, v.m) if v.sites_on_m else (grid, NBUF, v.m, tb)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    return launch_packed(variant, unit, a_dev, b_dev, out, nrep)


def launch_packed(variant: int, unit: str, a_dev, b_dev, out,
                  nrep: int = NREP):
    """The kernel on operands `pack_operands` made, into `out` (the shape
    `chain` returns, whose first and site dimensions give grid and TB);
    `chain` checks the arguments.  Returns `out`."""
    from .. import _build
    f = form(variant, unit)
    tb = out.shape[2] if VARIANTS[variant].sites_on_m else out.shape[3]
    with torch.cuda.device(out.device):
        err = _build.library().mma_probe_launch(
            variant, UNITS.index(unit), a_dev.data_ptr(), b_dev.data_ptr(),
            out.data_ptr(), out.shape[0], tb, nrep,
            torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mma_probe kernel launch failed ({f}): CUDA "
                           f"error {err} ({_build.error_string(err)})")
    chain.launches += 1
    chain.launches_by_form[f] += 1
    return out


chain.launches = 0   # kernel launches by this wrapper (plain runs excluded)
chain.launches_by_form = dict.fromkeys(FORMS, 0)


def bound_ms(variant: int, unit: str) -> float:
    """Least time of the NREP products over SITES: 2 M K NREP SITES
    operations over the unit's peak (the bytes, read once, take far less)."""
    v = VARIANTS[variant]
    return 2 * v.m * v.k * NREP * SITES / PEAK[unit] * 1e3


def site_block(variant: int, unit: str, tb: int, limit: int) -> int:
    """`tb`, halved while the launch needs more shared memory than
    `limit` (pack4 in f32 and TF32: TB 64 at 128)."""
    while smem_bytes(variant, unit, tb) > limit and tb > 64:
        tb //= 2
    return tb


def run_probe(tb: int = 128, device=None, reps: int = 5, emit=print,
              back_to_back: int = 20):
    """Check and time every variant on every unit at site block `tb` (a
    smaller one where shared memory forces it, over the same SITES).
    Returns a list of dicts (variant, unit, form, tb, us_per_product,
    site_ops_per_s, rel_err, ms: the kernel's launches back to back,
    call_ms: a `chain` call with its packing, plain_ms, bound_ms, share);
    raises if a slot disagrees with its plain version or the CTAs differ.
    Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures the card: no CUDA device")
    device = torch.device("cuda", 0) if device is None else device
    from .. import _build
    limit = _build.max_shared_memory(device)
    rows = []
    for v, var in enumerate(VARIANTS):
        for unit in units_of(v):
            f = form(v, unit)
            row_tb = site_block(v, unit, tb, limit)
            grid = SITES // row_tb
            a, b = probe_inputs(v, row_tb, seed=v, device=device)
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            want = chain_reference(a, b, NREP, unit, var.sites_on_m)
            stop.record()
            stop.synchronize()
            plain_ms = start.elapsed_time(stop)
            got = chain(v, unit, a, b, grid)
            torch.cuda.synchronize()
            if not (got == got[0]).all().item():
                raise RuntimeError(f"{var.name} {unit}: CTAs disagree")
            scale = want.flatten(1).abs().amax(1)            # per slot
            err = ((got[0] - want).flatten(1).abs().amax(1) / scale)
            err, abs_err = err.max().item(), (got[0] - want).abs().max().item()
            if not err <= CHAIN_TOL:
                raise RuntimeError(f"{var.name} {unit}: rel err {err} > "
                                   f"{CHAIN_TOL} against the plain chain")
            # the kernel alone: launches back to back on operands packed
            # once; then whole calls (packing inside), as the probe was
            # timed before
            a_dev, b_dev = pack_operands(a, b, unit, var.sites_on_m)
            start.record()
            for _ in range(back_to_back):
                launch_packed(v, unit, a_dev, b_dev, got, NREP)
            stop.record()
            stop.synchronize()
            ms = start.elapsed_time(stop) / back_to_back
            calls = []
            for _ in range(reps):
                start.record()
                chain(v, unit, a, b, grid)
                stop.record()
                stop.synchronize()
                calls.append(start.elapsed_time(stop))
            call_ms = statistics.median(calls)
            per_mm = ms * 1e-3 / NREP
            site_ops = SITES * var.ops / per_mm
            bound = bound_ms(v, unit)
            emit(f"{var.name:29s} {unit:4s} {f:8s} TB {row_tb:3d}  "
                 f"{per_mm * 1e6:8.3f} us/product  {site_ops:.4e} site-ops/s"
                 f"  bound {bound:.4f} ms, {bound / ms:.3f} of it  rel err "
                 f"{err:.2e} (every slot)  (kernel {ms:.4f} ms back to back, "
                 f"a call with packing {call_ms:.4f} ms, plain "
                 f"{plain_ms:.3f} ms)")
            rows.append(dict(variant=var.name, unit=unit, form=f, M=var.m,
                             K=var.k, tb=row_tb, us_per_product=per_mm * 1e6,
                             site_ops_per_s=site_ops, rel_err=err, ms=ms,
                             plain_ms=plain_ms, abs_err=abs_err,
                             bound_ms=bound, share=bound / ms,
                             call_ms=call_ms))
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tb = int(argv[0]) if argv else 128
    if not torch.cuda.is_available():
        print("probes.mma: torch.cuda.is_available() is False; the probe "
              "needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else torch.cuda.get_device_name(0))
    print(f"TB={tb} NREP={NREP} NBUF={NBUF} sites={SITES}")
    run_probe(tb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
