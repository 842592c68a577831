"""Rate of the small dense products a tree sweep could use, on the card.

Counterpart of the JAX package's tools/mxu_probe.py.  Each variant runs
NREP dependent products acc += A[M, K] . B[j % NBUF][K, TB] inside one
kernel launch (csrc/mma_probe.cu), one CTA per TB sites as in the sweep,
on three units: f32 FMAs, TF32 mma.sync.m16n8k8 and bf16
mma.sync.m16n8k16.  The shapes are the sweep's candidates: the
rate-block-diagonal product at span 16 and span 80, the 3-term stacked
form, and two and four ops packed into one product.

    python -m libpll2_tpu_torch.probes.mma [TB]

prints, beside the card's name and power limit, microseconds per product
and site-ops per second for every variant and unit, after checking each
result against the plain version (`chain_reference`: the same chain as
torch.matmul in a Python loop, on inputs rounded to the unit's precision).
"""
from __future__ import annotations

import functools
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops.partials_tree import split_tf32

NREP = 512
NBUF = 2                 # rotating B buffers (csrc/mma_probe.cu)
SITES = 65536            # columns over the whole grid: the main path's width
# name, M, K, sweep ops one product stands for
VARIANTS = (
    ("span16   [16,16]@[16,TB]", 16, 16, 1),
    ("stacked3 [16,48]@[48,TB]", 16, 48, 1),
    ("span80   [80,80]@[80,TB]", 80, 80, 1),
    ("pack2    [32,96]@[96,TB]", 32, 96, 2),
    ("pack4    [64,192]@[192,TB]", 64, 192, 4),
)
UNITS = ("fma", "tf32", "bf16")
# |kernel - plain| / max|plain|: products of rounded inputs are exact in
# f32, so only the additions differ: their order, and the tensor cores
# round each of the NREP * K / 8 dependent accumulations toward zero where
# an FMA rounds to nearest, so their error grows with the chain's length
# (1.5e-4 at [80,80] over 512 products on an H100)
CHAIN_TOL = 1e-3


def probe_inputs(variant: int, tb: int, seed: int = 0, device="cuda"):
    """(A [M, K], B [NBUF, K, tb]) f32 standard normal from numpy's
    generator at `seed`."""
    _, M, K, _ = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((NBUF, K, tb)).astype(np.float32)
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


def chain_reference(a, b, nrep: int = NREP, unit: str = "fma"):
    """Plain version: acc += A . B[j % NBUF] for j < nrep -> [M, TB] f32."""
    a, b = round_unit(a, unit), round_unit(b, unit)
    acc = torch.zeros((a.shape[0], b.shape[-1]), dtype=torch.float32,
                      device=a.device)
    for j in range(nrep):
        acc += torch.matmul(a, b[j % NBUF])
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


def pack_operands(a, b, unit: str):
    """A and B in the layouts csrc/mma_probe.cu reads for `unit`."""
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
    _, _, K, _ = VARIANTS[variant]
    return NBUF * (K // 2 if unit == "bf16" else K) * tb * 4


def chain(variant: int, unit: str, a, b, grid: int = 1, nrep: int = NREP):
    """acc of the chain for `grid` CTAs -> [grid, M, TB] f32: the kernel on
    CUDA tensors, the plain version (repeated over grid) on CPU tensors."""
    if unit not in UNITS:
        raise ValueError(f"unknown unit {unit!r}, not one of {UNITS}")
    _, M, K, _ = VARIANTS[variant]
    tb = b.shape[-1]
    if tuple(a.shape) != (M, K) or tuple(b.shape) != (NBUF, K, tb):
        raise ValueError(f"variant {variant} takes A [{M}, {K}] and B "
                         f"[{NBUF}, {K}, TB], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("the probe takes f32 inputs")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return chain_reference(a, b, nrep, unit)[None].repeat(grid, 1, 1)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"the probe needs both inputs on one CUDA device "
                         f"or both on the CPU, got {a.device}, {b.device}")
    if tb % 32 or tb > 256:
        raise ValueError(f"TB must be a multiple of 32 up to 256, got {tb}")
    from .. import _build
    limit = _build.max_shared_memory(a.device)
    if smem_bytes(variant, unit, tb) > limit:
        raise ValueError(f"variant {variant} on {unit} at TB {tb} needs "
                         f"{smem_bytes(variant, unit, tb)} bytes of shared "
                         f"memory, above the {limit}-byte limit")
    a_dev, b_dev = pack_operands(a, b, unit)
    out = torch.empty((grid, M, tb), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _build.library().mma_probe_launch(
            variant, UNITS.index(unit), a_dev.data_ptr(), b_dev.data_ptr(),
            out.data_ptr(), grid, tb, nrep,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mma_probe kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    chain.launches += 1
    return out


chain.launches = 0   # kernel launches by this wrapper (plain runs excluded)


def run_probe(tb: int = 128, device=None, reps: int = 5, emit=print):
    """Check and time every variant on every unit at site block `tb`.
    Returns a list of dicts (variant, unit, us_per_product, site_ops_per_s,
    rel_err, plain_ms); raises if a result disagrees with its plain
    version.  Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures the card: no CUDA device")
    device = torch.device("cuda", 0) if device is None else device
    from .. import _build
    limit = _build.max_shared_memory(device)
    grid = SITES // tb
    rows = []
    for v, (name, M, K, ops_per_mm) in enumerate(VARIANTS):
        a, b = probe_inputs(v, tb, seed=v, device=device)
        for unit in UNITS:
            if smem_bytes(v, unit, tb) > limit:
                emit(f"{name:28s} {unit:5s} n/a: B needs "
                     f"{smem_bytes(v, unit, tb)} bytes of shared memory")
                continue
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            want = chain_reference(a, b, NREP, unit)
            stop.record()
            stop.synchronize()
            plain_ms = start.elapsed_time(stop)
            got = chain(v, unit, a, b, grid)
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            err = max((got[i] - want).abs().max().item()
                      for i in (0, grid - 1)) / scale
            if not (got == got[0]).all().item():
                raise RuntimeError(f"{name} {unit}: CTAs disagree")
            if not err <= CHAIN_TOL:
                raise RuntimeError(f"{name} {unit}: rel err {err} > "
                                   f"{CHAIN_TOL} against the plain chain")
            times = []
            for _ in range(reps):
                start.record()
                chain(v, unit, a, b, grid)
                stop.record()
                stop.synchronize()
                times.append(start.elapsed_time(stop))
            ms = statistics.median(times)
            per_mm = ms * 1e-3 / NREP
            site_ops = grid * tb * ops_per_mm / per_mm
            emit(f"{name:28s} {unit:5s} {per_mm * 1e6:9.3f} us/product  "
                 f"{site_ops:.4e} site-ops/s  rel err {err:.2e}  "
                 f"(kernel {ms:.3f} ms, plain chain {plain_ms:.3f} ms)")
            rows.append(dict(variant=name, unit=unit, M=M, K=K,
                             us_per_product=per_mm * 1e6,
                             site_ops_per_s=site_ops, rel_err=err, ms=ms,
                             plain_ms=plain_ms, abs_err=err * scale))
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
    print(f"TB={tb} NREP={NREP} NBUF={NBUF} sites={SITES} "
          f"(grid {SITES // tb} CTAs)")
    run_probe(tb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
