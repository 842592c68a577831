"""Which construct of the tensor-core tree sweep costs the time, on the card.

Counterpart of the JAX package's tools/static2probe.py, which timed four
minimal kernels over the same ops and shapes, adding one construct of a
slow sweep kernel at a time.  The first four variants here (csrc/
construct_probe.cu) add the constructs of csrc/tree_sweep_mma.cu's inner
loop one at a time, over `n_ops` dependent ops at span 16 with 64 P rows
and 8 pool slots, pm = (7 w) % 64 and slot = w % 8 as in the TPU probe; the
fifth takes the costliest construct out again the way the sweep does:

  c0  one TF32 mma.sync product per op, the fixed P[0] in registers, B
      from the shared-memory pool:             acc = sum_w P[0] . pool[w % 8]
  c1  c0 plus the compensated split (three products per op);     the same sum
  c2  c1 plus the A fragments fetched per op by the gathered pm:
                                            acc = sum_w P[pm_w] . pool[w % 8]
  c3  c2 plus the per-site rescue and the C-fragment store into the slot
      the next op reads:     x <- rescue(P[pm_w] . x) from x = pool[0], with
      the sweep's f32 rule (a site whose largest entry is below 2^-30 is
      multiplied by 2^30 and its scaler counts one).
  c4  c3 with the sweep's register carry: the parent moves to the next op's
      operand layout by warp shuffles and only the last op stores.  The
      same chain as c3, bit for bit (one plain version serves both).

    python -m libpll2_tpu_torch.probes.constructs [n_ops] [tb] [reps]

prints, beside the card's name and power limit, microseconds per op for
every variant and the increments c1-c0, c2-c1, c3-c2, c4-c3, after
checking each variant against the plain version (`constructs_reference`:
the same sums in f32 torch.matmul).
"""
from __future__ import annotations

import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops.partials_tree import split_tf32
from .mma import fragment_index

VARIANTS = ("c0", "c1", "c2", "c3", "c4")
SPAN = 16                # rates * states of DNA with four categories
P_ROWS = 64
N_SLOTS = 8
SITES = 65536            # columns over the whole grid: the main path's width
THRESH, FACTOR = 2.0 ** -30, 2.0 ** 30     # config.py's f32 scale rule
# |kernel - plain| relative to each site's largest entry.  c0 multiplies
# operands rounded to TF32 (11 significant bits each: 2 * 2^-11 at worst).
# c1-c3 carry the compensated split and start from the bound the sweep's
# "mma" rows are held to, 2e-5 plus 1.5e-7 per op: the tensor cores round
# their accumulator toward zero, up to 2^-23 and about 4e-8 on average per
# mma.  c3 and c4 restart their accumulator every op as the sweep does and
# keep that bound.  c1 and c2 add all their ops into ONE accumulator, six
# truncating mma per op each relative to the whole running sum (2.3e-7 to
# 2.5e-7 per op measured on an H100), so their allowance per op is 4e-7.
C0_TOL = 2e-3
SPLIT_TOL = 2e-5
TOL_PER_OP = {"c0": 1.5e-7, "c1": 4e-7, "c2": 4e-7, "c3": 1.5e-7,
              "c4": 1.5e-7}


def tolerance(variant: str, n_ops: int) -> float:
    _check_variant(variant)
    return ((C0_TOL if variant == "c0" else SPLIT_TOL)
            + TOL_PER_OP[variant] * n_ops)


def probe_inputs(tb: int, seed: int = 0, device="cuda"):
    """(P [64, 16, 16], pool [8, 16, tb]) f32 from numpy's generator at
    `seed`: uniform entries, P scaled so that a product halves its operand
    on average (the c3 chain then meets the rescue every 30 ops or so)."""
    rng = np.random.default_rng(seed)
    p = (rng.random((P_ROWS, SPAN, SPAN)) / SPAN).astype(np.float32)
    pool = rng.random((N_SLOTS, SPAN, tb)).astype(np.float32)
    return (torch.as_tensor(p, device=device),
            torch.as_tensor(pool, device=device))


def _check_variant(variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}, not one of "
                         f"{VARIANTS}")
    return VARIANTS.index(variant)


def constructs_reference(variant: str, p, pool, n_ops: int = 128):
    """Plain version -> (out [16, TB] f32, scalers [TB] i32): the sums of
    the module docstring in f32; scalers are zero except for c3 and c4
    (one chain, two kernels)."""
    v = _check_variant(variant)
    tb = pool.shape[-1]
    scal = torch.zeros(tb, dtype=torch.int32, device=pool.device)
    if v < 3:
        acc = torch.zeros((SPAN, tb), dtype=torch.float32,
                          device=pool.device)
        for w in range(n_ops):
            pm = (w * 7) % P_ROWS if v == 2 else 0
            acc += torch.matmul(p[pm], pool[w % N_SLOTS])
        return acc, scal
    x = pool[0]
    for w in range(n_ops):
        y = torch.matmul(p[(w * 7) % P_ROWS], x)
        below = y.amax(dim=0) < THRESH
        x = torch.where(below, y * FACTOR, y)
        scal = scal + below.to(torch.int32)
    return x, scal


def pack_operands(p, pool):
    """P and the pool in the layouts csrc/construct_probe.cu reads: pfrag
    [64, 2, 2 (hi, lo), 32, 4] (TF32 head and remainder in A-fragment
    order), pool tiled [8, TB/8, 16, 8]."""
    idx = torch.as_tensor(fragment_index(SPAN, SPAN, "tf32")[0],
                          device=p.device)                    # [2, 32, 4]
    frag = p.reshape(P_ROWS, -1)[:, idx]                      # [64, 2, 32, 4]
    pfrag = torch.stack(split_tf32(frag), dim=2).contiguous()
    tb = pool.shape[-1]
    tiled = pool.reshape(N_SLOTS, SPAN, tb // 8, 8).permute(0, 2, 1, 3)
    return pfrag, tiled.contiguous()


def launch_packed(variant: str, pfrag, tiled, n_ops: int, grid: int):
    """The kernel on operands already packed (pack_operands) -> (out
    [grid, 16, TB], scalers [grid, TB]).  `constructs` without the
    packing, so that a timing holds the kernel alone."""
    v = _check_variant(variant)
    tb = tiled.shape[1] * 8
    if pfrag.device.type != "cuda" or tiled.device != pfrag.device:
        raise ValueError(f"the kernel needs both operands on one CUDA "
                         f"device, got {pfrag.device}, {tiled.device}")
    if tuple(pfrag.shape) != (P_ROWS, 2, 2, 32, 4) \
            or tuple(tiled.shape) != (N_SLOTS, tb // 8, SPAN, 8) \
            or not (pfrag.is_contiguous() and tiled.is_contiguous()):
        raise ValueError("operands are not what pack_operands gives")
    if tb % 32 or not 0 < tb <= 256:
        raise ValueError(f"TB must be a multiple of 32 up to 256, got {tb}")
    from .. import _build
    out = torch.empty((grid, SPAN, tb), dtype=torch.float32,
                      device=pfrag.device)
    scal = torch.empty((grid, tb), dtype=torch.int32, device=pfrag.device)
    with torch.cuda.device(pfrag.device):
        err = _build.library().construct_probe_launch(
            v, pfrag.data_ptr(), tiled.data_ptr(), out.data_ptr(),
            scal.data_ptr(), grid, tb, n_ops, THRESH, FACTOR,
            torch.cuda.current_stream(pfrag.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"construct_probe kernel launch failed: CUDA "
                           f"error {err} ({_build.error_string(err)})")
    constructs.launches += 1
    return out, scal


def constructs(variant: str, p, pool, n_ops: int = 128, grid: int = 1):
    """Variant `variant` for `grid` CTAs -> (out [grid, 16, TB] f32,
    scalers [grid, TB] i32): the kernel on CUDA tensors, the plain version
    (repeated over grid) on CPU tensors."""
    _check_variant(variant)
    tb = pool.shape[-1]
    if tuple(p.shape) != (P_ROWS, SPAN, SPAN) \
            or tuple(pool.shape) != (N_SLOTS, SPAN, tb):
        raise ValueError(f"the probe takes P [{P_ROWS}, {SPAN}, {SPAN}] and "
                         f"a pool [{N_SLOTS}, {SPAN}, TB], got "
                         f"{tuple(p.shape)} and {tuple(pool.shape)}")
    if p.dtype != torch.float32 or pool.dtype != torch.float32:
        raise TypeError("the probe takes f32 inputs")
    if n_ops < 0:
        raise ValueError(f"n_ops must not be negative, got {n_ops}")
    if p.device.type == "cpu" and pool.device.type == "cpu":
        out, scal = constructs_reference(variant, p, pool, n_ops)
        return out[None].repeat(grid, 1, 1), scal[None].repeat(grid, 1)
    if p.device.type != "cuda" or pool.device != p.device:
        raise ValueError(f"the probe needs both inputs on one CUDA device "
                         f"or both on the CPU, got {p.device}, "
                         f"{pool.device}")
    if tb % 32 or not 0 < tb <= 256:
        raise ValueError(f"TB must be a multiple of 32 up to 256, got {tb}")
    return launch_packed(variant, *pack_operands(p, pool), n_ops, grid)


constructs.launches = 0   # kernel launches by this wrapper (plain excluded)


def site_error(got, want):
    """(max error relative to each site's largest entry, scaler
    mismatches) of (out [16, TB], scalers [TB]) pairs.  Where a site's
    rescue decision flipped (its largest entry within rounding of the
    threshold), out x 2^30 and scaler + 1 compensate exactly, so values
    are compared after undoing the scalers' difference."""
    (g, gs), (w, ws) = got, want
    g, w = g.double(), w.double()
    mag = w.amax(dim=0, keepdim=True).clamp_min(1e-300)
    comp = g * torch.exp2(-30.0 * (gs - ws).double())[None]
    return (((comp - w).abs() / mag).max().item(),
            int((gs != ws).sum().item()))


def _launch_ms(variant, pfrag, tiled, n_ops, grid, reps):
    """Median time of one launch (ms) over `reps` launches, CUDA events,
    after one warm-up launch."""
    launch_packed(variant, pfrag, tiled, n_ops, grid)
    times = []
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        launch_packed(variant, pfrag, tiled, n_ops, grid)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def run_probe(n_ops: int = 128, tb: int = 128, reps: int = 20, device=None,
              emit=print):
    """Check and time every variant at site block `tb` over SITES sites.
    A launch's time holds the kernel alone (operands packed beforehand);
    microseconds per op are the launch at n_ops less the launch at 0 ops
    (the pool's load, the output's store and the launch itself), over
    n_ops.  Returns a list of dicts (variant, us_per_op, ms, ms_0_ops,
    plain_ms, rel_err, abs_err, mismatches, rescues); raises if a variant
    disagrees with its plain version.  Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures the card: no CUDA device")
    device = torch.device("cuda", 0) if device is None else device
    grid = SITES // tb
    p, pool = probe_inputs(tb, device=device)
    pfrag, tiled = pack_operands(p, pool)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    rows = []
    for variant in VARIANTS:
        constructs_reference(variant, p, pool, min(n_ops, 2))    # warm up
        start.record()
        want = constructs_reference(variant, p, pool, n_ops)
        stop.record()
        stop.synchronize()
        plain_ms = start.elapsed_time(stop)
        out, scal = constructs(variant, p, pool, n_ops, grid)
        torch.cuda.synchronize()
        if not ((out == out[0]).all().item()
                and (scal == scal[0]).all().item()):
            raise RuntimeError(f"{variant}: CTAs disagree")
        err, mismatches = site_error((out[0], scal[0]), want)
        abs_err = (out[0] - want[0]).abs().max().item() if not mismatches \
            else float("nan")
        bound = tolerance(variant, n_ops)
        if not err <= bound:
            raise RuntimeError(f"{variant}: error {err} relative to the "
                               f"site's largest entry > {bound} against "
                               f"the plain version")
        ms = _launch_ms(variant, pfrag, tiled, n_ops, grid, reps)
        ms0 = _launch_ms(variant, pfrag, tiled, 0, grid, reps)
        rows.append(dict(variant=variant,
                         us_per_op=(ms - ms0) * 1e3 / max(n_ops, 1),
                         ms=ms, ms_0_ops=ms0, plain_ms=plain_ms, rel_err=err,
                         abs_err=abs_err, mismatches=mismatches,
                         rescues=int(want[1].max().item())))
        emit(f"{variant}: {ms:8.4f} ms/launch ({ms0:.4f} at 0 ops)  "
             f"{rows[-1]['us_per_op']:7.4f} us/op  rel err {err:.2e} "
             f"(bound {bound:.2e}), {mismatches} scaler mismatches, "
             f"{rows[-1]['rescues']} rescues  (plain {plain_ms:.3f} ms)")
    for a, b in zip(rows, rows[1:]):
        emit(f"{b['variant']} - {a['variant']}: "
             f"{b['us_per_op'] - a['us_per_op']:+8.4f} us/op")
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_ops = int(argv[0]) if len(argv) > 0 else 128
    tb = int(argv[1]) if len(argv) > 1 else 128
    reps = int(argv[2]) if len(argv) > 2 else 20
    if not torch.cuda.is_available():
        print("probes.constructs: torch.cuda.is_available() is False; the "
              "probe needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else torch.cuda.get_device_name(0))
    print(f"n_ops={n_ops} tb={tb} reps={reps} sites={SITES} "
          f"(grid {SITES // tb} CTAs)")
    run_probe(n_ops, tb, reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
