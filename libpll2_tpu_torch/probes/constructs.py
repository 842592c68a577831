"""The construct probe on the card: tools/static2probe.py's function, and
the tensor-core sweep's own constructs.

Counterpart of the JAX package's tools/static2probe.py, which timed four
minimal kernels over the same ops and shapes, adding one construct of a
slow sweep kernel at a time.  The same four, k0-k3 (`static2`, csrc/
construct_probe.cu's static2_probe_launch), add over `n_ops` ops w, with
pm = (7 w) % 64 and slot = w % 8, into one f32 accumulator [16, sites],
from bf16 pcm [64, 16, 96] and pool [8, 48, sites]:

  k0  pcm[pm][:, :16] . pool[slot, :16]                     (one product)
  k1  pcm[pm][:, :48] . pool[slot, :48]           (a slice of a wider row)
  k2  sum_s pcm[0][:, offs[s]:offs[s+1]] . pool[slot, :16 (s+1)],
      offs = (0, 16, 48, 96): three static column groups    (no gather)
  k3  k2 with the gathered row pcm[pm]                      (= static2)

The kernel runs them on wgmma with the pool's site tile in registers
(sites on M, 64 a warpgroup); `static2_reference` is the plain version.

Then this port's study of its own tensor-core sweep (csrc/
tree_sweep_mma.cu), c0-c4 (`constructs`, construct_probe_launch): five
variants that add the constructs of that sweep's inner loop one at a time,
over `n_ops` dependent ops at span 16 on f32 inputs, with 64 P rows and 8
pool slots, pm and slot as above; the fifth takes the costliest construct
out again the way the sweep does:

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

    python -m libpll2_tpu_torch.probes.constructs [n_ops] [tb] [reps] [sites]

prints, beside the card's name and power limit, for k0-k3 at `sites`
(65,536 by default) a line each: milliseconds a launch back to back and in
one CUDA graph, at n_ops and at 0 ops, microseconds per op, the error
against `static2_reference`, the plain version's time; then the JAX
probe's increments k1-k0, k2-k1, k3-k2 in microseconds per op.  Then for
c0-c4 at site block `tb`: microseconds per op and the increments c1-c0,
c2-c1, c3-c2, c4-c3, after checking each variant against the plain version
(`constructs_reference`: the same sums in f32 torch.matmul).
"""
from __future__ import annotations

import functools
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops.partials_tree import split_tf32
from .mma import PEAK, core_matrices, fragment_index

VARIANTS = ("c0", "c1", "c2", "c3", "c4")
SPAN = 16                # rates * states of DNA with four categories
P_ROWS = 64
N_SLOTS = 8
SITES = 65536            # columns over the whole grid: the main path's width
STATIC2_SITES = 65536    # k0-k3: distinct sites, the same width
HBM_RATE = 3.35e12       # published device-memory rate of one H100 SXM, B/s
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


# ---- k0-k3: tools/static2probe.py's function ------------------------------

K_VARIANTS = ("k0", "k1", "k2", "k3")
PCM_COLS = 96            # SPAN (1 + 2 + 3): the three column groups
POOL_ROWS = 48
GROUP_OFFS = (0, 16, 48, 96)
WG_SITES = 64            # sites of a warpgroup's tile: the wgmma's M
MAX_SITES = 2 ** 31 - WG_SITES   # sites go to the kernel as a C int
WARPGROUPS = 2           # a CTA of csrc/construct_probe.cu's k0-k3 (NWG)
# |kernel - plain| relative to each site's largest entry.  bf16 products
# are exact in f32, so only the sums differ: the kernel adds every product
# of every op into ONE accumulator, and the tensor cores round each
# addition toward zero (up to 2^-23 of the running sum, 1 to 6 products an
# op), as c1 and c2 do.
STATIC2_TOL, STATIC2_TOL_PER_OP = 2e-5, 4e-7


def static2_tolerance(n_ops: int) -> float:
    return STATIC2_TOL + STATIC2_TOL_PER_OP * n_ops


def _check_k(variant: str) -> int:
    if variant not in K_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}, not one of "
                         f"{K_VARIANTS}")
    return K_VARIANTS.index(variant)


def static2_shape(variant: str):
    """(pool rows a slot gives, pcm rows, pcm columns) the variant reads:
    k0 16 / 64 / 16, k1 48 / 64 / 48, k2 48 / 1 / 96, k3 48 / 64 / 96."""
    v = _check_k(variant)
    return ((SPAN, POOL_ROWS, POOL_ROWS, POOL_ROWS)[v],
            (P_ROWS, P_ROWS, 1, P_ROWS)[v], (SPAN, 48, PCM_COLS, PCM_COLS)[v])


def static2_work(variant: str, sites: int, n_ops: int):
    """(bytes, FLOP) of the variant: the pool rows and pcm columns it reads
    (bf16) and [16, sites] f32 written; 2 x 16 x K x sites a product, K =
    16 (k0), 48 (k1), 16 + 32 + 48 (k2, k3) an op."""
    k, rows, cols = static2_shape(variant)
    nbytes = N_SLOTS * k * sites * 2 + rows * SPAN * cols * 2 \
        + SPAN * sites * 4
    depth = (SPAN, 48, PCM_COLS, PCM_COLS)[_check_k(variant)]
    return nbytes, 2 * SPAN * depth * sites * n_ops


def static2_inputs(sites: int, seed: int = 0, device="cuda"):
    """(pcm [64, 16, 96], pool [8, 48, sites]) bf16, uniform in [0, 1) from
    numpy's generator at `seed`, as the JAX probe's np.random.rand."""
    rng = np.random.default_rng(seed)
    pcm = rng.random((P_ROWS, SPAN, PCM_COLS))
    pool = rng.random((N_SLOTS, POOL_ROWS, sites))
    return (torch.as_tensor(pcm, dtype=torch.float32, device=device)
            .to(torch.bfloat16),
            torch.as_tensor(pool, dtype=torch.float32, device=device)
            .to(torch.bfloat16))


def static2_reference(variant: str, pcm, pool, n_ops: int = 128):
    """Plain version -> [16, sites] f32: the JAX kernel's sums on the bf16
    operands taken to f32 (exactly), torch.matmul per op and column group,
    the groups of k2 / k3 added first, then the op into one accumulator in
    w order."""
    v = _check_k(variant)
    p, x = pcm.float(), pool.float()
    acc = torch.zeros((SPAN, x.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for w in range(n_ops):
        pm, slot = (w * 7) % P_ROWS, w % N_SLOTS
        if v < 2:
            depth = SPAN if v == 0 else 48
            acc += p[pm][:, :depth] @ x[slot, :depth]
            continue
        row = p[0 if v == 2 else pm]
        d = None
        for s in range(3):
            t = row[:, GROUP_OFFS[s]:GROUP_OFFS[s + 1]] \
                @ x[slot, :SPAN * (s + 1)]
            d = t if d is None else d + t
        acc += d
    return acc


@functools.cache
def _fragment_order(k: int) -> np.ndarray:
    """[k/16, 4 warps, 32 lanes, 4 registers, 2] index into a slot's site
    tile [k, 64] flattened: the A fragment of wgmma m64n16k16 (warp w holds
    sites 16 w..16 w + 15; register r of lane (g, q) holds site 16 w + g
    (+ 8 for odd r) at k = 16 ks + 2 q (+ 8 for r >= 2) and k + 1)."""
    ks, w, lane, r, h = np.meshgrid(np.arange(k // 16), np.arange(4),
                                    np.arange(32), np.arange(4),
                                    np.arange(2), indexing="ij")
    g, q = lane // 4, lane % 4
    kk = 16 * ks + 2 * q + 8 * (r >> 1) + h
    m = 16 * w + g + 8 * (r & 1)
    return (kk * WG_SITES + m).astype(np.int64)


def pack_static2(variant: str, pcm, pool):
    """The operands in the layouts static2_probe_launch reads -> (b_cm,
    a_frag): pcm's staged rows and columns as K-major core matrices
    [rows, 2, cols / 8, 8, 8] bf16, and the pool's A fragments [sites / 64,
    8 slots, k / 16, 4 warps, 32 lanes, 4] int32 (two bf16 a word, the
    lower k in the low half): each thread's 16-byte words of a tile, in the
    order the warpgroup loads them."""
    k, rows, cols = static2_shape(variant)
    b_cm = core_matrices(pcm[:rows, :, :cols], "bf16")
    tiles = pool.shape[-1] // WG_SITES
    x = pool[:, :k].reshape(N_SLOTS, k, tiles, WG_SITES).permute(2, 0, 1, 3)
    idx = torch.as_tensor(_fragment_order(k), device=pool.device)
    frag = x.reshape(tiles, N_SLOTS, k * WG_SITES)[:, :, idx]
    return b_cm, frag.contiguous().view(torch.int32).squeeze(-1)


# the C entry point and its library, looked up once per library (None: the
# package's own), so that a launch pays for no lookup
_ENTRIES: dict = {}


def _static2_entry(lib):
    found = _ENTRIES.get(lib)
    if found is None:
        from .. import _build
        library = _build.library() if lib is None else lib
        found = _ENTRIES[lib] = (library.static2_probe_launch, library)
    return found


def launch_static2(variant: str, b_cm, a_frag, out, n_ops: int = 128,
                   lib=None):
    """The kernel on operands pack_static2 made, into `out` [16, sites] f32
    on their device (`static2` checks the arguments), from `lib` (a library
    of _build.library; default the package's own).  Returns `out`."""
    v = _check_k(variant)
    launch, library = _static2_entry(lib)
    device = out.device
    args = (v, a_frag.data_ptr(), b_cm.data_ptr(), out.data_ptr(),
            out.shape[1], n_ops)
    if device.index == torch.cuda.current_device():
        err = launch(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = launch(*args,
                         torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"static2 probe kernel launch failed ({variant}): CUDA error "
            f"{err} ({library.tree_sweep_error_string(err).decode()})")
    static2.launches += 1
    return out


def static2(variant: str, pcm, pool, n_ops: int = 128, lib=None):
    """Variant `variant` of the JAX probe -> [16, sites] f32: the kernel on
    CUDA tensors (operands packed by pack_static2), the plain version on
    CPU tensors.  bf16 pcm [64, 16, 96] and pool [8, 48, sites], sites a
    positive multiple of 64."""
    _check_k(variant)
    if pcm.dtype != torch.bfloat16 or pool.dtype != torch.bfloat16:
        raise TypeError(f"the probe takes bf16 inputs, got {pcm.dtype} and "
                        f"{pool.dtype}")
    if tuple(pcm.shape) != (P_ROWS, SPAN, PCM_COLS) or pool.dim() != 3 \
            or tuple(pool.shape[:2]) != (N_SLOTS, POOL_ROWS):
        raise ValueError(f"the probe takes pcm [{P_ROWS}, {SPAN}, "
                         f"{PCM_COLS}] and a pool [{N_SLOTS}, {POOL_ROWS}, "
                         f"sites], got {tuple(pcm.shape)} and "
                         f"{tuple(pool.shape)}")
    sites = pool.shape[-1]
    if sites <= 0 or sites % WG_SITES or sites > MAX_SITES:
        raise ValueError(f"sites must be a positive multiple of {WG_SITES} "
                         f"up to {MAX_SITES}, got {sites}")
    if n_ops < 0:
        raise ValueError(f"n_ops must not be negative, got {n_ops}")
    if pcm.device.type == "cpu" and pool.device.type == "cpu":
        return static2_reference(variant, pcm, pool, n_ops)
    if pcm.device.type != "cuda" or pool.device != pcm.device:
        raise ValueError(f"the probe needs both inputs on one CUDA device "
                         f"or both on the CPU, got {pcm.device}, "
                         f"{pool.device}")
    b_cm, a_frag = pack_static2(variant, pcm, pool)
    out = torch.empty((SPAN, sites), dtype=torch.float32, device=pool.device)
    return launch_static2(variant, b_cm, a_frag, out, n_ops, lib)


static2.launches = 0   # kernel launches by this wrapper (plain excluded)


def static2_error(got, want) -> float:
    """max |got - want| relative to each site's largest |want| ([16, sites])."""
    g, w = got.double(), want.double()
    mag = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-300)
    return ((g - w).abs() / mag).max().item()


def static2_smem_bytes(variant: str, a_in_registers: bool = True) -> int:
    """Dynamic shared memory of a launch: pcm's staged part and a zero row
    of it, and with A in shared memory (static2_smem_a) each warpgroup's 8
    slot tiles."""
    k, rows, cols = static2_shape(variant)
    return (rows + 1) * SPAN * cols * 2 + (
        0 if a_in_registers else WARPGROUPS * N_SLOTS * WG_SITES * k * 2)


def back_to_back_ms(fn, n: int) -> float:
    """Device time (ms) of one call: after one call to warm up, `n` calls
    launched back to back between one pair of CUDA events, over n."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def graph_ms(fn, n: int, replays: int = 5) -> float:
    """Device time (ms) of one call with no host launch: `n` calls captured
    in one CUDA graph, the median of `replays` replays over n."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(n):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / n)
    return statistics.median(times)


def run_static2(n_ops: int = 128, sites: int = STATIC2_SITES, reps: int = 50,
                device=None, emit=print):
    """Check and time k0-k3 over `sites` distinct sites: each variant
    against static2_reference first, then the kernel alone (operands packed
    beforehand, `reps` launches) back to back and in one CUDA graph, at
    n_ops and at 0 ops; microseconds per op are (t(n_ops) - t(0)) / n_ops
    (the launch, the pool's load and the store cancel).  Returns a list of
    dicts (variant, ms, ms_0_ops, graph_ms, graph_ms_0_ops, us_per_op,
    graph_us_per_op, pack_ms, plain_ms, rel_err, abs_err, bound_ms,
    bound_by); raises if a variant disagrees with its plain version.
    Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures the card: no CUDA device")
    device = torch.device("cuda", 0) if device is None else device
    pcm, pool = static2_inputs(sites, device=device)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    rows = []
    for variant in K_VARIANTS:
        static2_reference(variant, pcm, pool, 2)                 # warm up
        start.record()
        want = static2_reference(variant, pcm, pool, n_ops)
        stop.record()
        stop.synchronize()
        plain_ms = start.elapsed_time(stop)
        got = static2(variant, pcm, pool, n_ops)
        torch.cuda.synchronize()
        err = static2_error(got, want)
        bound = static2_tolerance(n_ops)
        if not err <= bound:
            raise RuntimeError(f"{variant}: error {err} relative to the "
                               f"site's largest entry > {bound} against "
                               f"the plain version")
        pack_ms = back_to_back_ms(
            lambda: pack_static2(variant, pcm, pool), 5)
        b_cm, a_frag = pack_static2(variant, pcm, pool)
        out = torch.empty_like(got)
        times = {}
        for ops in (n_ops, 0):
            def call():
                return launch_static2(variant, b_cm, a_frag, out, ops)
            times[ops] = (back_to_back_ms(call, reps), graph_ms(call, reps))
        nbytes, flops = static2_work(variant, sites, n_ops)
        bytes_ms, ops_ms = nbytes / HBM_RATE * 1e3, flops / PEAK["bf16"] * 1e3
        per_op = [(times[n_ops][i] - times[0][i]) * 1e3 / max(n_ops, 1)
                  for i in (0, 1)]
        rows.append(dict(
            variant=variant, ms=times[n_ops][0],
            ms_0_ops=times[0][0], graph_ms=times[n_ops][1],
            graph_ms_0_ops=times[0][1], us_per_op=per_op[0],
            graph_us_per_op=per_op[1], pack_ms=pack_ms, plain_ms=plain_ms,
            rel_err=err, abs_err=(got - want).abs().max().item(),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations"))
        r = rows[-1]
        emit(f"{variant}: {sites} sites, {n_ops} ops: {r['ms']:.4f} ms a "
             f"launch back to back ({r['ms_0_ops']:.4f} at 0 ops), "
             f"{r['graph_ms']:.4f} in a CUDA "
             f"graph ({r['graph_ms_0_ops']:.4f} at 0 ops); "
             f"{r['graph_us_per_op']:.4f} us/op in the graph "
             f"({r['us_per_op']:.4f} back to back); bound "
             f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
             f"{r['bound_ms'] / r['graph_ms']:.3f} of it in the graph; rel "
             f"err {err:.2e} (bound {bound:.2e}); packing {pack_ms:.4f} ms; "
             f"plain {plain_ms:.3f} ms")
    for a, b in zip(rows, rows[1:]):
        emit(f"{b['variant']} - {a['variant']}: "
             f"{b['graph_us_per_op'] - a['graph_us_per_op']:+8.4f} us/op in "
             f"the graph ({b['us_per_op'] - a['us_per_op']:+8.4f} back to "
             f"back)")
    return rows


# ---- c0-c4: the tensor-core sweep's constructs ---------------------------


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
    sites = int(argv[3]) if len(argv) > 3 else STATIC2_SITES
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
    print(f"k0-k3 (tools/static2probe.py): n_ops={n_ops} sites={sites} "
          f"reps={reps}")
    run_static2(n_ops, sites, reps)
    print(f"c0-c4 (the tensor-core sweep's constructs): n_ops={n_ops} "
          f"tb={tb} reps={reps} sites={SITES} (grid {SITES // tb} CTAs)")
    run_probe(n_ops, tb, reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
