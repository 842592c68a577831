"""All-edge Newton smoothing of one colour class on the card: one CUDA
kernel launch (csrc/newton_edges.cu) builds each edge's sumtable from its
two message rows, runs the Newton steps on it, evaluates the f32 keep and
writes the edge's length into the branch-length vector in place.

It computes what engine._optimize_branch_lengths' plain path computes for
one partition and one colour class (the class's edges share no node):

    st[r*S+j, t] = (ML[r] @ clv_a[r])[j, t] * (EV[r] @ clv_b[r])[j, t]
                                          (derivatives.update_sumtable)
    newton_iters steps from t = bl[e] on the pattern-weighted sums of
    (-L'/L, (L'/L)^2 - L''/L) over live sites, L^(n) = sum st x^n w0
    e^{x t} (derivatives.likelihood_derivatives), each step
    derivatives.newton_update(..., hold_nonfinite=False): a NaN step
    stays NaN
    bl[e] = t where the edge's pattern-weighted logL at t is finite, else
    the start (engine._finite_or_start)

with ML, EV, x and w0 as ops/edge_score.model_constants lays them out.

`newton_edges` is the wrapper, which launches the kernel on CUDA tensors
and raises on others; `newton_edges_reference` is its plain version (the
same contract, f32 or f64, on any device).  The kernel is the edge
scorer's resident form (csrc/newton_passes.cuh): an edge is smoothed by a
thread-block cluster of k CTAs, each keeping its stripe of the sumtable in
shared memory, the passes' sums added across the cluster in stripe order
(`newton_edges_reference(..., stripes=k)` sums in that order); `plan`
picks k as edge_score.plan does.

Contract (engine.newton_choice takes the plain path otherwise): f32, one
partition, per-site scalers, no ascertainment bias, no invariant-marked
site (+I enters only through prop_invar in x and w0), 2 to 32 states, and
a stripe that fits one CTA's shared memory at some k <= 8.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import edge_score
from .derivatives import newton_update
from .partials_tree import MAX_STATES, MIN_STATES, SMEM_LIMIT

# edge-row columns the kernel reads (engine.FullTreeProgram.edge_rows)
ROW_A, ROW_B = 0, 2


def smem_bytes(rate_cats: int, states: int, sites: int,
               cluster: int) -> int:
    """Dynamic shared memory of one CTA at `cluster` CTAs an edge
    (csrc/newton_edges.cu:newton_edges_smem): the sums of every warp of
    the cluster [2, 8 CTAs, 8 warps, 2], the e-terms [8 warps, R*S, 4],
    the constants ML, EV [R, S, S] and x, w0 [R*S], rounded up to 16 bytes,
    then the stripe of the sumtable [R*S, ceil(sites / cluster)], all
    f32."""
    span = rate_cats * states
    head = 256 + 32 * span + 2 * rate_cats * states * states + 2 * span
    head = -(-head // 4) * 4
    return 4 * (head + span * -(-sites // cluster))


def plan(rate_cats: int, states: int, sites: int,
         smem_limit: int = SMEM_LIMIT) -> Optional[int]:
    """CTAs an edge: the smallest cluster whose CTA fits as edge_score.plan
    sizes the scorer's (edge_score.resident_cluster), or None where no
    stripe fits a CTA even at the largest."""
    return edge_score.resident_cluster(
        lambda k: smem_bytes(rate_cats, states, sites, k), smem_limit)


def unsupported(rate_cats: int, states: int, sites: int,
                smem_limit: int = SMEM_LIMIT) -> Optional[str]:
    """Why the kernel cannot take this shape, or None if it can."""
    if not MIN_STATES <= states <= MAX_STATES:
        return (f"the Newton kernel takes {MIN_STATES} to {MAX_STATES} "
                f"states, got {states}")
    if plan(rate_cats, states, sites, smem_limit) is None:
        k = edge_score.CLUSTER_SIZES[-1]
        return (f"at {rate_cats} rates, {states} states and {sites} sites "
                f"a stripe of the sumtable on {k} CTAs needs "
                f"{smem_bytes(rate_cats, states, sites, k)} bytes of shared "
                f"memory, above the {smem_limit}-byte limit")
    return None


def _check(clv, edge_rows, members, bl, lbd, rbd, xw, pw):
    if clv.dim() != 4:
        raise ValueError(f"clv must be [rows, R, S, T], got "
                         f"{tuple(clv.shape)}")
    _, R, S, T = clv.shape
    span = R * S
    shapes = {
        "edge_rows": (edge_rows, (bl.shape[0], 4)),
        "members": (members, (members.shape[0],)),
        "bl": (bl, (edge_rows.shape[0],)),
        "lbd": (lbd, (span, span)),
        "rbd": (rbd, (span, span)),
        "xw": (xw, (span, 2)),
        "pw": (pw, (T,)),
    }
    for name, (x, want) in shapes.items():
        if tuple(x.shape) != want:
            raise ValueError(f"{name} {tuple(x.shape)} is not {want}")
    for name, x in (("edge_rows", edge_rows), ("members", members)):
        if x.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {x.dtype}")
    if clv.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"clv must be f32 or f64, got {clv.dtype}")
    for name, x in (("bl", bl), ("lbd", lbd), ("rbd", rbd), ("xw", xw),
                    ("pw", pw)):
        if x.dtype != clv.dtype:
            raise TypeError(f"{name} must be {clv.dtype} as clv is, got "
                            f"{x.dtype}")


def newton_edges_reference(clv, edge_rows, members, bl, lbd, rbd, xw, pw, *,
                           newton_iters: int, min_branch: float,
                           max_branch: float, stripes: int = 1):
    """Plain PyTorch version of the kernel (newton_edges' contract: bl
    updated in place at `members` and returned).  stripes=k takes every
    sum over the sites as the kernel's cluster of k CTAs does: one sum per
    stripe of ceil(T / k) sites, the k sums added in stripe order."""
    _check(clv, edge_rows, members, bl, lbd, rbd, xw, pw)
    if stripes < 1:
        raise ValueError(f"stripes must be at least 1, got {stripes}")
    _, R, S, T = clv.shape
    stripe = -(-T // stripes)

    def site_sum(x):
        total = x[..., :stripe].sum(dim=-1)
        for start in range(stripe, T, stripe):
            total = total + x[..., start:start + stripe].sum(dim=-1)
        return total

    rows = edge_rows[members]
    blocks = torch.arange(R, device=clv.device)
    ml = lbd.reshape(R, S, R, S)[blocks, :, blocks]             # [R, S, S]
    ev = rbd.reshape(R, S, R, S)[blocks, :, blocks]
    st = (torch.einsum("rjk,nrkt->nrjt", ml, clv[rows[:, ROW_A]])
          * torch.einsum("rjk,nrkt->nrjt", ev, clv[rows[:, ROW_B]])
          ).reshape(len(members), R * S, T)
    x, w0 = xw[:, 0], xw[:, 1]
    live = pw > 0
    zero = torch.zeros((), dtype=pw.dtype, device=pw.device)
    one = torch.ones((), dtype=pw.dtype, device=pw.device)

    def lks(t):
        a0 = w0 * torch.exp(x * t[:, None])                     # [n, span]
        return (torch.einsum("nst,ns->nt", st, a0),
                torch.einsum("nst,ns->nt", st, x * a0),
                torch.einsum("nst,ns->nt", st, x * x * a0))

    def weighted(v):
        return site_sum(torch.where(live, pw * v, zero))

    start = bl[members]
    t = start
    for _ in range(newton_iters):
        lk0, lk1, lk2 = lks(t)
        safe0 = torch.where(live, lk0, one)
        deriv1 = -lk1 / safe0
        deriv2 = deriv1 * deriv1 - lk2 / safe0
        t = newton_update(t, weighted(deriv1), weighted(deriv2), min_branch,
                          max_branch, hold_nonfinite=False)
    logl = weighted(torch.log(torch.where(live, lks(t)[0], one)))
    bl[members] = torch.where(torch.isfinite(logl), t, start)
    return bl


def newton_edges(clv, edge_rows, members, bl, lbd, rbd, xw, pw, *,
                 newton_iters: int, min_branch: float, max_branch: float):
    """Smooth the edges `members` of one colour class in one kernel launch
    on `plan`'s cluster; raises on inputs the kernel does not take (CPU
    tensors and f64 among them).

    clv:        [rows, R, S, T] f32 message rows (engine._sweep_all's)
    edge_rows:  [E, 4] int64 (rowA, scalA, rowB, scalB) of every branch
    members:    [n] int64 the class's branch positions, no two alike
    bl:         [E] f32 branch lengths: the starts, overwritten at
                `members` with the smoothed lengths
    lbd, rbd, xw: edge_score.model_constants; pw: [T] f32 pattern weights
    Returns bl."""
    tensors = (clv, edge_rows, members, bl, lbd, rbd, xw, pw)
    device = clv.device
    if clv.dim() == 4 and not MIN_STATES <= clv.shape[2] <= MAX_STATES:
        raise ValueError(f"the Newton kernel cannot take this case: "
                         f"{unsupported(clv.shape[1], clv.shape[2], 1)}")
    if device.type != "cuda" or any(x.device != device for x in tensors):
        raise ValueError("Newton kernel inputs must all lie on one CUDA "
                         "device, got "
                         f"{sorted({str(x.device) for x in tensors})}")
    _check(*tensors)
    if clv.dtype != torch.float32:
        raise TypeError(f"the Newton kernel computes f32, got {clv.dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("Newton kernel inputs must be contiguous")
    _, R, S, T = clv.shape
    limit = edge_score.smem_limit_of(device)
    reason = unsupported(R, S, T, limit)
    if reason is not None:
        raise ValueError(f"the Newton kernel cannot take this case: "
                         f"{reason}")
    cluster = plan(R, S, T, limit)
    from .. import _build

    with torch.cuda.device(device):
        err = _build.library().newton_edges_launch(
            clv.data_ptr(), edge_rows.data_ptr(), members.data_ptr(),
            members.shape[0], bl.data_ptr(), lbd.data_ptr(), rbd.data_ptr(),
            xw.data_ptr(), pw.data_ptr(), R, S, T, newton_iters,
            ctypes.c_float(min_branch), ctypes.c_float(max_branch), cluster,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"newton_edges kernel launch failed (cluster "
                           f"{cluster}): CUDA error {err} "
                           f"({_build.error_string(err)})")
    newton_edges.launches += 1
    return bl


# kernel launches by this wrapper
newton_edges.launches = 0
