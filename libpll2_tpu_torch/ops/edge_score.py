"""Fused SPR edge scorer: sumtable + Newton + logL per regraft slot.

Counterpart of libpll2_tpu/ops/edge_score_pallas.py.  The SPR search's
inner loop prices one (prune candidate, regraft edge) pair: build the
edge's branch-invariant sumtable, run a few Newton steps on the
attachment branch, and evaluate the log-likelihood at the refined length
(pll_update_sumtable_ii + pll_core_likelihood_derivatives + the cat0
likelihood tail, core_derivatives.c:321-929).  Per slot and site:

    st[r, j] = (ML[r] @ ((H[r] @ away[r]) * (H[r] @ other[r])))[j]
             * (EV[r] @ sub[r])[j]

      H   the regraft edge's half-branch P matrices
      ML  inv_eigenvecs^T * diag(freqs)   (per rate category)
      EV  eigenvecs                       (per rate category)

then newton_iters safeguarded Newton steps on t from the pattern-weighted
site sums of (-L'/L, (L'/L)^2 - L''/L), with L^(k) = Σ st·w0·x^k·e^{x t}
(x = eigenvalue·rate/(1-pinv), w0 = rate weight·(1-pinv)), and the final
score Σ w·(log L + scalers·log_thresh).

`edge_scores` is the wrapper: a CUDA kernel (csrc/edge_score.cu) on CUDA
tensors, the plain version `edge_scores_reference` on CPU tensors.  Unlike
the Pallas wrapper, it takes the base message rows, the half-P matrices
and the scaler rows as they are and gathers them by the slot's op row, and
it starts Newton from the real branch length (Pallas pre-gathers in slot
order and quantizes t0 to 1e-7 only because Mosaic lacks dynamic row
indices and SMEM bitcasts).

The kernel has two forms, and `plan` picks one on the host from the shape
and the device's shared memory:

  * "resident": a slot is scored by a thread-block cluster of k CTAs, each
    keeping its stripe of the sumtable st [R*S, ceil(T / k)] in shared
    memory, so the message rows are read once and the Newton passes read
    st only; the passes' sums are added across the cluster in stripe order
    (`edge_scores_reference(..., stripes=k)` sums in that order);
  * "reread": one CTA per slot recomputes st from the rows in every pass;
    it serves the shapes whose stripe does not fit a block at k = 8.

Both forms take every state count from 2 to 32 (an int32 tip mask), as
the Pallas kernel does: 2, 4, 10, 16 and 20 states have instantiations of
their own, every other count a generic-state one whose pass 0 holds each
thread's site columns in registers and whose later passes (resident form)
read four sites a thread where the alignment allows.  `unsupported`
says where neither form fits the device's shared memory; the wrapper and
the SPR search's gate (search_fast.use_edge_kernel) both ask it.

Neither form stands in for the other after a failure: a build or launch
error raises.

Contract (the caller takes the plain scorer otherwise): f32, per-site
scalers, no ascertainment bias, no invariant-marked site (+I enters only
through prop_invar in x and w0).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .derivatives import newton_update
from .partials_tree import FMA_STATES, MAX_STATES, MIN_STATES, SMEM_LIMIT

# score-op columns the scorer reads (search_fast.BOP_*)
OP_COLS = 12
OP_PARENT, OP_SC_ROW, OP_SC_SCAL, OP_EDGE, OP_VALID = 0, 8, 9, 10, 11
FORMS = ("resident", "reread")
# CTAs per slot the resident form may run on: a cluster of up to 8 is
# portable on sm_90
CLUSTER_SIZES = (1, 2, 4, 8)
# The resident form's stripe is sized so that this many CTAs fit one SM's
# shared memory where a cluster size allows it (the kernel's registers let
# two run, and a third stripe's room costs nothing); else the largest
# stripe that fits a block alone.  Measured on an H100 at 700 W over a
# full-width round (256 taxa x 4,096 sites, radius 5; probes/variants.py
# passes): clusters of 4 (68 KB a CTA) 7.5 ms, of 2 (131 KB, one CTA an
# SM) 8.5 ms, of 8 (half the threads idle at four sites a thread) 13.2 ms.
RESIDENT_CTAS_PER_SM = 3
# threads of a CTA of either form (csrc/newton_passes.cuh THREADS)
THREADS = 256


def resident_smem_bytes(rate_cats: int, states: int, sites: int,
                        cluster: int) -> int:
    """Dynamic shared memory of one CTA of the resident form at `cluster`
    CTAs per slot (csrc/edge_score.cu:edge_score_resident_smem): the sums
    of every warp of the cluster [2, 8 CTAs, 8 warps, 2], the e-terms
    [8 warps, R*S, 4], the constants H, ML, EV [R, S, S] and x, w0 [R*S],
    rounded up to 16 bytes, then the stripe of the sumtable
    [R*S, ceil(sites / cluster)], all f32."""
    span = rate_cats * states
    head = 256 + 32 * span + 3 * rate_cats * states * states + 2 * span
    head = -(-head // 4) * 4
    stripe = -(-sites // cluster)
    return 4 * (head + span * stripe)


def reread_smem_bytes(rate_cats: int, states: int) -> int:
    """Dynamic shared memory of one CTA of the re-reading form
    (csrc/edge_score.cu:edge_score_reread_smem): the warp sums [8, 2], the
    e-terms [R*S, 4], the constants H, ML, EV [R, S, S] and x, w0 [R*S],
    all f32."""
    span = rate_cats * states
    return 4 * (16 + 4 * span + 3 * rate_cats * states * states + 2 * span)


def resident_cluster(cta_bytes, smem_limit: int = SMEM_LIMIT):
    """The smallest cluster in CLUSTER_SIZES whose CTA needs at most
    smem_limit / RESIDENT_CTAS_PER_SM bytes (`cta_bytes(k)`: a CTA's
    shared memory at k CTAs), so that CTAs of several clusters share an SM
    and hide each other's latency; failing that, the smallest whose CTA
    fits `smem_limit` at all; None where even the largest does not fit.
    The edge scorer's resident form and the Newton smoothing
    (ops/newton_edges.py) size their clusters so."""
    for budget in (smem_limit // RESIDENT_CTAS_PER_SM, smem_limit):
        for k in CLUSTER_SIZES:
            if cta_bytes(k) <= budget:
                return k
    return None


def plan(rate_cats: int, states: int, sites: int,
         smem_limit: int = SMEM_LIMIT) -> tuple:
    """(form, cluster) of the kernel for this shape: "resident" on
    `resident_cluster`'s cluster; ("reread", 0) where even the largest
    cluster does not fit (`unsupported` says whether that form fits)."""
    k = resident_cluster(
        lambda k: resident_smem_bytes(rate_cats, states, sites, k),
        smem_limit)
    return ("reread", 0) if k is None else ("resident", k)


def unsupported(rate_cats: int, states: int,
                smem_limit: int = SMEM_LIMIT) -> Optional[str]:
    """Why the edge scorer's kernel cannot take this shape, or None if it
    can: a state count outside 2..32, or the re-reading form's constants
    above `smem_limit` bytes of shared memory.  A CTA of
    the resident form always needs more than one of the re-reading form,
    so the site count cannot change the answer: where no stripe fits,
    `plan` picks the re-reading form."""
    if not MIN_STATES <= states <= MAX_STATES:
        return (f"the edge scorer takes {MIN_STATES} to {MAX_STATES} states "
                f"(an int32 tip mask), got {states}")
    need = reread_smem_bytes(rate_cats, states)
    if need > smem_limit:
        return (f"at {rate_cats} rates and {states} states the re-reading "
                f"form needs {need} bytes of shared memory, above the "
                f"{smem_limit}-byte limit")
    return None


def smem_limit_of(device: torch.device) -> int:
    """The shared memory a block may opt in to on `device`: the card's
    own where `device` is a CUDA device of this process, else SMEM_LIMIT
    (an H100's), so that a gate asked about a CUDA device without one
    present answers as it would on the card."""
    if device.type == "cuda" and torch.cuda.is_available():
        from .. import _build
        return _build.max_shared_memory(device)
    return SMEM_LIMIT


def model_constants(model, cfg):
    """(L_bd, R_bd [span, span], xw [span, 2]) f32: the block-diagonal
    per-category ML and EV matrices and, per (rate, state), x | w0 — the
    JAX package's layout."""
    return block_constants(model, cfg, torch.float32)


def block_constants(model, cfg, dtype):
    """model_constants in `dtype` (the Newton smoothing's plain version
    takes f64 as well as f32)."""
    R, S = cfg.rate_cats, cfg.states
    idx = model.params_indices.long()
    evecs = model.eigenvecs[idx].to(dtype)                      # [R, S, S]
    inv_evecs = model.inv_eigenvecs[idx].to(dtype)
    freqs = model.cat_freqs.to(dtype)                           # [R, S]
    evals = model.eigenvals[idx].to(dtype)                      # [R, S]
    pinv = model.cat_pinv.to(dtype)                             # [R]
    rw = model.rate_weights.to(dtype)                           # [R]
    rates = model.rates.to(dtype)

    # ML[r][j, k] = inv_evecs[r][k, j] * freqs[r][k]; block-diagonal
    # layout: out[r*S+j, q*S+k] = M[r, j, k] * (r == q)
    ml = torch.einsum("rkj,rk->rjk", inv_evecs, freqs)
    eye = torch.eye(R, dtype=dtype, device=evecs.device)
    lbd = torch.einsum("rjk,rq->rjqk", ml, eye).reshape(R * S, R * S)
    rbd = torch.einsum("rjk,rq->rjqk", evecs, eye).reshape(R * S, R * S)
    ki = rates / (1.0 - pinv)                                   # [R]
    x = (evals * ki[:, None]).reshape(R * S)
    pf = torch.where(pinv > 0, 1.0 - pinv, torch.ones_like(pinv))
    w0 = torch.repeat_interleave(rw * pf, S)
    return lbd.contiguous(), rbd.contiguous(), \
        torch.stack([x, w0], dim=1).contiguous()


def _check(away, away_scal, base, base_scal, halves, score_ops, sub_rows,
           t0, lbd, rbd, xw, pw):
    if away.dim() != 5:
        raise ValueError(f"away must be [Cb, slots, R, S, T], got "
                         f"{tuple(away.shape)}")
    cb, slots, R, S, T = away.shape
    span = R * S
    shapes = {
        "away_scal": (away_scal, (cb, slots, T)),
        "base_scal": (base_scal, (base_scal.shape[0], T)),
        "base": (base, (base.shape[0], R, S, T)),
        "halves": (halves, (halves.shape[0], R, S, S)),
        "score_ops": (score_ops, (cb, score_ops.shape[1], OP_COLS)),
        "sub_rows": (sub_rows, (cb, 2)),
        "t0": (t0, (cb,)),
        "lbd": (lbd, (span, span)),
        "rbd": (rbd, (span, span)),
        "xw": (xw, (span, 2)),
        "pw": (pw, (T,)),
    }
    for name, (x, want) in shapes.items():
        if tuple(x.shape) != want:
            raise ValueError(f"{name} {tuple(x.shape)} is not {want}")
    for name, x in (("away_scal", away_scal), ("base_scal", base_scal),
                    ("score_ops", score_ops), ("sub_rows", sub_rows)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    for name, x in (("away", away), ("base", base), ("halves", halves),
                    ("t0", t0), ("lbd", lbd), ("rbd", rbd), ("xw", xw),
                    ("pw", pw)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be f32, got {x.dtype}")


def edge_scores_reference(away, away_scal, base, base_scal, halves,
                          score_ops, sub_rows, t0, lbd, rbd, xw, pw, *,
                          newton_iters: int, log_thresh: float,
                          stripes: int = 1):
    """Plain PyTorch version of the edge scorer (same contract and output
    as edge_scores).  stripes=k takes every sum over the sites as the
    resident form's cluster of k CTAs does: one sum per stripe of
    ceil(T / k) sites, the k sums added in stripe order."""
    _check(away, away_scal, base, base_scal, halves, score_ops, sub_rows,
           t0, lbd, rbd, xw, pw)
    if stripes < 1:
        raise ValueError(f"stripes must be at least 1, got {stripes}")
    cb, _, R, S, T = away.shape
    stripe = -(-T // stripes)

    def site_sum(x):
        total = x[..., :stripe].sum(dim=-1)
        for start in range(stripe, T, stripe):
            total = total + x[..., start:start + stripe].sum(dim=-1)
        return total

    ops = score_ops.long()
    vg = ops.shape[1]
    ar = torch.arange(cb, device=away.device)[:, None]
    blocks = torch.arange(R, device=away.device)
    ml = lbd.reshape(R, S, R, S)[blocks, :, blocks]             # [R, S, S]
    ev = rbd.reshape(R, S, R, S)[blocks, :, blocks]
    h = halves[ops[..., OP_EDGE]]                               # [cb,V,R,S,S]
    ta = torch.einsum("cvrij,cvrjt->cvrit", h, away[ar, ops[..., OP_PARENT]])
    tb = torch.einsum("cvrij,cvrjt->cvrit", h, base[ops[..., OP_SC_ROW]])
    lef = torch.einsum("rjk,cvrkt->cvrjt", ml, ta * tb)
    del ta, tb
    sub = base[sub_rows[:, 0].long()]                           # [cb,R,S,T]
    rig = torch.einsum("rjk,crkt->crjt", ev, sub)[:, None]
    st = (lef * rig).reshape(cb, vg, R * S, T)
    del lef
    x, w0 = xw[:, 0], xw[:, 1]
    live = pw > 0
    wlive = torch.where(live, pw, torch.zeros_like(pw))
    one = torch.ones((), dtype=pw.dtype, device=pw.device)

    def lks(t):
        a0 = w0 * torch.exp(x * t[..., None])                  # [cb, V, span]
        return (torch.einsum("cvst,cvs->cvt", st, a0),
                torch.einsum("cvst,cvs->cvt", st, x * a0),
                torch.einsum("cvst,cvs->cvt", st, x * x * a0))

    t = t0[:, None].expand(cb, vg)
    for _ in range(newton_iters):
        lk0, lk1, lk2 = lks(t)
        safe0 = torch.where(live, lk0, one)
        deriv1 = -lk1 / safe0
        deriv2 = deriv1 * deriv1 - lk2 / safe0
        t = newton_update(t, site_sum(wlive * deriv1),
                          site_sum(wlive * deriv2))
    lk0 = lks(t)[0]
    scal = (away_scal[ar, ops[..., OP_PARENT]]
            + base_scal[ops[..., OP_SC_SCAL]]
            + base_scal[sub_rows[:, 1].long()][:, None]).to(torch.float32)
    site_lk = torch.log(torch.where(live, lk0, one)) + scal * log_thresh
    score = site_sum(wlive * site_lk)
    valid = ops[..., OP_VALID] == 1
    return (torch.where(valid, score, torch.full_like(score, -float("inf"))),
            torch.where(valid, t, t0[:, None].expand(cb, vg)))


def edge_scores(away, away_scal, base, base_scal, halves, score_ops,
                sub_rows, t0, lbd, rbd, xw, pw, *, newton_iters: int,
                log_thresh: float, form: Optional[str] = None):
    """Score every slot of Cb candidates: a CUDA kernel on CUDA tensors,
    the plain version (edge_scores_reference) on CPU tensors.

    away:      [Cb, slots, R, S, T] f32 ball scratch (slot v of candidate c
               holds the away message of the op writing it)
    away_scal: [Cb, slots, T] int32 its scalers
    base:      [rows, R, S, T] f32 base message rows
    base_scal: [srows, T] int32 base scaler rows
    halves:    [E, R, S, S] f32 half-branch P matrices
    score_ops: [Cb, Vg, 12] int32 score slots (search_fast.BOP_* columns:
               PARENT, SC_ROW, SC_SCAL, EDGE and VALID are read)
    sub_rows:  [Cb, 2] int32 pruned-subtree (message row, scaler row)
    t0:        [Cb] f32 Newton start (clipped to [1e-8, 100] by the caller)
    lbd, rbd, xw: model_constants; pw: [T] f32 pattern weights
    form:      which kernel form runs on CUDA tensors: None for what `plan`
               says of the shape; "resident" or "reread" for that form, or
               a ValueError where it cannot take the shape
    Returns (scores [Cb, Vg], t3 [Cb, Vg]) f32; invalid slots score -inf
    with t3 = t0.
    """
    tensors = (away, away_scal, base, base_scal, halves, score_ops,
               sub_rows, t0, lbd, rbd, xw, pw)
    if form is not None and form not in FORMS:
        raise ValueError(f"unknown edge scorer form {form!r}, not one of "
                         f"{FORMS}")
    if away.dim() == 5 and not MIN_STATES <= away.shape[3] <= MAX_STATES:
        raise ValueError(f"the edge scorer cannot take this case: "
                         f"{unsupported(away.shape[2], away.shape[3])}")
    if all(x.device.type == "cpu" for x in tensors):
        return edge_scores_reference(*tensors, newton_iters=newton_iters,
                                     log_thresh=log_thresh)
    device = away.device
    if device.type != "cuda" or any(x.device != device for x in tensors):
        raise ValueError("edge scorer inputs must all lie on one CUDA "
                         "device or all on the CPU, got "
                         f"{sorted({str(x.device) for x in tensors})}")
    _check(*tensors)
    cb, slots, R, S, T = away.shape
    limit = smem_limit_of(device)
    reason = unsupported(R, S, limit)
    if reason is not None:
        raise ValueError(f"the edge scorer kernel cannot take this case: "
                         f"{reason}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("edge scorer inputs must be contiguous")
    from .. import _build

    vg = score_ops.shape[1]
    scores = torch.empty((cb, vg), dtype=torch.float32, device=device)
    t3 = torch.empty((cb, vg), dtype=torch.float32, device=device)
    if cb * vg == 0:
        return scores, t3
    planned, cluster = plan(R, S, T, limit)
    if form == "reread":
        cluster = 0
    elif form == "resident" and planned != "resident":
        raise ValueError(
            f"the resident form cannot take R={R} S={S} T={T}: on "
            f"{CLUSTER_SIZES[-1]} CTAs a stripe of the sumtable with the "
            f"constants needs "
            f"{resident_smem_bytes(R, S, T, CLUSTER_SIZES[-1])} bytes of "
            f"shared memory, above the {limit}-byte limit")
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.edge_score_launch(
            away.data_ptr(), away_scal.data_ptr(), base.data_ptr(),
            base_scal.data_ptr(), halves.data_ptr(), score_ops.data_ptr(),
            sub_rows.data_ptr(), t0.data_ptr(), lbd.data_ptr(),
            rbd.data_ptr(), xw.data_ptr(), pw.data_ptr(), scores.data_ptr(),
            t3.data_ptr(), cb, vg, slots, R, S, T, newton_iters,
            ctypes.c_float(log_thresh), cluster, stream)
    if err != 0:
        raise RuntimeError(
            f"edge_score kernel launch failed ("
            f"{'reread' if cluster == 0 else f'resident, cluster {cluster}'}"
            f"): CUDA error {err} ({_build.error_string(err)})")
    edge_scores.launches += 1
    edge_scores.launches_by_form["resident" if cluster else "reread"] += 1
    if S not in FMA_STATES:
        edge_scores.launches_generic += 1
    return scores, t3


# kernel launches by this wrapper (plain runs excluded), in all, per form,
# and of the generic-state form (within both counts)
edge_scores.launches = 0
edge_scores.launches_by_form = {form: 0 for form in FORMS}
edge_scores.launches_generic = 0
