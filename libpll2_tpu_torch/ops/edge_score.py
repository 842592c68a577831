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

`edge_scores` is the wrapper: the CUDA kernel (csrc/edge_score.cu) on CUDA
tensors, the plain version `edge_scores_reference` on CPU tensors.  Unlike
the Pallas wrapper, it takes the base message rows, the half-P matrices
and the scaler rows as they are and gathers them by the slot's op row, and
it starts Newton from the real branch length (Pallas pre-gathers in slot
order and quantizes t0 to 1e-7 only because Mosaic lacks dynamic row
indices and SMEM bitcasts).

Contract (the caller takes the plain scorer otherwise): f32, per-site
scalers, no ascertainment bias, no invariant-marked site (+I enters only
through prop_invar in x and w0).
"""
from __future__ import annotations

import ctypes

import torch

from .derivatives import newton_update
from .partials_tree import KERNEL_STATES

# score-op columns the scorer reads (search_fast.BOP_*)
OP_COLS = 12
OP_PARENT, OP_SC_ROW, OP_SC_SCAL, OP_EDGE, OP_VALID = 0, 8, 9, 10, 11


def model_constants(model, cfg):
    """(L_bd, R_bd [span, span], xw [span, 2]) f32: the block-diagonal
    per-category ML and EV matrices and, per (rate, state), x | w0 — the
    JAX package's layout."""
    R, S = cfg.rate_cats, cfg.states
    dtype = torch.float32
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
                          newton_iters: int, log_thresh: float):
    """Plain PyTorch version of the edge scorer (same contract and output
    as edge_scores)."""
    _check(away, away_scal, base, base_scal, halves, score_ops, sub_rows,
           t0, lbd, rbd, xw, pw)
    cb, _, R, S, T = away.shape
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
        t = newton_update(t, torch.sum(wlive * deriv1, dim=-1),
                          torch.sum(wlive * deriv2, dim=-1))
    lk0 = lks(t)[0]
    scal = (away_scal[ar, ops[..., OP_PARENT]]
            + base_scal[ops[..., OP_SC_SCAL]]
            + base_scal[sub_rows[:, 1].long()][:, None]).to(torch.float32)
    site_lk = torch.log(torch.where(live, lk0, one)) + scal * log_thresh
    score = torch.sum(wlive * site_lk, dim=-1)
    valid = ops[..., OP_VALID] == 1
    return (torch.where(valid, score, torch.full_like(score, -float("inf"))),
            torch.where(valid, t, t0[:, None].expand(cb, vg)))


def edge_scores(away, away_scal, base, base_scal, halves, score_ops,
                sub_rows, t0, lbd, rbd, xw, pw, *, newton_iters: int,
                log_thresh: float):
    """Score every slot of Cb candidates: the CUDA kernel on CUDA tensors,
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
    Returns (scores [Cb, Vg], t3 [Cb, Vg]) f32; invalid slots score -inf
    with t3 = t0.
    """
    tensors = (away, away_scal, base, base_scal, halves, score_ops,
               sub_rows, t0, lbd, rbd, xw, pw)
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
    if S not in KERNEL_STATES:
        raise ValueError(f"the edge scorer is built for states "
                         f"{KERNEL_STATES}, got {S}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("edge scorer inputs must be contiguous")
    from .. import _build

    vg = score_ops.shape[1]
    scores = torch.empty((cb, vg), dtype=torch.float32, device=device)
    t3 = torch.empty((cb, vg), dtype=torch.float32, device=device)
    if cb * vg == 0:
        return scores, t3
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.edge_score_launch(
            away.data_ptr(), away_scal.data_ptr(), base.data_ptr(),
            base_scal.data_ptr(), halves.data_ptr(), score_ops.data_ptr(),
            sub_rows.data_ptr(), t0.data_ptr(), lbd.data_ptr(),
            rbd.data_ptr(), xw.data_ptr(), pw.data_ptr(), scores.data_ptr(),
            t3.data_ptr(), cb, vg, slots, R, S, T, newton_iters,
            ctypes.c_float(log_thresh), stream)
    if err != 0:
        raise RuntimeError(f"edge_score kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    edge_scores.launches += 1
    return scores, t3


edge_scores.launches = 0   # kernel launches by this wrapper (plain excluded)
