"""Plain PyTorch version of the Mamba-1 selective scan: the step-by-step
recurrence in f32, as ``repro``'s jnp oracle computes it."""
from __future__ import annotations

import torch


def selective_scan_ref(dt, x, A, Bmat, Cmat, h0=None):
    """Sequential recurrence  h_t = exp(dt_t*A)*h_{t-1} + (dt_t*x_t) B_t,
    y_t = h_t . C_t.

    dt/x: [B, S, d]; A: [d, N]; Bmat/Cmat: [B, S, N]; h0: [B, d, N] or None
    (zeros).  Returns (y [B, S, d] float32, h_final [B, d, N] float32).
    """
    Bsz, S, d = x.shape
    N = A.shape[1]
    dt, x, A = dt.float(), x.float(), A.float()
    Bmat, Cmat = Bmat.float(), Cmat.float()
    h = torch.zeros((Bsz, d, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None] * A)                # [B, d, N]
        h = dA * h + (dt[:, t] * x[:, t])[..., None] * Bmat[:, t, None, :]
        ys.append((h * Cmat[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1), h
