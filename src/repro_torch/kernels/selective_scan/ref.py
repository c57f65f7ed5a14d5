"""Plain PyTorch versions of the selective scan: the step-by-step
recurrence in f32, as ``repro``'s jnp oracle (Mamba-1) and ``repro``'s
``mamba._ssm2_step`` loop (Mamba-2, one dt and A per head) compute it."""
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


def selective_scan_heads_ref(dt, x, A, Bmat, Cmat, h0=None):
    """The Mamba-2 recurrence, one dt and one scalar A per head of P
    channels:  dA_t = exp(dt_t[h]*A[h]),  h_t = dA_t*h_{t-1} +
    (dt_t[h]*x_t) B_t,  y_t = h_t . C_t.

    dt: [B, S, H]; x: [B, S, H*P]; A: [H] f32; Bmat/Cmat: [B, S, N]; h0:
    [B, H, P, N] f32 or None (zeros).  Returns (y [B, S, H*P] float32,
    h_final [B, H, P, N] float32).  A position with dt = 0 leaves h bit
    for bit (dA = 1, nothing added).
    """
    Bsz, S, Hh = dt.shape
    P = x.shape[2] // Hh
    N = Bmat.shape[2]
    dt, A = dt.float(), A.float()
    x = x.float().reshape(Bsz, S, Hh, P)
    Bmat, Cmat = Bmat.float(), Cmat.float()
    h = torch.zeros((Bsz, Hh, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A)                          # [B, H]
        h = dA[..., None, None] * h + \
            (dt[:, t, :, None] * x[:, t])[..., None] * Bmat[:, t, None, None]
        ys.append((h * Cmat[:, t, None, None]).sum(-1))       # [B, H, P]
    return torch.stack(ys, 1).reshape(Bsz, S, Hh * P), h
