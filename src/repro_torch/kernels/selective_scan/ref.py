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


def _states(dA, dBx, h0):
    """Every state of the recurrence h_t = dA_t h_{t-1} + dBx_t: [S + 1,
    ...] with h_{-1} (``h0``) first.  dA and dBx: [S, ...]."""
    hs = [h0]
    for t in range(dA.shape[0]):
        hs.append(dA[t] * hs[-1] + dBx[t])
    return hs


def selective_scan_bwd_ref(dt, x, A, Bmat, Cmat, h0, dy, dh_final=None):
    """Gradient of :func:`selective_scan_ref` as the reverse recurrence in
    f32.  With g_t the gradient with respect to h_t (from ``dh_final``,
    zeros when None):  g_t = dA_{t+1} g_{t+1} + dy_t C_t,  dC_t = sum_d
    dy_t h_t,  dB_t = sum_d g_t dt_t x_t,  dx_t = sum_n g_t dt_t B_t,
    ddt_t = sum_n g_t (A dA_t h_{t-1} + x_t B_t),  dA = sum_{b,t} g_t dt_t
    dA_t h_{t-1},  dh0 = dA_0 g_0.

    dy: [B, S, d]; dh_final: [B, d, N] or None.  Returns (ddt, dx, dA, dB,
    dC, dh0), all f32: [B, S, d], [B, S, d], [d, N], [B, S, N], [B, S, N],
    [B, d, N].  The states are rebuilt forward from h0, never by inverting
    the recurrence (dA_t underflows to 0 at large |A| dt)."""
    Bsz, S, d = x.shape
    N = A.shape[1]
    dt, x, A = dt.float(), x.float(), A.float()
    Bmat, Cmat, dy = Bmat.float(), Cmat.float(), dy.float()
    h0 = torch.zeros((Bsz, d, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    dts = dt.transpose(0, 1)                                # [S, B, d]
    dA_ = torch.exp(dts[..., None] * A)                     # [S, B, d, N]
    dBx = (dts * x.transpose(0, 1))[..., None] \
        * Bmat.transpose(0, 1)[:, :, None]
    hs = _states(dA_, dBx, h0)
    g = torch.zeros_like(h0) if dh_final is None else dh_final.float().clone()
    ddt, dx, dB, dC = (torch.empty_like(x), torch.empty_like(x),
                       torch.empty_like(Bmat), torch.empty_like(Cmat))
    dA = torch.zeros_like(A)
    for t in range(S - 1, -1, -1):
        g = g + dy[:, t, :, None] * Cmat[:, t, None, :]
        dC[:, t] = (dy[:, t, :, None] * hs[t + 1]).sum(1)
        dB[:, t] = (g * (dt[:, t] * x[:, t])[..., None]).sum(1)
        dx[:, t] = (g * Bmat[:, t, None, :]).sum(-1) * dt[:, t]
        dAh = dA_[t] * hs[t]
        ddt[:, t] = (g * (A * dAh + x[:, t, :, None]
                          * Bmat[:, t, None, :])).sum(-1)
        dA += (g * dt[:, t, :, None] * dAh).sum(0)
        g = g * dA_[t]
    return ddt, dx, dA, dB, dC, g


def selective_scan_heads_bwd_ref(dt, x, A, Bmat, Cmat, h0, dy,
                                 dh_final=None):
    """Gradient of :func:`selective_scan_heads_ref`: the reverse
    recurrence of :func:`selective_scan_bwd_ref` with one dt and one A per
    head, so ddt and dA also sum over the head's P channels and N states.

    dt: [B, S, H]; x, dy: [B, S, H*P]; A: [H]; h0, dh_final: [B, H, P, N]
    or None.  Returns (ddt [B, S, H], dx [B, S, H*P], dA [H], dB, dC [B, S,
    N], dh0 [B, H, P, N]), all f32."""
    Bsz, S, Hh = dt.shape
    P = x.shape[2] // Hh
    N = Bmat.shape[2]
    dt, A = dt.float(), A.float()
    x = x.float().reshape(Bsz, S, Hh, P)
    dy = dy.float().reshape(Bsz, S, Hh, P)
    Bmat, Cmat = Bmat.float(), Cmat.float()
    h0 = torch.zeros((Bsz, Hh, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    dA_ = torch.exp(dt * A).transpose(0, 1)[..., None, None]  # [S, B, H, 1, 1]
    dBx = ((dt[..., None] * x)[..., None]
           * Bmat[:, :, None, None]).transpose(0, 1)          # [S, B, H, P, N]
    hs = _states(dA_, dBx, h0)
    g = torch.zeros_like(h0) if dh_final is None else dh_final.float().clone()
    ddt, dB, dC = (torch.empty_like(dt), torch.empty_like(Bmat),
                   torch.empty_like(Cmat))
    dx = torch.empty_like(x)
    dA = torch.zeros_like(A)
    for t in range(S - 1, -1, -1):
        g = g + dy[:, t, ..., None] * Cmat[:, t, None, None]
        dC[:, t] = (dy[:, t, ..., None] * hs[t + 1]).sum((1, 2))
        dB[:, t] = (g * (dt[:, t, :, None] * x[:, t])[..., None]).sum((1, 2))
        dx[:, t] = (g * Bmat[:, t, None, None]).sum(-1) * dt[:, t, :, None]
        dAh = dA_[t] * hs[t]
        ddt[:, t] = (g * (A[:, None, None] * dAh + x[:, t, ..., None]
                          * Bmat[:, t, None, None])).sum((2, 3))
        dA += (g * dt[:, t, :, None, None] * dAh).sum((0, 2, 3))
        g = g * dA_[t]
    return ddt, dx.reshape(Bsz, S, Hh * P), dA, dB, dC, g
