"""The Mamba-2 chunked SSD scan in plain PyTorch: the port of the
reference's ``src/repro/models/ssm.py::_ssd_chunked`` and nothing else of
that module. It is the oracle the SSD chunk kernel is held to
(``kernels/ssd_chunk.py``), as ``ref.ssd_ref`` holds the Pallas kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bm: torch.Tensor, cm: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """Chunked SSD scan. xh (B,S,H,P); dt (B,S,H); a (H,) negative;
    bm/cm (B,S,G,N), G groups of H/G heads. Returns (B,S,H,P), fp32."""
    b, s, h, p = xh.shape
    g = bm.shape[2]
    hpg = h // g
    pad = (-s) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc, ll = sp // chunk, chunk

    xc = xh.reshape(b, nc, ll, h, p).float()
    dtc = dt.reshape(b, nc, ll, h).float()
    bc = bm.reshape(b, nc, ll, g, 1, -1).float()
    cc = cm.reshape(b, nc, ll, g, 1, -1).float()
    bh = bc.expand(b, nc, ll, g, hpg, bc.shape[-1]).reshape(b, nc, ll, h, -1)
    ch = cc.expand(b, nc, ll, g, hpg, cc.shape[-1]).reshape(b, nc, ll, h, -1)

    da = dtc * a.float()[None, None, None, :]          # (b,nc,L,h)
    da_t = torch.cumsum(da, dim=2).permute(0, 1, 3, 2)  # (b,nc,h,L)
    dt_t = dtc.permute(0, 1, 3, 2)                      # (b,nc,h,L)

    # intra-chunk (the "duality" quadratic block)
    cb = torch.einsum("bclhn,bcmhn->bchlm", ch, bh)
    seg = da_t[..., :, None] - da_t[..., None, :]       # (b,nc,h,L,L)
    tri = torch.ones((ll, ll), dtype=torch.bool, device=xh.device).tril()
    decay = torch.where(tri, torch.exp(seg), torch.zeros((), device=xh.device))
    scores = cb * decay * dt_t[..., None, :]
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", scores, xc)

    # chunk-final states
    w = torch.exp(da_t[..., -1:] - da_t) * dt_t         # (b,nc,h,L)
    states = torch.einsum("bchm,bcmhp,bcmhn->bchpn", w, xc, bh)

    # inter-chunk recurrence (sequential over chunks): the state before
    # each chunk
    chunk_decay = torch.exp(da_t[..., -1])              # (b,nc,h)
    prev = torch.empty_like(states)
    carry = torch.zeros((b, h, p, bh.shape[-1]), dtype=torch.float32,
                        device=xh.device)
    for c in range(nc):
        prev[:, c] = carry
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]

    y_off = torch.einsum("bclhn,bchpn->bclhp", ch, prev) \
        * torch.exp(da_t).permute(0, 1, 3, 2)[..., None]
    y = (y_diag + y_off).reshape(b, sp, h, p)
    return y[:, :s]
