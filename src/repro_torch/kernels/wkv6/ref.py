"""Plain PyTorch oracle for the WKV6 recurrence, a sequential loop over
time (port of ``repro/kernels/wkv6/ref.py``): `models.rwkv6.
wkv_sequential` in this kernel's (B, H, S, hd) layout.  The kernel's
plain version, the chunked evaluation it computes tile by tile, is
`ops.plain`."""
from __future__ import annotations


def wkv(r, k, v, logw, u, state):
    """All of r/k/v/logw (B, H, S, hd) float32; u (H, hd); state (B, H,
    hd, hd) [k-dim, v-dim].  Returns (state', y (B, H, S, hd))."""
    from repro_torch.models.rwkv6 import wkv_sequential
    tr = lambda a: a.transpose(1, 2)  # noqa: E731  (B,H,S,hd)<->(B,S,H,hd)
    state, y = wkv_sequential(tr(r), tr(k), tr(v), tr(logw), u, state)
    return state, tr(y)
