"""Plain PyTorch oracle for the WKV6 recurrence, a sequential loop over
time (port of ``repro/kernels/wkv6/ref.py``): `models.rwkv6.
wkv_sequential` in this kernel's (B, H, S, hd) layout.  The kernel's
plain version, the chunked evaluation it computes tile by tile, is
`ops.plain`.  `subchunk_factorised` models the CUDA kernel's own
arithmetic, for the tests."""
from __future__ import annotations

import torch

#: rows of the kernel's sub-blocks
SUB = 16


def wkv(r, k, v, logw, u, state):
    """All of r/k/v/logw (B, H, S, hd) float32; u (H, hd); state (B, H,
    hd, hd) [k-dim, v-dim].  Returns (state', y (B, H, S, hd))."""
    from repro_torch.models.rwkv6 import wkv_sequential
    tr = lambda a: a.transpose(1, 2)  # noqa: E731  (B,H,S,hd)<->(B,S,H,hd)
    state, y = wkv_sequential(tr(r), tr(k), tr(v), tr(logw), u, state)
    return state, tr(y)


def _product(a, b, tf32: bool):
    """a @ b in float32; with `tf32`, as the kernel's three TF32 passes
    on hi/lo planes (`smla_pipe.ref.split_tf32`): lo.hi + hi.lo + hi.hi."""
    if not tf32:
        return a @ b
    from repro_torch.kernels.smla_pipe.ref import split_tf32
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def subchunk_factorised(r, k, v, logw, u, chunk: int = 64, *,
                        tf32: bool = False):
    """The kernel's arithmetic in plain PyTorch: r, k, v, logw (B, H, S,
    hd), u (H, hd) -> (y (B, H, S, hd) float32, final state float32) from
    a zero state.  Per chunk, in 16-row sub-blocks: logw's inclusive sums
    L within each sub-block and their totals T_J; E_i, the previous row's
    L (0 at a sub-block's first row); the diagonal blocks' scores, exp(E_i
    - L_j) pair by pair within 4 x 4 micro-tiles and factorised at the
    column micro-tile's last row below them; the off-diagonal blocks (I >
    J) as the product (r_I o e^(E_I + M_JI)) (k_J o e^(T_J - L_J))^T, M_JI
    the totals
    strictly between J and I, each factor <= 1; y = (scores v + bonus v)
    + (r o e^(texc)) S and S' = S o e^(s_last) + (k o e^(s_last -
    scum))^T v, texc and s_last - scum from the same sums.  `tf32` runs
    every product as the kernel's 3xTF32 (`_product`)."""
    b, h, s, hd = r.shape
    r, k, v, logw = (a.float() for a in (r, k, v, logw))
    u = u.float()
    st = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for c0 in range(0, s, chunk):
        rc, kc, vc, wc = (a[:, :, c0:c0 + chunk] for a in (r, k, v, logw))
        cs = rc.shape[2]
        nsb = cs // SUB
        blocks = lambda a: a.reshape(b, h, nsb, SUB, hd)  # noqa: E731
        rb, kb, lw = blocks(rc), blocks(kc), blocks(wc)
        sums = torch.cumsum(lw, dim=3)                        # L
        prev = torch.cat([torch.zeros_like(sums[:, :, :, :1]),
                          sums[:, :, :, :-1]], dim=3)         # E
        tot = sums[:, :, :, -1]                               # T (b,h,nsb,hd)
        before = [torch.zeros_like(tot[:, :, 0])]             # P_I
        for i in range(nsb):
            before.append(before[-1] + tot[:, :, i])
        after = [None] * nsb                                  # Q_J
        acc = torch.zeros_like(tot[:, :, 0])
        for j in reversed(range(nsb)):
            after[j] = acc
            acc = acc + tot[:, :, j]
        ra = rb * torch.exp(prev)
        kd = kb * torch.exp(tot[:, :, :, None] - sums)
        scores = torch.zeros((b, h, cs, cs), dtype=torch.float32,
                             device=r.device)
        ar = torch.arange(SUB, device=r.device)
        lower = ar[:, None] > ar[None, :]
        same = (ar[:, None] // 4) == (ar[None, :] // 4)
        for i in range(nsb):
            rows = slice(SUB * i, SUB * (i + 1))
            # pairs within a 4 x 4 micro-tile: exp(E_i - L_j); below them,
            # factorised at the column micro-tile's last row rho_j:
            # exp(E_i - rho_j) exp(rho_j - L_j), both <= 1
            pe, se = prev[:, :, i], sums[:, :, i]
            rho = se[:, :, 4 * (ar // 4) + 3]
            pair = torch.exp((pe[:, :, :, None] - se[:, :, None])
                             .clamp(max=0.0))
            fact = (torch.exp((pe[:, :, :, None] - rho[:, :, None])
                              .clamp(max=0.0))
                    * torch.exp(rho - se)[:, :, None])
            dec = torch.where(same[:, :, None], pair, fact)
            dec = torch.where(lower[:, :, None], dec, 0.0)
            scores[:, :, rows, rows] = torch.einsum(
                "bhid,bhijd,bhjd->bhij", rb[:, :, i], dec, kb[:, :, i])
            mid = torch.zeros_like(tot[:, :, 0])              # M_JI
            for j in reversed(range(i)):
                a = ra[:, :, i] * torch.exp(mid)[:, :, None]
                scores[:, :, rows, SUB * j:SUB * (j + 1)] = _product(
                    a, kd[:, :, j].transpose(-1, -2), tf32)
                mid = mid + tot[:, :, j]
        bonus = (rc * u[None, :, None] * kc).sum(-1, keepdim=True)
        rt = (ra * torch.exp(torch.stack(before[:nsb], 2))[:, :, :, None]
              ).reshape(b, h, cs, hd)
        kt = (kd * torch.exp(torch.stack(after, 2))[:, :, :, None]
              ).reshape(b, h, cs, hd)
        y = (_product(scores, vc, tf32) + bonus * vc) + _product(rt, st, tf32)
        st = (st * torch.exp(before[nsb])[..., None]
              + _product(kt.transpose(-1, -2), vc, tf32))
        ys.append(y)
    return torch.cat(ys, dim=2), st
