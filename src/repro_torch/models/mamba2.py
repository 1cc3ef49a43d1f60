"""Mamba2 (SSD) core ops: causal depthwise conv + chunked selective scan
(port of ``repro/models/mamba2.py``).

Recurrence per head h (P = head_dim, N = state_dim):

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t        (A < 0 scalar per head)
    y_t = h_t C_t + D x_t

B_t, C_t are shared across the heads of a group (n_groups).  The chunked
(SSD) evaluation computes intra-chunk contributions with a (c, c) per-head
decay matrix (all exponents <= 0) and carries the (P, N) state across
chunks: mathematically the sequential scan.  Plain PyTorch, as the
reference is plain JAX: it has no kernel for the SSD.  The reference's
``lax.scan`` over steps and chunks is a Python loop here.  One deviation:
the chunked scan masks the decay exponents above the diagonal before its
exp, not after, so that a chunk whose decays sum past float32's exp
range trains to finite gradients (the reference's are NaN there; its
values are the same).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm


def causal_conv(x, w, conv_state=None):
    """Depthwise causal conv.  x (B,S,ch); w (width,ch); conv_state
    (B,width-1,ch) carries the last inputs.  Returns (silu(y), state), the
    state the last width-1 inputs in x's dtype."""
    b, s, ch = x.shape
    width = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((b, width - 1, ch), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + s] * w[i][None, None] for i in range(width))
    return F.silu(y), xp[:, -(width - 1):]


def _expand_groups(m, heads: int):
    """(B,S,G,N) -> (B,S,H,N) by repeating each group over its heads."""
    return torch.repeat_interleave(m, heads // m.shape[2], dim=2)


def ssd_sequential(x, dt, la, Bm, Cm, state):
    """x (B,S,H,P); dt/la (B,S,H); Bm/Cm (B,S,H,N); state (B,H,P,N).
    Returns (state, y (B,S,H,P))."""
    h = state
    ys = []
    for t in range(x.shape[1]):
        h = (h * torch.exp(la[:, t])[..., None, None]
             + torch.einsum("bhp,bhn->bhpn", x[:, t] * dt[:, t, :, None],
                            Bm[:, t]))
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cm[:, t]))
    return h, torch.stack(ys, dim=1)


def ssd_chunked(x, dt, la, Bm, Cm, state, chunk: int = 128):
    """Chunked SSD; equal (up to float rounding) to `ssd_sequential`.  A
    length that is not a multiple of min(chunk, S) takes the sequential
    scan, as in the reference."""
    b, s, h, p = x.shape
    c = min(chunk, s)
    if s % c != 0:
        return ssd_sequential(x, dt, la, Bm, Cm, state)
    st = state.float()
    idx = torch.arange(c, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    ys = []
    for i0 in range(0, s, c):
        xc, dtc, lac, bc, cc = (a[:, i0:i0 + c].float()
                                for a in (x, dt, la, Bm, Cm))
        scum = torch.cumsum(lac, dim=1)                # (B,c,H) inclusive
        # intra: decay(i,j) = exp(s_i - s_j), j <= i.  The mask goes in
        # before the exp: above the diagonal s_i - s_j > 0 overflows once a
        # chunk's decays sum past ~88, and exp's gradient there, inf x 0,
        # would be NaN (the reference masks after its exp and so trains to
        # NaN gradients; the values are the same bits)
        diff = scum[:, :, None] - scum[:, None, :]     # (B,ci,cj,H)
        dec = torch.exp(torch.where(mask[None, :, :, None], diff,
                                    float("-inf")))
        cbm = torch.einsum("bihn,bjhn->bijh", cc, bc)  # (B,ci,cj,H)
        m = cbm * dec * dtc[:, None]                   # dt_j on axis cj
        y = torch.einsum("bijh,bjhp->bihp", m, xc)
        # inter: exp(s_i) C_i · h_prev
        y = y + (torch.einsum("bihn,bhpn->bihp", cc, st)
                 * torch.exp(scum)[..., None])
        # state update
        s_last = scum[:, -1]                           # (B,H)
        w = dtc * torch.exp(s_last[:, None] - scum)    # (B,c,H)
        st = (st * torch.exp(s_last)[..., None, None]
              + torch.einsum("bjhp,bjhn->bhpn", xc * w[..., None], bc))
        ys.append(y)
    return st, torch.cat(ys, dim=1).to(x.dtype)


def mamba_block(p, x, cfg: ModelConfig, *, conv_state=None, ssm_state=None,
                chunked: bool = True, mesh=None):
    """One mamba2 mixer.  x (B,S,d) -> (out, new_conv_state, new_ssm_state):
    the conv state in x's dtype, the SSM state float32.

    p: w_in (d, 2*d_in + 2*G*N + H), conv (w, d_in+2GN), A_log/D/dt_bias (H,),
    norm (d_in,), w_out (d_in, d).

    On a mesh (``mesh=``, a ``common.MeshContext``) `p` holds this rank's
    blocks under the reference's rules: ``w_in``'s packed [z | x | B | C
    | dt] columns and ``conv``'s [x | B | C] channels cut contiguously
    over 'model' where they divide (a block straddles the segments),
    ``w_out``'s rows (a contiguous block of d_in); `conv_state` holds its
    channels.  The rank gathers its projection columns over 'model',
    convolves its channels from its conv state and gathers the conv's
    output.  Then the reference's two layouts of the SSM state: where
    the heads divide 'model', `ssm_state` holds the rank's heads, which
    are ``w_out``'s rows, and it runs the scan on them with their x, dt
    and z and the B and C of their groups; where they do not, `ssm_state`
    holds P/M channels of every head (every channel where P does not
    divide 'model'), and it runs the scan on those channels of x and z
    with every head's B, C and dt (they are shared over P).  The gated
    norm's sum of squares over d_in is one float32 sum over 'model'; in
    the P-cut the normed channels are then gathered over 'model' and
    relaid into ``w_out``'s row block; ``w_out`` is a row-parallel
    product summed over 'model'.
    """
    b, s, d = x.shape
    ssm = cfg.ssm
    h_heads, n, g = ssm.n_ssm_heads, ssm.state_dim, ssm.n_groups
    d_in = 2 * d
    p_head = d_in // h_heads
    ch = d_in + 2 * g * n
    model = ("model",)

    proj = cm.matmul(x, cm.cast(p["w_in"], cfg))
    if proj.shape[-1] != d_in + ch + h_heads:    # columns cut over 'model'
        proj = mesh.gather(proj, -1, model)
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + ch]
    dt_raw = proj[..., -h_heads:]

    w_conv = cm.cast(p["conv"], cfg)
    if w_conv.shape[-1] != ch:                   # this rank's channels
        i, _ = mesh.block(model)
        c = w_conv.shape[-1]
        xbc, conv_state = causal_conv(xbc[..., i * c:(i + 1) * c], w_conv,
                                      conv_state)
        xbc = mesh.gather(xbc, -1, model)
    else:
        xbc, conv_state = causal_conv(xbc, w_conv, conv_state)
    x_in = xbc[..., :d_in].reshape(b, s, h_heads, p_head)
    bm = _expand_groups(xbc[..., d_in:d_in + g * n].reshape(b, s, g, n),
                        h_heads)
    cmx = _expand_groups(xbc[..., d_in + g * n:].reshape(b, s, g, n),
                         h_heads)

    dt_bias, a_log, d_skip, norm = p["dt_bias"], p["A_log"], p["D"], p["norm"]
    rows = p["w_out"].shape[0]
    hl, pw = h_heads, p_head                     # heads and channels here
    if rows != d_in and rows % p_head == 0:      # this rank's heads
        hl = rows // p_head
        i, _ = mesh.block(model)
        hs, cs = slice(i * hl, (i + 1) * hl), slice(i * hl * p_head,
                                                   (i + 1) * hl * p_head)
        x_in, bm, cmx = x_in[:, :, hs], bm[:, :, hs], cmx[:, :, hs]
        dt_raw, z, norm = dt_raw[..., hs], z[..., cs], norm[cs]
        dt_bias, a_log, d_skip = dt_bias[hs], a_log[hs], d_skip[hs]
    elif rows != d_in and p_head % mesh.size(model) == 0:   # P/M channels
        pw = p_head // mesh.size(model)
        i, _ = mesh.block(model)
        ps = slice(i * pw, (i + 1) * pw)
        x_in = x_in[..., ps]
        z = z.reshape(b, s, h_heads, p_head)[..., ps].reshape(b, s, -1)
        norm = norm.reshape(h_heads, p_head)[:, ps].reshape(-1)

    dt = F.softplus(dt_raw.float() + dt_bias.float())
    a = -torch.exp(a_log.float())                      # (H,) < 0
    la = dt * a                                        # log decay <= 0

    if ssm_state is None:
        ssm_state = torch.zeros((b, hl, pw, n), dtype=torch.float32,
                                device=x.device)
    ssd = ssd_chunked if chunked else ssd_sequential
    ssm_state, y = ssd(x_in.float(), dt, la, bm.float(), cmx.float(),
                       ssm_state)
    y = y + d_skip.float()[None, None, :, None] * x_in.float()
    y = y.reshape(b, s, hl * pw) * F.silu(z.float())
    if hl * pw != d_in:  # the gated norm over d_in: its sum over 'model'
        var = mesh.sum(y.square().sum(-1, keepdim=True), model) / d_in
        y = y * torch.rsqrt(var + cfg.norm_eps) * norm.float()
    else:
        y = cm.rms_norm(y, norm, cfg.norm_eps)
    if rows == d_in:
        return (cm.matmul(y.to(x.dtype), cm.cast(p["w_out"], cfg)),
                conv_state, ssm_state)
    y = y.to(x.dtype)
    if hl == h_heads:    # every head: relaid into w_out's row block
        if pw != p_head:
            y = mesh.gather(y.reshape(b, s, h_heads, pw), -1,
                            model).reshape(b, s, d_in)
        i, _ = mesh.block(model)
        y = y[..., i * rows:(i + 1) * rows]
    return (cm.row_parallel(y, cm.cast(p["w_out"], cfg), mesh), conv_state,
            ssm_state)
