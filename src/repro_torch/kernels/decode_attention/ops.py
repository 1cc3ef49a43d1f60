"""Public entry of flash-decode, model layout (port of
``repro/kernels/decode_attention/ops.py``; no grads on the decode path).

Dispatch is by device: a CUDA tensor launches the kernel
(`kernel.decode_attention`, which reads the cache in place) or raises; a
CPU tensor runs the plain version (`ref.decode_attend`).  Neither falls
back to the other.  `decode_attention_sharded` is the same over a cache
whose sequence is cut over ranks.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import kernel as K
from repro_torch.kernels.decode_attention import ref as R


def _check_device(q) -> None:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"decode_attention: unsupported device {q.device}")


def decode_attention(q, k_cache, v_cache, lengths):
    """Model layout: q (B, 1, Hq, hd); caches (B, S, Hkv, hd); lengths (B,)
    int32.  Returns (B, 1, Hq, hd) in q's dtype."""
    if q.device.type == "cuda":
        return K.decode_attention(q, k_cache, v_cache, lengths)
    _check_device(q)
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    qk = q[:, 0].reshape(b, hkv, hq // hkv, hd)
    out = R.decode_attend(qk, k_cache.transpose(1, 2),
                          v_cache.transpose(1, 2), lengths)
    return out.reshape(b, 1, hq, hd)


def decode_attention_sharded(q, k_block, v_block, lengths, start: int,
                             gather):
    """`decode_attention` over a sequence-sharded cache: this rank's blocks
    (B, rows, Hkv, hd) hold positions [start, start + rows); `lengths`
    (B,) int32 are the lanes' global valid lengths; `gather` joins dim 2
    of a tensor over the ranks that hold the sequence's blocks, in
    position order (``MeshContext.gather`` over the cache's sequence
    axes).  On the card: the split kernel over the block, masked by the
    lengths moved to the block's origin (a block past a lane's length
    gives the empty partial), one gather of every rank's partials and the
    combine kernel over them; on the CPU its plain version
    (`ref.decode_attend_sharded`).  Returns (B, 1, Hq, hd) in q's
    dtype."""
    b, _, hq, hd = q.shape
    rows, hkv = k_block.shape[1], k_block.shape[2]
    if q.device.type == "cuda":
        local = R.block_lengths(lengths, start, rows)
        parts = K.split(q, k_block, v_block, local)
        return K.combine(*R.gather_partials(*parts, gather), q.dtype)
    _check_device(q)
    qk = q[:, 0].reshape(b, hkv, hq // hkv, hd)
    out = R.decode_attend_sharded(qk, k_block.transpose(1, 2),
                                  v_block.transpose(1, 2), lengths, start,
                                  gather)
    return out.reshape(b, 1, hq, hd)
