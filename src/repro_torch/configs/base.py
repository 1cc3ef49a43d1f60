"""Configuration system: model architectures, input shapes, parallelism
(a copy of the reference's ``repro/configs/base.py``: pure Python, so
`get_config` and `reduce_config` give equal dataclasses in both packages).

Every assigned architecture is a frozen ``ModelConfig`` registered under its
public id (``--arch <id>``).  Shapes are the four assigned input-shape suites;
``applicable_shapes(cfg)`` encodes the skip policy (long_500k only for
sub-quadratic families) documented in DESIGN.md §Arch-applicability.

Reduced ("smoke") variants of every config are derived mechanically by
``reduce_config`` so CPU tests exercise the same code paths as the full
configs, which are only ever lowered via the dry-run (ShapeDtypeStruct,
no allocation).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

# ----------------------------------------------------------------------------
# Model configuration
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # total routed experts
    experts_per_token: int = 0    # top-k
    d_ff_expert: int = 0          # hidden width of each expert FFN
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 1e-2
    # experts are zero-padded up to a multiple of the expert-parallel degree;
    # padded experts receive -inf router logits (see models/moe.py).


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 0            # per-head SSM state size (mamba2 N / rwkv d)
    n_ssm_heads: int = 0
    n_groups: int = 1             # mamba2 B/C groups (shared across heads)
    conv_width: int = 4           # mamba2 local conv
    chunk: int = 128              # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_type: str = "rope"       # rope | mrope | none
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    # hybrid: apply a (shared-weight) attention block every `attn_every`
    # layers; 0 disables.  zamba2-style "shared attention" = one set of attn
    # weights reused at each application site.
    attn_every: int = 0
    # encoder-decoder
    n_enc_layers: int = 0
    enc_seq_len: int = 0          # fixed encoder frame count (whisper: 1500)
    # notes for DESIGN.md provenance
    source: str = ""
    dtype: str = "bfloat16"

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if decode-time state is O(1)-ish in context length (SSM) or
        the backbone is dominated by SSM blocks (hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has a decode step (whisper = encdec)

    def n_params(self) -> int:
        """Total parameter count (embedding included)."""
        return sum(int(math.prod(s)) for s in _param_shapes(self).values())

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        total = 0
        for key, shape in _param_shapes(self).items():
            n = int(math.prod(shape))
            if ".experts." in key and self.moe.n_experts:
                n = n * self.moe.experts_per_token // self.moe.n_experts
            total += n
        return total


def _param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Closed-form parameter inventory (mirrors models/* init exactly; the
    test suite asserts this against jax.eval_shape of the real init)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes: dict[str, tuple[int, ...]] = {}
    L = cfg.n_layers

    def attn(prefix: str, layers: int) -> None:
        shapes[f"{prefix}.wq"] = (layers, d, cfg.q_dim)
        shapes[f"{prefix}.wk"] = (layers, d, cfg.kv_dim)
        shapes[f"{prefix}.wv"] = (layers, d, cfg.kv_dim)
        shapes[f"{prefix}.wo"] = (layers, cfg.q_dim, d)
        if cfg.qk_norm:
            shapes[f"{prefix}.q_norm"] = (layers, hd)
            shapes[f"{prefix}.k_norm"] = (layers, hd)

    def mlp(prefix: str, layers: int, ff: int) -> None:
        shapes[f"{prefix}.w_gate"] = (layers, d, ff)
        shapes[f"{prefix}.w_up"] = (layers, d, ff)
        shapes[f"{prefix}.w_down"] = (layers, ff, d)

    shapes["embed.tokens"] = (cfg.vocab_size, d)
    if not cfg.tie_embeddings:
        shapes["head.w"] = (d, cfg.vocab_size)
    shapes["final_norm.scale"] = (d,)

    if cfg.family in ("dense", "vlm"):
        attn("layers.attn", L)
        mlp("layers.mlp", L, cfg.d_ff)
        shapes["layers.norm_attn"] = (L, d)
        shapes["layers.norm_mlp"] = (L, d)
    elif cfg.family == "moe":
        attn("layers.attn", L)
        E = cfg.moe.n_experts
        fe = cfg.moe.d_ff_expert
        shapes["layers.moe.router"] = (L, d, E)
        shapes["layers.moe.experts.w_gate"] = (L, E, d, fe)
        shapes["layers.moe.experts.w_up"] = (L, E, d, fe)
        shapes["layers.moe.experts.w_down"] = (L, E, fe, d)
        shapes["layers.norm_attn"] = (L, d)
        shapes["layers.norm_mlp"] = (L, d)
    elif cfg.family == "ssm":  # rwkv6
        H = cfg.ssm.n_ssm_heads
        hd6 = d // H
        for nm in ("r", "k", "v", "g", "o"):
            shapes[f"layers.tmix.w_{nm}"] = (L, d, d)
        shapes["layers.tmix.w_decay"] = (L, d, 64)       # lora-style decay
        shapes["layers.tmix.w_decay2"] = (L, 64, d)
        shapes["layers.tmix.mu"] = (L, 5, d)             # token-shift mixes
        shapes["layers.tmix.bonus"] = (L, H, hd6)        # per-head u term
        shapes["layers.tmix.ln_x"] = (L, d)
        shapes["layers.cmix.w_k"] = (L, d, cfg.d_ff)
        shapes["layers.cmix.w_v"] = (L, cfg.d_ff, d)
        shapes["layers.cmix.w_r"] = (L, d, d)
        shapes["layers.cmix.mu"] = (L, 2, d)
        shapes["layers.norm1"] = (L, d)
        shapes["layers.norm2"] = (L, d)
    elif cfg.family == "hybrid":  # zamba2: mamba2 backbone + shared attn
        H = cfg.ssm.n_ssm_heads
        N = cfg.ssm.state_dim
        G = cfg.ssm.n_groups
        d_in = 2 * d                                     # mamba2 expand=2
        shapes["layers.mamba.w_in"] = (L, d, 2 * d_in + 2 * G * N + H)
        shapes["layers.mamba.conv"] = (L, cfg.ssm.conv_width,
                                       d_in + 2 * G * N)
        shapes["layers.mamba.A_log"] = (L, H)
        shapes["layers.mamba.D"] = (L, H)
        shapes["layers.mamba.dt_bias"] = (L, H)
        shapes["layers.mamba.w_out"] = (L, d_in, d)
        shapes["layers.mamba.norm"] = (L, d_in)
        shapes["layers.norm"] = (L, d)
        # one shared attention + mlp block (weights reused at each site)
        attn("shared.attn", 1)
        mlp("shared.mlp", 1, cfg.d_ff)
        shapes["shared.norm_attn"] = (1, d)
        shapes["shared.norm_mlp"] = (1, d)
    elif cfg.family == "encdec":  # whisper
        Le = cfg.n_enc_layers
        attn("enc.attn", Le)
        mlp("enc.mlp", Le, cfg.d_ff)
        shapes["enc.norm_attn"] = (Le, d)
        shapes["enc.norm_mlp"] = (Le, d)
        shapes["enc.final_norm"] = (d,)
        attn("dec.self_attn", L)
        attn("dec.cross_attn", L)
        mlp("dec.mlp", L, cfg.d_ff)
        shapes["dec.norm_self"] = (L, d)
        shapes["dec.norm_cross"] = (L, d)
        shapes["dec.norm_mlp"] = (L, d)
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return shapes


# ----------------------------------------------------------------------------
# Shape suites
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[ShapeConfig]:
    """Skip policy: long_500k needs a sub-quadratic backbone (see DESIGN.md)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out


def skipped_shapes(cfg: ModelConfig) -> list[tuple[str, str]]:
    if cfg.sub_quadratic:
        return []
    return [("long_500k", "pure full attention is quadratic at 524k ctx; "
             "skip per assignment (sub-quadratic archs only)")]


# ----------------------------------------------------------------------------
# Parallelism / run configuration
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How a run maps onto the mesh (see core/partitioning.py)."""
    fsdp: bool = True             # shard params/opt-state over the data axis
    tensor_parallel: bool = True  # megatron TP over the model axis
    seq_shard_activations: bool = True   # SP: residuals sharded over model
    # SP reshard granularity: 'op' lets GSPMD place the seq gathers (it
    # tends to pick f32 points inside norms); 'layer' does ONE explicit bf16
    # unshard at layer entry + one reduce-scatter at exit (§Perf iteration)
    sp_boundary: str = "op"       # op | layer
    remat: str = "full"           # full | none
    cross_pod_sync: str = "cascaded"     # cascaded | dedicated | auto(xla)
    grad_compression: str = "none"       # none | int8
    # naive | chunked | pallas.  In this package "pallas" selects the
    # hand-written Hopper CUDA kernels that replace the reference's Pallas
    # ones: kernels/flash_attention (prefill on a fresh cache, training),
    # kernels/decode_attention (every decode step) and kernels/wkv6
    # (RWKV6's forward on a fresh sequence, training); on CPU tensors they
    # run their plain PyTorch versions.
    attn_impl: str = "chunked"
    attn_chunk: int = 1024
    moe_impl: str = "shard_map"   # shard_map | dense
    logit_chunk: int = 2048       # blockwise cross-entropy chunk


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig = ParallelConfig()
    seed: int = 0
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    max_steps: int = 1_000
    microbatch: int = 0           # 0 = no gradient accumulation


# ----------------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import archs  # noqa: F401  (registers everything)
    _LOADED = True


# ----------------------------------------------------------------------------
# Reduced (smoke) configs
# ----------------------------------------------------------------------------


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a full config to a CPU-testable size, same family/code path."""
    d = 64
    n_heads = 4
    n_kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else n_heads
    moe = cfg.moe
    if moe.n_experts:
        moe = dataclasses.replace(moe, n_experts=8, experts_per_token=2,
                                  d_ff_expert=32)
    ssm = cfg.ssm
    if ssm.n_ssm_heads:
        ssm = dataclasses.replace(ssm, n_ssm_heads=2,
                                  state_dim=min(ssm.state_dim, 16) or 16,
                                  chunk=16)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=d,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        moe=moe,
        ssm=ssm,
        attn_every=2 if cfg.attn_every else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        enc_seq_len=24 if cfg.enc_seq_len else 0,
    )
