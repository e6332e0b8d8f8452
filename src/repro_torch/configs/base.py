"""Model/config schema shared by all architectures.

A model is a stack of `num_layers` layers; `layer_pattern` describes one
repeating period as `"<mixer>+<ff>"` entries:

  mixers: attn (GQA+RoPE) | mla | xattn (cross-attention) | mamba
          | mlstm | slstm
  ff:     dense (SwiGLU) | moe | none

Parameters are stacked over `num_layers / len(layer_pattern)` periods, as
in the JAX package; the port walks the periods in a Python loop.  `remat`,
`scan_layers` and `logical_rules` are kept so configs compare equal to the
reference's; eager PyTorch has no use for them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.bramac_linear import QuantConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | vlm | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    layer_pattern: tuple[str, ...] = ("attn+dense",)
    head_dim: int | None = None      # default d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (0 → d_ff)
    moe_dispatch: str = "sort"       # "sort" (default) | "cumsum"
    #   sort: argsort-based rank-in-expert, O(T·k log T·k), no E-wide
    #   temporaries — adopted as default after the §Perf hillclimb;
    #   cumsum: the original (T·k, E) one-hot cumsum — O(T·E) memory and
    #   quadratic-cost reduce-window lowering at 32k-token scale.  The
    #   §Perf baselines in EXPERIMENTS.md were recorded with "cumsum".
    moe_capacity_factor: float = 1.25
    ep_dispatch: str = "global"      # "global" | "per_source"
    #   global: exact global-capacity buffers (all_gather combine);
    #   per_source: GShard-style per-source capacity C_src = ceil(C/n) with
    #   a mirrored all_to_all combine — lossy fast path, drops decided
    #   shard-locally (see repro.parallel.ep).

    # --- attention ---
    rope_theta: float = 10_000.0
    q_lora_rank: int = 0             # MLA
    kv_lora_rank: int = 0            # MLA
    qk_nope_dim: int = 64            # MLA per-head dims
    qk_rope_dim: int = 32
    v_head_dim: int = 64

    # --- mamba ---
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    mamba_dt_rank: int = 0           # 0 → ceil(d_model / 16)

    # --- xlstm ---
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    chunk_size: int = 256            # chunkwise scan for mamba/mlstm

    # --- modality frontends (stubs per assignment) ---
    vision_tokens: int = 0           # precomputed patch embeddings (vlm)
    audio_frontend: bool = False     # precomputed frame embeddings (audio)

    # --- execution ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    quant: QuantConfig = QuantConfig(enabled=False)
    quant_kv: bool = False           # int8 KV cache (GQA decode; §Perf)
    page_size: int = 16              # KV-cache page rows ("BRAM-array-sized"
    #                                  blocks): the paged serving layout
    #                                  allocates the cache as a shared pool
    #                                  of fixed (page_size,)-row pages with
    #                                  per-slot block tables instead of a
    #                                  dense [slot, max_seq] reservation
    remat: bool = True
    scan_layers: bool = True         # False: unroll periods (exact HLO cost
    #                                  accounting — scan bodies are counted
    #                                  once by XLA cost analysis)
    logical_rules: str = "default"   # sharding rule set name

    def __post_init__(self):
        if self.num_layers % len(self.layer_pattern):
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"pattern period {len(self.layer_pattern)}")
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: heads/kv_heads mismatch")
        if self.page_size < 1:
            raise ValueError(f"{self.name}: page_size must be >= 1, "
                             f"got {self.page_size}")

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def n_periods(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    # the recurrent mixers' widths (a tensor-parallel rank's
    # `parallel.sharding.RankConfig` divides them)
    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mlstm_width(self) -> int:
        return int(self.mlstm_proj_factor * self.d_model)

    @property
    def slstm_width(self) -> int:
        return int(self.slstm_proj_factor * self.d_model)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter count (for roofline MODEL_FLOPS and memory budgets) ----
    def param_count(self) -> int:
        return sum(_layer_params(self, spec) for spec in self.layer_pattern) \
            * self.n_periods + 2 * self.vocab_size * self.d_model

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only) — the N in
        MODEL_FLOPS = 6·N_active·D."""
        if not self.num_experts:
            return self.param_count()
        total = 2 * self.vocab_size * self.d_model
        for spec in self.layer_pattern:
            n = _layer_params(self, spec)
            if spec.endswith("+moe"):
                full_moe = self.num_experts * 3 * self.d_model \
                    * self.expert_d_ff
                active_moe = self.experts_per_token * 3 * self.d_model \
                    * self.expert_d_ff
                n = n - full_moe + active_moe
            total += n * self.n_periods
        return total


def _layer_params(cfg: ModelConfig, spec: str) -> int:
    mixer, ff = spec.split("+")
    d = cfg.d_model
    n = 0
    if mixer in ("attn", "xattn"):
        n += d * cfg.num_heads * cfg.hd + d * cfg.hd * cfg.num_kv_heads * 2 \
            + cfg.num_heads * cfg.hd * d
    elif mixer == "mla":
        qr = cfg.q_lora_rank or d
        n += d * qr + qr * cfg.num_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
        n += d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
        n += cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
        n += cfg.num_heads * cfg.v_head_dim * d
    elif mixer == "mamba":
        d_in = cfg.mamba_expand * d
        dt_rank = cfg.mamba_dt_rank or -(-d // 16)
        n += d * 2 * d_in + d_in * cfg.mamba_d_conv \
            + d_in * (dt_rank + 2 * cfg.mamba_d_state) + dt_rank * d_in \
            + d_in * cfg.mamba_d_state + d_in + d_in * d
    elif mixer == "mlstm":
        dp = int(cfg.mlstm_proj_factor * d)
        n += d * 2 * dp + 3 * dp * dp // max(cfg.num_heads, 1) + dp * d \
            + 2 * dp  # qkv (blockwise), gates, out
    elif mixer == "slstm":
        dp = int(cfg.slstm_proj_factor * d)
        n += 4 * d * d + 2 * d * dp + dp * d
    if ff == "dense":
        n += 3 * d * cfg.d_ff
    elif ff == "moe":
        n += cfg.num_experts * 3 * d * cfg.expert_d_ff + d * cfg.num_experts
    return n
