"""Model configuration (reference: ``src/repro/models/config.py``, kept
as a near-copy so the port never imports the JAX package).

One dataclass family covering all ten assigned
architectures (dense / GQA / MLA / SWA / local-global / MoE / SSD /
hybrid / modality-stub backbones).

A model is ``n_periods`` repetitions of a *period* — an ordered list of
``LayerSpec``s.  Homogeneous stacks (deepseek) have a 1-layer period;
gemma2 has a 2-layer period (local, global); jamba an 8-layer period
(1 attention + 7 mamba, MoE on odd positions).  Periods are scanned
with stacked parameters, keeping HLO size and compile time independent
of depth.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["AttnKind", "LayerSpec", "MoEConfig", "MLAConfig", "SSMConfig", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2
    # token chunk for the capacity-dispatch einsum (memory bound)
    dispatch_chunk: int = 2048


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128          # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position within a period."""

    kind: str = "attn"                 # 'attn' | 'mla' | 'mamba'
    window: Optional[int] = None       # None = full attention; int = SWA
    ffn: str = "mlp"                   # 'mlp' | 'moe' | 'none'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    period: Tuple[LayerSpec, ...]      # len(period) must divide n_layers
    vocab: int
    n_heads: int = 0                   # 0 for attention-free archs
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rope_base: float = 10000.0
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    tie_embeddings: bool = False
    rms_eps: float = 1e-5
    modality_stub: Optional[str] = None     # None | 'vision' | 'audio'
    stub_prefix_len: int = 0                # patch/frame positions for stubs
    max_seq: int = 32768

    # -- derived ------------------------------------------------------------

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.period) == 0, (self.name, self.n_layers, len(self.period))
        return self.n_layers // len(self.period)

    @property
    def qk_head_dim(self) -> int:
        if self.mla is not None:
            return self.mla.qk_nope_head_dim + self.mla.qk_rope_head_dim
        return self.head_dim

    @property
    def v_head_dim(self) -> int:
        if self.mla is not None:
            return self.mla.v_head_dim
        return self.head_dim

    @property
    def rope_dim(self) -> int:
        """Number of rotary dimensions per head."""
        if self.mla is not None:
            return self.mla.qk_rope_head_dim
        return self.head_dim

    @property
    def has_attention(self) -> bool:
        return any(s.kind in ("attn", "mla") for s in self.period)

    @property
    def is_subquadratic(self) -> bool:
        """Assignment rule for long_500k: run for SSM / hybrid /
        sliding-window archs; skip only *pure full-attention* stacks.
        Hybrids (jamba: 7/8 mamba + 1/8 full attention) run — their
        attention caches are context-parallel sharded over the data
        axis (see launch/steps._cache_shardings)."""
        has_ssm = any(s.kind == "mamba" for s in self.period)
        all_windowed = all(s.kind == "mamba" or s.window is not None for s in self.period)
        return has_ssm or all_windowed

    def param_count(self) -> int:
        """Total parameters (embedding included once if tied)."""
        from repro_torch.models.model import param_shapes  # local: avoids cycle
        import math

        total = 0
        for leaf in _iter_leaves(param_shapes(self)):
            total += math.prod(leaf.shape)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE counts top_k experts)."""
        from repro_torch.models.model import param_shapes
        import math

        total = 0
        for _path, leaf in _iter_items(param_shapes(self)):
            n = math.prod(leaf.shape)
            if self.moe and "expert" in (leaf.axes or ()):
                n = n * self.moe.top_k // self.moe.num_experts
            total += n
        return total


def _iter_leaves(tree):
    for _, leaf in _iter_items(tree):
        yield leaf


def _iter_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_items(v, prefix + "/" + str(k))
    else:
        yield prefix, tree


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduce any arch config to CPU-smoke scale, preserving the family
    structure (period pattern, MoE top-k, MLA ranks scaled, SSD heads)."""
    moe = None
    if cfg.moe:
        moe = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            # effectively dropless so prefill == incremental decode in
            # the consistency tests (production keeps 1.25 + drops)
            capacity_factor=8.0,
            dispatch_chunk=64,
        )
    mla = None
    if cfg.mla:
        mla = MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
            qk_rope_head_dim=8, v_head_dim=8,
        )
    ssm = None
    if cfg.ssm:
        ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=8, chunk=16)
    n_heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    n_kv = min(cfg.n_kv_heads, max(1, n_heads // 2)) if cfg.n_kv_heads else 0
    period = tuple(
        dataclasses.replace(s, window=(8 if s.window else None)) for s in cfg.period
    )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=64,
        n_layers=2 * len(cfg.period),
        period=period,
        vocab=128,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=96 if cfg.d_ff else 0,
        moe=moe,
        mla=mla,
        ssm=ssm,
        stub_prefix_len=4 if cfg.modality_stub else 0,
        max_seq=64,
    )
