"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]

All layers SWA => sub-quadratic decode; long_500k runs with a
window-bounded rolling cache.

Reference: ``src/repro/configs/mixtral_8x22b.py`` (the same numbers).
"""

from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    d_model=6144,
    n_layers=56,
    period=(LayerSpec(kind="attn", window=4096, ffn="moe"),),
    vocab=32768,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    moe=MoEConfig(num_experts=8, top_k=2, dispatch_chunk=2048),
    rope_base=1000000.0,
    max_seq=524288,
)
