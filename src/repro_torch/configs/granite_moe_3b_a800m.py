"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8.  [hf:ibm-granite; hf]

The assigned spec string self-contradicts ("MoE 40e top-8 — 32 experts
top-8"); we follow the primary token (40 experts), matching the
3b-a800m family name.

Reference: ``src/repro/configs/granite_moe_3b_a800m.py`` (the same numbers).
"""

from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    d_model=1536,
    n_layers=32,
    period=(LayerSpec(kind="attn", window=None, ffn="moe"),),
    vocab=49155,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    moe=MoEConfig(num_experts=40, top_k=8, dispatch_chunk=1024),
    rope_base=10000.0,
    max_seq=32768,
)
