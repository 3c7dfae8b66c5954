"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000, local(4096)/global alternating, logit softcaps
(attn 50, final 30), tied embeddings.  [arXiv:2408.00118; hf]

Reference: ``src/repro/configs/gemma2_2b.py`` (the same numbers).
Period = (local SWA, global full) x 13; head_dim=256 (Gemma decouples
head width from d_model / n_heads)."""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    d_model=2304,
    n_layers=26,
    period=(
        LayerSpec(kind="attn", window=4096, ffn="mlp"),
        LayerSpec(kind="attn", window=None, ffn="mlp"),
    ),
    vocab=256000,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    attn_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
    rope_base=10000.0,
    max_seq=32768,
)
