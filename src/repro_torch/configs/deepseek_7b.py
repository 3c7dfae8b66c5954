"""deepseek-7b [dense] — 30L d_model=4096 32H (GQA kv=32) d_ff=11008
vocab=102400, llama-architecture.  [arXiv:2401.02954; hf]

Reference: ``src/repro/configs/deepseek_7b.py`` (the same numbers)."""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    d_model=4096,
    n_layers=30,
    period=(LayerSpec(kind="attn", window=None, ffn="mlp"),),
    vocab=102400,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    rope_base=10000.0,
    max_seq=32768,
)
