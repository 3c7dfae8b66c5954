"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, no-bias, tied embeddings.  [hf:CohereForAI; unverified]

Reference: ``src/repro/configs/command_r_35b.py`` (the same numbers).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    d_model=8192,
    n_layers=40,
    period=(LayerSpec(kind="attn", window=None, ffn="mlp"),),
    vocab=256000,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    tie_embeddings=True,
    rope_base=8000000.0,
    max_seq=131072,
)
