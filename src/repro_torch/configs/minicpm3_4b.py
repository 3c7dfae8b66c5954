"""minicpm3-4b [dense] — 62L d_model=2560 40H d_ff=6400 vocab=73448,
multi-head latent attention (MLA).  [hf:openbmb/MiniCPM3-4B; hf]

MLA ranks follow the model card family (q_lora 768, kv_lora 256,
nope 64 / rope 32 / v 64 per head); the latent cache is what decode
stores — (kv_rank + rope) per token, ~11x smaller than GQA kv=40.

Reference: ``src/repro/configs/minicpm3_4b.py`` (the same numbers).
"""

from repro_torch.models.config import LayerSpec, MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    d_model=2560,
    n_layers=62,
    period=(LayerSpec(kind="mla", window=None, ffn="mlp"),),
    vocab=73448,
    n_heads=40,
    n_kv_heads=40,
    head_dim=0,
    d_ff=6400,
    mla=MLAConfig(
        q_lora_rank=768, kv_lora_rank=256,
        qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64,
    ),
    rope_base=10000.0,
    max_seq=32768,
)
