"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064.  [hf:microsoft/Phi-3-vision-128k-instruct; hf]

Backbone only: the CLIP vision frontend is a stub — input_specs()
supplies precomputed patch embeddings added to the first
``stub_prefix_len`` positions (assignment's [vlm] rule).

Reference: ``src/repro/configs/phi3_vision_4_2b.py`` (the same numbers).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    d_model=3072,
    n_layers=32,
    period=(LayerSpec(kind="attn", window=None, ffn="mlp"),),
    vocab=32064,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    modality_stub="vision",
    stub_prefix_len=576,     # 24x24 CLIP patch grid
    rope_base=10000.0,
    max_seq=131072,
)
