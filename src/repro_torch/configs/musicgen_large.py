"""musicgen-large [audio] — 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048, decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a stub — input_specs() supplies
precomputed frame embeddings ([audio] rule).  Positional encoding uses
the framework's rotary path (MusicGen's sinusoidal embeddings are a
frontend detail; noted in DESIGN.md).

Reference: ``src/repro/configs/musicgen_large.py`` (the same numbers).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    d_model=2048,
    n_layers=48,
    period=(LayerSpec(kind="attn", window=None, ffn="mlp"),),
    vocab=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    modality_stub="audio",
    stub_prefix_len=256,
    rope_base=10000.0,
    max_seq=32768,
)
