"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2, Mamba:attention 1:7 interleave.
[arXiv:2403.19887; hf]

Period of 8: position 0 is attention, 1-7 are mamba; MoE replaces the
MLP on odd positions (every-2 pattern).  Jamba ships Mamba-1 layers
(d_state=16); we use the SSD block with matching state size — same
state capacity, TPU-friendly dual form.

Reference: ``src/repro/configs/jamba_v01_52b.py`` (the same numbers).
"""

from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig, SSMConfig

_period = tuple(
    LayerSpec(
        kind=("attn" if i == 0 else "mamba"),
        window=None,
        ffn=("moe" if i % 2 == 1 else "mlp"),
    )
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    d_model=4096,
    n_layers=32,
    period=_period,
    vocab=65536,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    moe=MoEConfig(num_experts=16, top_k=2, dispatch_chunk=2048),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=128),
    rope_base=10000.0,
    max_seq=524288,
)
