"""mamba2-1.3b [ssm] — 48L d_model=2048, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060; unverified]

The paper's CORDIC/trig module is inapplicable (no rotary phases); the
Q-format matmul path still covers all projections.

Reference: ``src/repro/configs/mamba2_1_3b.py`` (the same numbers).
"""

from repro_torch.models.config import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    d_model=2048,
    n_layers=48,
    period=(LayerSpec(kind="mamba", window=None, ffn="none"),),
    vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
    max_seq=1048576,
)
