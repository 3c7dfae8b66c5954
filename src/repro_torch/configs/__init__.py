"""Architecture configs (reference: ``src/repro/configs/__init__.py``).

The port carries the families whose layers it has ported: deepseek_7b
(dense GQA attention + SwiGLU), gemma2_2b (the same, with local /
global sliding-window periods, score and final softcaps, tied
embeddings), command_r_35b (dense, tied embeddings), the
Mixture-of-Experts decoders granite_moe_3b_a800m and mixtral_8x22b
(sliding window 4096), the attention-free SSD model mamba2_1_3b, the
hybrid jamba_v01_52b (attention, mamba, MLP and MoE in a period of 8),
the MLA decoder minicpm3_4b and the two modality stubs phi3_vision_4_2b
and musicgen_large (dense backbones whose first ``stub_prefix_len``
positions take precomputed patch or frame embeddings).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, smoke_config

ARCH_IDS = (
    "granite_moe_3b_a800m",
    "mixtral_8x22b",
    "phi3_vision_4_2b",
    "deepseek_7b",
    "minicpm3_4b",
    "command_r_35b",
    "gemma2_2b",
    "jamba_v01_52b",
    "mamba2_1_3b",
    "musicgen_large",
)

PORTED = ("deepseek_7b", "gemma2_2b", "command_r_35b", "granite_moe_3b_a800m", "mixtral_8x22b",
          "mamba2_1_3b", "jamba_v01_52b", "minicpm3_4b", "phi3_vision_4_2b", "musicgen_large")

#: where each family not ported yet stands in ROADMAP.md (none is left)
_WAITING: dict = {}

_ALIASES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mixtral-8x22b": "mixtral_8x22b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "deepseek-7b": "deepseek_7b",
    "minicpm3-4b": "minicpm3_4b",
    "command-r-35b": "command_r_35b",
    "gemma2-2b": "gemma2_2b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "mamba2-1.3b": "mamba2_1_3b",
    "musicgen-large": "musicgen_large",
}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    if mod_name not in PORTED:
        raise NotImplementedError(
            f"arch {mod_name!r} is not ported to repro_torch yet: see ROADMAP.md {_WAITING[mod_name]}"
        )
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def smoke(name: str) -> ModelConfig:
    return smoke_config(get_config(name))
