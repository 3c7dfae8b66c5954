"""The plain reference: plain PyTorch, independent of the program (it
imports nothing of ``repro_torch``), given the same float32 weights."""

from portbench.reference.decoder import ReferenceDecoder

__all__ = ["ReferenceDecoder"]
