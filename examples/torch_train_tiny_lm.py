"""End-to-end training on the PyTorch port (mirrors
``examples/train_tiny_lm.py``): a ~100M-parameter decoder LM trained for
a few hundred steps on synthetic data, with the precision arbiter
switching between the paper's FAST (Q-format int8) and PRECISE (bf16)
paths.

Run:  PYTHONPATH=src python examples/torch_train_tiny_lm.py [--steps 300] [--tiny] \\
          [--device cpu]

``--device`` defaults to the card; ``cpu`` runs the kernels' plain
PyTorch versions.  Every number printed is measured in this run.
"""

import argparse
import os
import tempfile

from repro_torch.configs import smoke
from repro_torch.core.arbiter import ArbiterConfig
from repro_torch.data import DataConfig
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.runtime import Trainer, TrainerConfig


def lm_100m() -> ModelConfig:
    """~100M params: 12L, d=768, 12H, GQA kv=4, d_ff=2048, vocab=32768."""
    return ModelConfig(
        name="tiny-lm-100m", d_model=768, n_layers=12,
        period=(LayerSpec(kind="attn", window=None, ffn="mlp"),),
        vocab=32768, n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048,
        max_seq=512,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true", help="smoke-size model (CI)")
    ap.add_argument("--mode", default="fast",
                    choices=["fast", "precise", "q8_8", "q16_16", "q8_24", "f32"],
                    help="Mode compat alias or precision-ladder level name")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_tiny_lm"))
    args = ap.parse_args(argv)

    cfg = smoke("deepseek_7b") if args.tiny else lm_100m()
    print(f"model: {cfg.name}  params: {cfg.param_count()/1e6:.1f}M")

    # binary compat aliases keep the classic FAST<->PRECISE arbiter; a
    # ladder level name gets the multi-tier ladder, its start rung the
    # engine's start level
    if args.mode in ("fast", "precise"):
        arb_cfg = ArbiterConfig()
    else:
        arb_cfg = ArbiterConfig(ladder=("q8_8", "q16_16", "q8_24", "f32"), start_mode=args.mode)
    tcfg = TrainerConfig(
        total_steps=args.steps,
        ckpt_every=max(args.steps // 4, 1),
        ckpt_dir=args.ckpt_dir,
        start_mode=args.mode,
        use_arbiter=True,
        arbiter=arb_cfg,
    )
    data = DataConfig(vocab=cfg.vocab, seq_len=32 if args.tiny else 128,
                      global_batch=4 if args.tiny else 8)
    out = Trainer(cfg, tcfg, data_cfg=data, device=args.device).run()

    h = out["history"]
    for rec in h[:: max(len(h) // 20, 1)]:
        print(f"step {rec['step']:4d}  loss {rec['loss']:.4f}  "
              f"gnorm {rec['grad_norm']:.3f}  level {rec['level']}  {rec['dt']*1e3:.0f} ms")
    print(f"final loss: {out['final_loss']:.4f}  "
          f"switches: {out['switches']}  stragglers flagged: {len(out['straggler_events'])}")
    return out


if __name__ == "__main__":
    main()
