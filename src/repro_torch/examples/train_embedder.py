"""End to end: train a ~100M-param LM for a few hundred steps with
the full production stack (sharded data pipeline, AdamW, checkpointing,
crash recovery, straggler watchdog), the model the retrieval encoder
then reuses.

The default config is a ~100M llama-family model (SwiGLU, untied
embeddings); --tiny shrinks it to the tiny llama3-8b for CI.

Run:  python -m repro_torch.examples.train_embedder [--tiny] [--steps N]
          [--ckpt-dir DIR] [--device cpu]
(the default checkpoint directory is ``repro_torch_train_embedder`` under
the temporary directory; a second run on the same directory resumes)
"""

from __future__ import annotations

import os
import tempfile

from . import _common


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_train_embedder")


def model_100m():
    from repro_torch.models.common import ArchConfig

    return ArchConfig(
        name="repro-100m",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        d_ff=2048,
        vocab_size=32_000,
        compute_dtype="float32",
        remat="none",
    )


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--tiny", action="store_true", help="CI-sized model")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt-dir", default="")
    args = ap.parse_args(argv)
    dev = _common.device("train_embedder", args.device)

    from repro_torch.configs import get_tiny
    from repro_torch.data import DataConfig
    from repro_torch.optim import OptimConfig
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig

    cfg = get_tiny("llama3_8b").replace(compute_dtype="float32") \
        if args.tiny else model_100m()
    if args.tiny:
        args.steps, args.seq_len, args.batch = 30, 64, 8
    n_params = cfg.param_count()
    print(f"model: {cfg.name} ({n_params / 1e6:.1f}M params) on {dev}")

    ckpt_dir = args.ckpt_dir or default_ckpt_dir()
    trainer = Trainer(
        cfg=cfg,
        ocfg=OptimConfig(
            peak_lr=3e-4, warmup_steps=min(50, args.steps // 5),
            decay_steps=args.steps,
        ),
        tcfg=TrainConfig(microbatches=2),
        rcfg=TrainerConfig(
            total_steps=args.steps,
            checkpoint_every=max(10, args.steps // 5),
            checkpoint_dir=ckpt_dir,
            log_every=10,
        ),
        data_cfg=DataConfig(
            vocab_size=cfg.vocab_size,
            seq_len=args.seq_len,
            global_batch=args.batch,
        ),
        device=dev,
    )
    out = trainer.run()
    losses = out["losses"]
    print(f"steps: {out['final_step']}  restarts: {out['restarts']}")
    head = sum(losses[:10]) / min(10, len(losses))
    tail = sum(losses[-10:]) / min(10, len(losses))
    print(f"loss: first10 {head:.4f} -> last10 {tail:.4f}")
    assert tail < head, "training must reduce loss"
    print(f"checkpoints in {ckpt_dir} "
          f"(restart this script — it resumes bit-exactly)")


if __name__ == "__main__":
    main()
