"""Training entry point (a port of the reference's ``launch/train.py``, with
the same flags and summary line).

    python -m repro_torch.launch.train --arch gemma_2b --tiny --steps 8 \\
        --ckpt-dir <dir> [--microbatches 2]

It runs on the CUDA device; ``--device cpu`` runs on the CPU with every
kernel's plain version. ``--mesh-shape`` and ``--grad-compression int8``
need several cards and are not ported. The random weights come from the
trainer's seed through the port's own generator, so they are not the
reference's.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train"))
    ap.add_argument("--tiny", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--mesh-shape", default="",
                    help="e.g. 2,4 (not ported: needs several cards)")
    ap.add_argument("--mesh-axes", default="data,model")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA device)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_tiny
    from repro_torch.data import DataConfig
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models.common import not_ported
    from repro_torch.optim import OptimConfig
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig

    if args.mesh_shape:
        raise not_ported("training over a mesh (--mesh-shape)")
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"repro_torch.launch.train: {e}")
    cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
    trainer = Trainer(
        cfg=cfg,
        ocfg=OptimConfig(
            peak_lr=3e-4,
            warmup_steps=max(1, args.steps // 10),
            decay_steps=args.steps,
        ),
        tcfg=TrainConfig(
            microbatches=args.microbatches,
            grad_compression=args.grad_compression,
        ),
        rcfg=TrainerConfig(
            total_steps=args.steps,
            checkpoint_every=max(1, args.steps // 4),
            checkpoint_dir=args.ckpt_dir,
        ),
        data_cfg=DataConfig(
            vocab_size=cfg.vocab_size,
            seq_len=args.seq_len,
            global_batch=args.global_batch,
        ),
        device=dev,
    )
    out = trainer.run()
    print(
        f"arch={cfg.name} steps={out['final_step']} "
        f"restarts={out['restarts']} "
        f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}"
    )


if __name__ == "__main__":
    main()
