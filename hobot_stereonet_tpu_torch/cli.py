"""Command-line interface of the port.

Counterpart of ``hobot_stereonet_tpu/cli.py``; only ``train`` is ported::

    python -m hobot_stereonet_tpu_torch.cli train --config checkpoints/flagship/config.json \\
        --steps N --batch 8 [--model classic] [--checkpoint DIR] [--device cpu]

It prints the final metrics as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys


def _make_config(args):
    """``--config`` JSON (``Config.from_json``) if given, else the defaults."""
    from .config import Config

    return Config.from_json(args.config) if args.config else Config()


def cmd_train(args) -> int:
    from .runtime.train_loop import train_synthetic

    cfg = _make_config(args)
    metrics = train_synthetic(
        steps=args.steps,
        batch_size=args.batch,
        checkpoint_dir=args.checkpoint,
        log_every=args.log_every,
        lr=args.lr,
        seed=args.seed,
        resume_from=args.resume,
        model=args.model,
        model_cfg=cfg.model,
        color_space=cfg.preprocess.color_space,
        device=args.device,
    )
    print(json.dumps(metrics))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="hobot_stereonet_tpu_torch.cli", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", default=None, metavar="JSON",
                        help="load a full Config from JSON (Config.from_json)")
        sp.add_argument("--model", default="fast", choices=["fast", "classic"],
                        help="network: fast (the streaming flagship) or classic "
                             "(the StereoNet paper's 3-D conv build)")
        sp.add_argument("--device", default=None,
                        help="torch device (default cuda:0; cpu runs the kernels' plain versions)")

    pt = sub.add_parser("train", help="train on procedural scenes")
    pt.add_argument("--steps", type=int, default=100)
    pt.add_argument("--batch", type=int, default=4)
    pt.add_argument("--checkpoint", default=None,
                    help="directory to save the training state into (params.npz, opt_state.pt)")
    pt.add_argument("--log-every", type=int, default=20)
    pt.add_argument("--lr", type=float, default=1e-3)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--resume", default=None,
                    help="checkpoint to continue training from (weights only; a fresh optimizer)")
    common(pt)
    pt.set_defaults(fn=cmd_train)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
