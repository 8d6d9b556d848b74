"""Training CLI of the port (counterpart of the repository's train.py).

  python -m wavenet_tpu_torch.train --preset full --synthetic --steps 100 \
      --device cuda --ckpt runs/full --ckpt-every 50
  python -m wavenet_tpu_torch.train --config runs/full/params.json \
      --ckpt runs/full --resume --steps 100

  python -m wavenet_tpu_torch.train --preset full_vocoder --synthetic \
      --steps 100 --device cuda

On a CUDA device the conv stack of supported configs (`full` and the
mel-conditioned `full_vocoder` among them) runs through the fused
layer-group kernels (csrc/train_stack.cu); a mel model trains on the
log-mel frames of its clips (synthetic clips included).  The
reference's --profile-dir and --sample-every are not ported yet (ROADMAP
queue 1 item 9).
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--preset", default="tiny",
                   help="config preset (tiny/small/full/fastgen_bench/"
                        "conditional/full_vocoder)")
    p.add_argument("--config", default=None,
                   help="path to a params.json (overrides --preset)")
    p.add_argument("--data", default=None, help="directory of .wav files")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic sine mixtures (smoke runs)")
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--ckpt", default=None, help="checkpoint directory")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--eval-every", type=int, default=0,
                   help="run the held-out evaluation every N steps")
    p.add_argument("--eval-data", default=None,
                   help="directory of held-out .wav files for --eval-every "
                        "(default: held-out batches of the training set)")
    p.add_argument("--metrics-file", default=None,
                   help="append JSONL metrics here")
    p.add_argument("--override", action="append", default=[],
                   help="config overrides as key=json, e.g. "
                        "--override train_window=512")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda runs the kernels)")
    return p.parse_args(argv)


def build_config(args):
    from wavenet_tpu_torch.config import WaveNetConfig, get_config
    if args.config:
        with open(args.config) as f:
            cfg = WaveNetConfig.from_json(f.read())
    else:
        cfg = get_config(args.preset)
    kw = {}
    if args.batch_size is not None:
        kw["batch_size"] = args.batch_size
    if args.lr is not None:
        kw["learning_rate"] = args.lr
    for ov in args.override:
        k, v = ov.split("=", 1)
        kw[k] = json.loads(v)
    return cfg.replace(**kw) if kw else cfg


def main(argv=None):
    args = parse_args(argv)
    cfg = build_config(args)

    from wavenet_tpu_torch.audio.dataset import AudioDataset
    from wavenet_tpu_torch.training.metrics import MetricsLogger
    from wavenet_tpu_torch.training.trainer import Trainer

    if args.synthetic or not args.data:
        print("using synthetic dataset", file=sys.stderr)
        ds = AudioDataset.synthetic(cfg, num_clips=8, clip_seconds=4.0)
    else:
        ds = AudioDataset.from_dir(args.data, cfg)

    tr = Trainer(cfg, ds, checkpoint_dir=args.ckpt, device=args.device)
    if args.resume and tr.ckpt and tr.ckpt.latest_step() is not None:
        tr.restore()
        print(f"resumed at step {tr.state.step}", file=sys.stderr)
    eval_ds = AudioDataset.from_dir(args.eval_data, cfg) \
        if args.eval_data else None
    mlog = MetricsLogger(args.metrics_file, also_print=False) \
        if args.metrics_file else None

    def log_fn(msg):
        print(msg, file=sys.stderr)

    def run_chunk(n):
        m = tr.run(n, log_every=args.log_every,
                   checkpoint_every=args.ckpt_every if args.ckpt else None,
                   log_fn=log_fn, metrics_fn=mlog.log if mlog else None)
        if mlog:
            mlog.log(tr.state.step, m)
        return m

    try:
        if args.eval_every:
            done, metrics = 0, {}
            while done < args.steps:
                n = min(args.eval_every, args.steps - done)
                metrics = run_chunk(n)
                done += n
                if done % args.eval_every == 0:
                    em = tr.evaluate(eval_ds)
                    print("step %d  %s" % (tr.state.step, "  ".join(
                        f"{k} {v:.4f}" for k, v in sorted(em.items()))),
                        file=sys.stderr)
                    if mlog:
                        mlog.log(tr.state.step, em)
                    metrics.update(em)
        else:
            metrics = run_chunk(args.steps)
        if args.ckpt:
            tr.save()
    finally:
        if mlog:
            mlog.close()
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
