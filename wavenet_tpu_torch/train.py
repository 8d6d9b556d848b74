"""Training CLI of the port (counterpart of the repository's train.py).

  python -m wavenet_tpu_torch.train --preset full --synthetic --steps 100 \
      --device cuda --ckpt runs/full --ckpt-every 50
  python -m wavenet_tpu_torch.train --config runs/full/params.json \
      --ckpt runs/full --resume --steps 100

  python -m wavenet_tpu_torch.train --preset full_vocoder --synthetic \
      --steps 100 --device cuda
  python -m wavenet_tpu_torch.train --preset full --data corpus \
      --override 'global_classes=109' --steps 100 --device cuda

On a CUDA device the conv stack of supported configs (`full` and the
mel-conditioned `full_vocoder` among them, with or without speakers) runs
through the fused layer-group kernels (csrc/train_stack.cu); a mel model
trains on the log-mel frames of its clips (synthetic clips included), a
speaker model on its clips' ids (corpus/<speaker>/*.wav by subdirectory,
synthetic clips by index mod global_classes).

  python -m wavenet_tpu_torch.train --preset full --synthetic --steps 1000 \
      --device cuda --ckpt runs/full --sample-every 500 --profile-dir prof

--sample-every N (with --ckpt) writes <ckpt>/sample_step<step>.wav every N
steps, --sample-seconds long, sampled from the current raw params through
the decode kernel with its own seeds (row seeds of 0): it draws nothing
from the training data or any generator training uses, so the losses and
params are the same as without it.  --profile-dir writes a Chrome trace of
steps 10-15 (utils/profiling.profiled_steps); unlike the reference, it may
be combined with --sample-every and --eval-every.  A mel model's samples
need mel frames, so --sample-every refuses it (WaveNet.vocode samples
one); a speaker model samples speaker 0.

Data parallelism: one process per rank, started by torchrun, with
data_parallel equal to the world size:

  torchrun --nproc_per_node 4 -m wavenet_tpu_torch.train --preset full \
      --synthetic --override data_parallel=4 --ckpt runs/full

Each rank trains on cuda:LOCAL_RANK unless --device names another, over
the nccl backend for a CUDA device and gloo for the CPU unless
--dist-backend names one (two ranks on one card need gloo: nccl refuses a
device twice).  The batch size is the global one; each rank feeds its
rows.  Only rank 0 logs, writes the metrics file and the checkpoints,
samples and traces.

The mesh's seq and model axes (world size = data x seq x model):

  torchrun --nproc_per_node 2 -m wavenet_tpu_torch.train --preset full \
      --synthetic --override seq_parallel=2 --ckpt runs/sp
  torchrun --nproc_per_node 2 -m wavenet_tpu_torch.train --preset full \
      --synthetic --override model_parallel=2 \
      --override pipeline_microbatch=2 --ckpt runs/pp

The route is the reference's (training/trainer.choose_route): seq > 1
runs overlap-discard on the fused stack when it takes the config, else
the halo-exchange scan; model > 1 runs the layer pipeline on the stack
when the stages own whole blocks (num_blocks % model == 0), else the
Megatron-split scan.  Two ranks on one card need --dist-backend gloo.
Checkpoints hold the whole model (gathered over `model` before rank 0
writes), so they load, resume and decode in one process.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of steps 10-15 "
                        "here")
    p.add_argument("--sample-every", type=int, default=0,
                   help="every N steps, write <ckpt>/sample_step<step>.wav "
                        "(needs --ckpt)")
    p.add_argument("--sample-seconds", type=float, default=1.0)
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
    p.add_argument("--device", default=None,
                   help="torch device to train on (cuda runs the kernels; "
                        "default cuda, cuda:LOCAL_RANK under torchrun)")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="torch.distributed backend under torchrun (default: "
                        "nccl for a CUDA device, gloo for the CPU)")
    from wavenet_tpu_torch.utils import compcache
    compcache.add_cli_flag(p)
    args = p.parse_args(argv)
    if args.device is None:
        from wavenet_tpu_torch.parallel import distributed
        args.device = (f"cuda:{distributed.local_rank()}"
                       if distributed.launched() else "cuda")
    return args


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
    from wavenet_tpu_torch.parallel import distributed
    from wavenet_tpu_torch.utils import compcache
    args = parse_args(argv)
    cache_dir = compcache.enable_from_args(args)
    if cache_dir:
        print(f"kernel build cache: {cache_dir}", file=sys.stderr)
    started = distributed.initialize(args.dist_backend, device=args.device)
    try:
        return _train(args)
    finally:
        if started:
            distributed.shutdown()


def _train(args):
    from wavenet_tpu_torch.audio.dataset import AudioDataset
    from wavenet_tpu_torch.parallel import distributed
    from wavenet_tpu_torch.training.metrics import MetricsLogger
    from wavenet_tpu_torch.training.trainer import Trainer

    cfg = build_config(args)
    primary = distributed.is_primary()
    sample_every = args.sample_every if args.ckpt else 0
    if sample_every and cfg.mel is not None:
        raise SystemExit("--sample-every needs mel frames for a mel model; "
                         "sample its checkpoint with WaveNet.vocode")

    if args.synthetic or not args.data:
        if primary:
            print("using synthetic dataset", file=sys.stderr)
        ds = AudioDataset.synthetic(cfg, num_clips=8, clip_seconds=4.0)
    else:
        ds = AudioDataset.from_dir(args.data, cfg)

    tr = Trainer(cfg, ds, checkpoint_dir=args.ckpt, device=args.device)
    if args.resume and tr.ckpt and tr.ckpt.latest_step() is not None:
        tr.restore()
        if primary:
            print(f"resumed at step {tr.state.step}", file=sys.stderr)
    eval_ds = AudioDataset.from_dir(args.eval_data, cfg) \
        if args.eval_data else None
    mlog = MetricsLogger(args.metrics_file, also_print=False) \
        if args.metrics_file and primary else None

    def log_fn(msg):
        if primary:
            print(msg, file=sys.stderr)

    def run_chunk(n):
        m = tr.run(n, log_every=args.log_every,
                   checkpoint_every=args.ckpt_every if args.ckpt else None,
                   log_fn=log_fn, metrics_fn=mlog.log if mlog else None)
        if mlog:
            mlog.log(tr.state.step, m)
        return m

    def sample(params):
        from wavenet_tpu_torch.generate.sampler import generate_wav
        out = os.path.join(args.ckpt, f"sample_step{tr.state.step}.wav")
        speaker = None if cfg.global_classes is None else [0]
        generate_wav(params, cfg, out, args.sample_seconds,
                     device=tr.device, speaker=speaker)
        print(f"wrote {out}", file=sys.stderr)

    def run_eval():
        em = tr.evaluate(eval_ds)
        log_fn("step %d  %s" % (tr.state.step, "  ".join(
            f"{k} {v:.4f}" for k, v in sorted(em.items()))))
        if mlog:
            mlog.log(tr.state.step, em)
        return em

    def train():
        if not (sample_every or args.eval_every):
            return run_chunk(args.steps)
        # every rank runs the same chunks; only rank 0 samples
        chunk = math.gcd(sample_every, args.eval_every)
        done, metrics = 0, {}
        while done < args.steps:
            n = min(chunk, args.steps - done)
            metrics = run_chunk(n)
            done += n
            if sample_every and done % sample_every == 0:
                # the whole params: a gather over `model` on every rank of
                # a model-split mesh
                params = tr.full_params()
                if primary:
                    sample(params)
            if args.eval_every and done % args.eval_every == 0:
                metrics.update(run_eval())
        return metrics

    try:
        if args.profile_dir and primary:
            from wavenet_tpu_torch.utils.profiling import profiled_steps
            with profiled_steps(tr, args.profile_dir, start=10, stop=15):
                metrics = train()
        else:
            metrics = train()
        if args.ckpt:
            tr.save()
    finally:
        if mlog:
            mlog.close()
    if primary:
        print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
