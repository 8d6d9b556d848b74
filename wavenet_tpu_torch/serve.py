"""Serving CLI — run an exported model as an HTTP synthesis service.

The port's counterpart of the repository's serve.py, for `.npz` weights
written by WaveNet.export_npz (either package) or a checkpoint directory
written by the port's trainer (EMA weights when the run kept them):

  python -m wavenet_tpu_torch.serve --npz model.npz --device cuda --port 8000
  python -m wavenet_tpu_torch.serve --ckpt runs/full --device cuda
  curl -X POST localhost:8000/synthesize \
       -d '{"seconds": 2.0, "seed": 7}' -o out.wav
  curl -X POST localhost:8000/synthesize \
       -d '{"seconds": 10.0, "stream": true}' --output raw.pcm   # int16 PCM
  curl localhost:8000/info
  # a mel-conditioned model (full_vocoder): log-mel frames, [frames, M]
  curl -X POST localhost:8000/synthesize \
       -d '{"seconds": 0.5, "seed": 7, "mel": [[...80 floats...], ...]}'

A directory of the JAX package's orbax checkpoints is refused with a message
that points to export_npz.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--npz", help="export_npz single-file weights")
    src.add_argument("--ckpt", help="checkpoint directory of the port's "
                                    "trainer (latest step, EMA weights when "
                                    "the run kept them)")
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (cuda runs the kernel)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8,
                   help="microbatch row cap (requests group up to this)")
    p.add_argument("--max-wait-ms", type=float, default=10.0,
                   help="batching window: how long a request waits for "
                        "company before the batch launches")
    p.add_argument("--chunk-seconds", type=float, default=0.5,
                   help="decode chunk size (streaming time-to-first-byte)")
    p.add_argument("--length-quantum-seconds", type=float, default=0.5,
                   help="requested lengths round up to this quantum")
    p.add_argument("--warmup-seconds", type=float, default=0.0,
                   help="synthesize this much audio through every batch "
                        "bucket at boot (builds the kernel before the "
                        "first request)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from wavenet_tpu_torch.models.api import WaveNet
    from wavenet_tpu_torch.serving import WaveNetServer
    from wavenet_tpu_torch.serving.http import make_server

    if args.ckpt:
        model = WaveNet.from_checkpoint(args.ckpt, device=args.device)
    else:
        model = WaveNet.from_npz(args.npz, device=args.device)
    engine = WaveNetServer(model, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms,
                           chunk_seconds=args.chunk_seconds,
                           length_quantum_seconds=args.length_quantum_seconds)
    if args.warmup_seconds > 0:
        engine.warmup(seconds=args.warmup_seconds, verbose=True)
    server = make_server(engine, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"serving {args.ckpt or args.npz} on http://{host}:{port} "
          f"({args.device}, "
          f"max_batch={args.max_batch}, chunk={args.chunk_seconds}s)",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.close(wait=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
