"""Evaluation CLI of the port (counterpart of the repository's score.py):
per-clip teacher-forced likelihood in bits per sample under a checkpoint
of the port's trainer.

  python -m wavenet_tpu_torch.score --ckpt runs/full eval/*.wav --device cuda
  python -m wavenet_tpu_torch.score --ckpt runs/voc --mel self eval/
  python -m wavenet_tpu_torch.score --ckpt runs/ms --speaker 3 clip.wav --json

Paths may be wav files or directories of them.  Long clips are scored in
windows of one fixed shape [1, RF + chunk] whose first positions hold the
true previous tokens (the positions before the clip's start masked with
forward_logits' valid_mask), so the result equals one forward over the
whole clip.  The model runs its scan forward (models/wavenet.forward_logits),
as the reference's CLI does.  --json prints the numbers unrounded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m wavenet_tpu_torch.score",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("paths", nargs="+", help="wav files or directories")
    p.add_argument("--ckpt", required=True,
                   help="checkpoint directory of the port's trainer")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--mel", choices=["self"], default=None,
                   help="'self': score each clip under its own log-mel "
                        "features (a mel checkpoint)")
    p.add_argument("--speaker", type=int, default=None,
                   help="speaker id (a global_classes checkpoint)")
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--chunk", type=int, default=16384,
                   help="targets scored per forward pass (memory bound)")
    p.add_argument("--json", action="store_true",
                   help="print one JSON object instead of the table")
    p.add_argument("--device", default="cuda",
                   help="torch device to score on")
    return p.parse_args(argv)


def iter_wavs(paths):
    for path in paths:
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                if name.lower().endswith(".wav"):
                    yield os.path.join(path, name)
        else:
            yield path


def score_clip(model, tokens, chunk: int, mel_self=None, speaker=None):
    """(mean bits per sample of tokens [T + 1] (numpy int), the T targets
    scored), exactly, in windows of the fixed shape [1, RF + chunk].
    mel_self: the clip's [1, F, M] log-mel frames (a mel model); speaker:
    an id (a speaker model)."""
    import numpy as np
    import torch

    from wavenet_tpu_torch.models import wavenet as wn
    from wavenet_tpu_torch.models.conditioning import upsample_mel

    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    cfg, dev = model.cfg, model.device
    params = model.params
    rf = cfg.receptive_field
    T = tokens.shape[0] - 1                      # target count
    W = rf + chunk                               # the window's shape
    with torch.no_grad():
        y = None
        if mel_self is not None:
            # features of the model's inputs (positions 0..T - 1); window
            # index = position + rf
            y = upsample_mel(params["upsampler"], cfg.mel,
                             torch.as_tensor(mel_self, device=dev), T)
            y = torch.nn.functional.pad(y, (0, 0, rf, W))
        sp = (None if speaker is None else
              torch.tensor([speaker], dtype=torch.int32, device=dev))
        # position a of the clip lives at padded[a + rf + 1]: one more slot
        # on the left, so the clip's first sample has the zero token as its
        # previous one (forward_logits' start of sequence)
        padded = torch.from_numpy(np.pad(tokens.astype(np.int32),
                                         (rf + 1, W))).to(dev)
        pos = torch.arange(W, device=dev)
        total_bits, total_n, s = 0.0, 0, 0
        while s < T:
            e = min(s + chunk, T)
            # the window holds positions [s - rf, s + chunk); those before
            # the clip's start are absent (valid_mask zero-fills them)
            inp = padded[s + 1:s + 1 + W][None]
            prev = padded[s:s + W][None]
            tgt = padded[s + 2:s + 2 + W][None]
            mask = (pos + (s - rf) >= 0).float()[None]
            logits = wn.forward_logits(
                params, cfg, inp, prev_tokens=prev, valid_mask=mask,
                upsampled_cond=None if y is None else y[:, s:s + W],
                speaker=sp)
            nll = -torch.gather(torch.log_softmax(logits, -1), -1,
                                tgt.long()[..., None])[0, :, 0]
            keep = nll[rf:rf + (e - s)]          # this window's targets
            total_bits += float(keep.double().sum()) / math.log(2.0)
            total_n += e - s
            s = e
    return total_bits / max(total_n, 1), total_n


def main(argv=None) -> float:
    """Returns the mean bits per sample over every clip's targets."""
    args = parse_args(argv)

    from wavenet_tpu_torch.audio import mulaw
    from wavenet_tpu_torch.audio.io import read_wav
    from wavenet_tpu_torch.models.api import WaveNet

    model = WaveNet.from_checkpoint(args.ckpt, step=args.step,
                                    use_ema=not args.no_ema,
                                    device=args.device)
    cfg = model.cfg
    if args.mel == "self" and cfg.mel is None:
        sys.exit("--mel self requires a mel-conditional checkpoint")
    if args.mel is None and cfg.mel is not None:
        sys.exit("checkpoint is mel-conditional; pass --mel self to score "
                 "each clip under its own features")
    if args.speaker is not None and cfg.global_classes is None:
        sys.exit("--speaker requires a global_classes checkpoint")
    if args.speaker is None and cfg.global_classes is not None:
        sys.exit(f"checkpoint was trained with global_classes="
                 f"{cfg.global_classes}; pass --speaker")
    if cfg.global_classes is not None and not \
            0 <= args.speaker < cfg.global_classes:
        sys.exit(f"--speaker must be in [0, {cfg.global_classes})")

    results = []
    for path in iter_wavs(args.paths):
        wave, _ = read_wav(path, cfg.sample_rate)
        tokens = mulaw.encode_np(wave, cfg.quantization_channels)
        mel_self = None
        if args.mel == "self":
            from wavenet_tpu_torch.audio.mel import log_mel
            mel_self = log_mel(wave, cfg.sample_rate, cfg.mel)[None]
        bits, n = score_clip(model, tokens, args.chunk, mel_self,
                             args.speaker)
        results.append({"file": path, "bits_per_sample": bits,
                        "samples": n})
        if not args.json:
            print(f"{bits:8.4f} bits/sample  {n:>9d} samples  {path}")

    if not results:
        sys.exit("no wav files found")
    agg = (sum(r["bits_per_sample"] * r["samples"] for r in results)
           / sum(r["samples"] for r in results))
    if args.json:
        print(json.dumps({"files": results, "bits_per_sample": agg}))
    else:
        print(f"{agg:8.4f} bits/sample  over {len(results)} file(s)")
    return agg


if __name__ == "__main__":
    main()
