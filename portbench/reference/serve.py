"""Judging served audio against the reference.

The port samples a token as the argmax of logits / T plus Gumbel noise
keyed by (request seed, step, class) through a counter hash (a murmur3
finalizer over 32-bit words).  Given that noise the token is a greedy
choice, so each served token is judged as a greedy one: its gap is how far
its noisy score, logits_ref * (1/T) + g, lies below the best class's, by
the reference's logits.  A correct program reads rounding; a token altered
or drawn with the wrong seed or step reads the spread of the noise.

`noise` is worked out again here from the hash's definition; the served
tokens come from the received waveform by the nearest mu-law level.  A mel
request's frames are upsampled alone, to its own length, as the reference
upsamples any sequence; a speaker request's id is its row's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference import data, model

M32 = 0xFFFFFFFF


def _mul(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 on int64 holding 32-bit words, c in halves so no
    product leaves int64."""
    return ((h * (c & 0xFFFF)) + (((h * (c >> 16)) & 0xFFFF) << 16)) & M32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def noise(seed: int, n: int, Q: int, device) -> torch.Tensor:
    """[n, Q] float64 Gumbel noise of a request seed at steps 0..n-1."""
    q = torch.arange(Q, dtype=torch.int64, device=device)
    t = torch.arange(n, dtype=torch.int64, device=device)
    s = _mul(torch.tensor(int(seed) & M32, device=device), 0x9E3779B9)
    step = _mul(t, 0x7F4A7C15)
    h = (s + step[:, None] + q[None, :]) & M32
    bits = _fmix((_fmix(h) + q[None, :]) & M32)
    u = (bits >> 8).double() / float(1 << 24) + 1e-12
    return -torch.log(-torch.log(u))


def tokens_of(audio: np.ndarray, Q: int, tol: float = 1e-6) -> np.ndarray:
    """The classes of received samples by the nearest mu-law level; a
    sample farther than tol from every level raises ValueError."""
    lv = data.levels(Q)
    x = np.asarray(audio, np.float64)
    i = np.clip(np.searchsorted(lv, x), 1, Q - 1)
    lo, hi = lv[i - 1], lv[i]
    k = np.where(np.abs(x - lo) <= np.abs(hi - x), i - 1, i)
    off = np.abs(x - lv[k])
    if off.size and off.max() > tol:
        raise ValueError(f"a received sample lies {off.max():.3g} from every "
                         f"mu-law level")
    return k.astype(np.int64)


def _teacher_inputs(tokens: Sequence[np.ndarray], Q: int, device):
    """[N, n_max] inputs [Q // 2, s_0, .., s_{n-2}] right-padded with the
    silence class (causal: padding follows every position judged)."""
    n_max = max(len(t) for t in tokens)
    x = np.full((len(tokens), n_max), Q // 2, np.int64)
    for i, t in enumerate(tokens):
        x[i, 1:len(t)] = t[:-1]
    return torch.from_numpy(x).to(device)


@torch.no_grad()
def gaps(w: Dict[str, torch.Tensor], dilations, tokens: List[np.ndarray],
         seeds: Sequence[int], temperature: float, rows: int,
         control: bool = False, mels: Optional[Sequence[np.ndarray]] = None,
         speakers: Optional[Sequence[int]] = None) -> List[float]:
    """Per request, the widest gap of its served tokens (control=False),
    or of the tokens that the reference in fp8 puts first at each of its
    positions (control=True), by the float32 reference's noisy scores.
    mels: each request's [F, M] frames (a mel model); speakers: each
    request's id (a speaker model)."""
    Q = w["head_b2"].shape[0]
    dev = w["head_b2"].device
    inv_t = float(np.float32(1.0) / np.float32(temperature))
    out = []
    for i in range(0, len(tokens), rows):
        part = tokens[i:i + rows]
        x = _teacher_inputs(part, Q, dev)
        lens = [len(t) for t in part]

        def run(precision):
            y = (None if mels is None else model.features(
                w, mels[i:i + rows], lens, x.shape[1], precision))
            spk = (None if speakers is None else torch.as_tensor(
                list(speakers[i:i + rows]), device=dev))
            return model.logits(w, dilations, x, precision, y=y,
                                speaker=spk)
        ref = run("float32")
        low = run("fp8") if control else None
        for j, t in enumerate(part):
            n = len(t)
            g = noise(seeds[i + j], n, Q, dev)
            score = ref[j, :n].double() * inv_t + g
            if control:
                pick = torch.argmax(low[j, :n].double() * inv_t + g, dim=-1)
            else:
                pick = torch.from_numpy(np.asarray(t)).to(dev)
            chosen = score.gather(1, pick[:, None])[:, 0]
            out.append(float((score.max(dim=-1).values - chosen).max()))
        del ref, low
    return out
