"""Single-device training: the optimizer, the train step and `Trainer`.

Counterpart of wavenet_tpu/training/trainer.py on one device.  The
optimizer follows optax exactly, written as plain tensor code:
  * adam(lr_schedule, b1, b2): eps = 1e-8 outside the square root, bias
    corrections 1 - b^count with count incremented first, and the schedule
    read at the count BEFORE the increment (so warmup's first step uses
    lr(0) = 0);
  * clip_by_global_norm(c) before it: g * (c / |g|) when |g| >= c, with no
    epsilon added to the norm;
  * grad_accum = k > 1 as optax.MultiSteps: a running mean of k microbatch
    gradients, applied on every k-th step; the schedule count, the clip and
    the EMA see only applied steps;
  * EMA of params after each applied update.
The step takes the fused layer-group stack when cfg.fused_stack and
train_stack.supported(cfg, T) (use_fused_stack): the CUDA kernels for
tensors on the card, their plain versions on the CPU.
Every op of the step has a fixed summation order (the kernels' split-K
sums, the embedding's one-hot backward, the upsampler's shifted f32
products), so a resumed run repeats an uninterrupted one bit for bit.
A mel model's batches carry "mel" frames; its upsampler and v_cond train
with the rest.  The state holds params, optimizer moments and EMA as flat
leaves under '/'-joined names ("upsampler/w0"), the model's nested params
rebuilt for each loss call; JAX's optax walks the same leaves in the same
sorted order.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from wavenet_tpu_torch.audio.dataset import AudioDataset, IteratorState
from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops.cuda import train_stack
from wavenet_tpu_torch.training.metrics import ThroughputMeter
from wavenet_tpu_torch.utils.pytree_io import flatten_tree, unflatten_tree

f32 = np.float32


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: dict
    step: int
    ema: Optional[Dict[str, torch.Tensor]] = None


def make_lr_schedule(cfg: WaveNetConfig) -> Callable[[int], np.float32]:
    """count -> learning rate, in float32 as optax computes it."""
    peak = cfg.learning_rate
    floor = peak * cfg.lr_min_ratio
    if cfg.lr_schedule == "constant":
        def sched(count):
            return f32(peak)
    elif cfg.lr_schedule == "cosine":
        steps, alpha = cfg.lr_decay_steps, cfg.lr_min_ratio

        def sched(count):
            c = f32(min(count, steps))
            cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(steps)))
            return f32(peak) * (f32(1 - alpha) * cosine + f32(alpha))
    elif cfg.lr_schedule == "exponential":
        steps, rate = cfg.lr_decay_steps, cfg.lr_min_ratio

        def sched(count):
            if count <= 0:
                return f32(peak)
            v = f32(peak) * np.power(f32(rate), f32(count) / f32(steps))
            return max(v, f32(floor)) if rate < 1.0 else min(v, f32(floor))
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if not cfg.warmup_steps:
        return sched
    warm = cfg.warmup_steps

    def warmed(count):
        if count >= warm:
            return sched(count - warm)
        frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
        return f32(0.0 - peak) * frac + f32(peak)
    return warmed


def _global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares, leaves in sorted key order (JAX's)."""
    total = None
    for k in sorted(tree):
        s = torch.sum(tree[k] * tree[k])
        total = s if total is None else total + s
    return torch.sqrt(total)


class Optimizer:
    """The reference's make_optimizer(cfg) as plain tensor code.  State is
    a dict of tensors and ints (torch.save-able); update() is functional."""

    def __init__(self, cfg: WaveNetConfig):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        z = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        state = {"count": 0, "mu": z(), "nu": z()}
        if self.cfg.grad_accum > 1:
            state.update(mini_step=0, acc_grads=z())
        return state

    def _apply(self, g, state, params):
        """clip + adam + lr on gradient tree g; returns (params, state)."""
        cfg = self.cfg
        if cfg.grad_clip_norm is not None:
            norm = _global_norm(g)
            if not bool(norm < cfg.grad_clip_norm):
                g = {k: (v / norm) * cfg.grad_clip_norm for k, v in g.items()}
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        count = state["count"]
        count_inc = count + 1
        bc1 = f32(1) - np.power(f32(b1), f32(count_inc))
        bc2 = f32(1) - np.power(f32(b2), f32(count_inc))
        step_size = float(f32(-1) * self.schedule(count))
        mu, nu, out = {}, {}, {}
        for k, p in params.items():
            mu[k] = (1 - b1) * g[k] + b1 * state["mu"][k]
            nu[k] = (1 - b2) * (g[k] * g[k]) + b2 * state["nu"][k]
            u = (mu[k] / float(bc1)) / (torch.sqrt(nu[k] / float(bc2)) + 1e-8)
            out[k] = p + step_size * u
        return out, dict(state, count=count_inc, mu=mu, nu=nu)

    def update(self, grads, state, params):
        """-> (params, state, applied, grad_norm tensors for the metrics)."""
        k = self.cfg.grad_accum
        if k == 1:
            p, s = self._apply(grads, state, params)
            return p, s, True, {"grad_norm": _global_norm(grads)}
        n = state["mini_step"]
        acc = {key: a + (grads[key] - a) / float(n + 1)
               for key, a in state["acc_grads"].items()}
        norms = {"grad_norm": _global_norm(acc),
                 "microbatch_grad_norm": _global_norm(grads)}
        if n < k - 1:
            return params, dict(state, mini_step=n + 1, acc_grads=acc), \
                False, norms
        p, s = self._apply(acc, state, params)
        s = dict(s, mini_step=0,
                 acc_grads={key: torch.zeros_like(a) for key, a in acc.items()})
        return p, s, True, norms


def make_optimizer(cfg: WaveNetConfig) -> Optimizer:
    return Optimizer(cfg)


def ema_update(ema, params, decay: float):
    """Polyak average after an applied update: d * ema + (1 - d) * p."""
    return {k: decay * e + (1.0 - decay) * params[k] for k, e in ema.items()}


def _check_single_device(cfg: WaveNetConfig) -> None:
    wn.check_supported(cfg)
    if max(cfg.data_parallel, cfg.model_parallel, cfg.seq_parallel) > 1:
        raise NotImplementedError(
            "data_parallel, model_parallel and seq_parallel > 1 are not "
            "ported yet (ROADMAP queue 1 item 11)")


def use_fused_stack(cfg: WaveNetConfig, T: int, device) -> bool:
    """The step's route, as the reference decides it: the fused stack when
    cfg.fused_stack and train_stack.supported(cfg, T), else the scan.  On
    a CUDA device the fused stack is the kernels; widths they do not take
    raise NotImplementedError instead of taking another path."""
    use = bool(cfg.fused_stack and train_stack.supported(cfg, T))
    if use and torch.device(device).type == "cuda":
        train_stack.check_kernel_supported(cfg)
    return use


def _leaves(params) -> Dict[str, torch.Tensor]:
    """Nested or flat params -> flat trainable leaves ('/'-joined names)."""
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in flatten_tree(params).items()}


class Trainer:
    """Training on one device: deterministic data, the train step, eval,
    and exact-resume checkpoints.  params: optional initial params (e.g.
    carried over from the JAX package); default: init_params seeded by
    cfg.seed."""

    def __init__(self, cfg: WaveNetConfig, dataset: AudioDataset,
                 checkpoint_dir: Optional[str] = None, device="cuda",
                 params: Optional[Dict[str, torch.Tensor]] = None):
        _check_single_device(cfg)
        self.cfg = cfg
        self.dataset = dataset
        self.device = torch.device(device)
        self.use_fused = use_fused_stack(cfg, cfg.train_window, self.device)
        if params is None:
            params = wn.init_params(
                cfg, torch.Generator().manual_seed(cfg.seed), self.device)
        params = _leaves({k: torch.as_tensor(v).to(self.device)
                          for k, v in flatten_tree(params).items()})
        self.tx = make_optimizer(cfg)
        ema = ({k: v.detach().clone() for k, v in params.items()}
               if cfg.ema_decay is not None else None)
        self.state = TrainState(params, self.tx.init(params), 0, ema)
        self.iter_state = IteratorState(seed=cfg.seed, step=0)
        self.ckpt = None
        if checkpoint_dir is not None:
            from wavenet_tpu_torch.training.checkpoint import \
                CheckpointManager
            self.ckpt = CheckpointManager(checkpoint_dir, cfg)

    # ------------------------------------------------------------------
    def step(self, tokens: torch.Tensor,
             mel: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step (or accumulation microstep) on [B, W+1]
        tokens (and a mel model's [B, F, M] frames); returns the metrics as
        0-d tensors (not fetched)."""
        cfg, st = self.cfg, self.state
        loss, aux = wn.loss_fn(unflatten_tree(st.params), cfg, tokens,
                               mel=mel, use_fused=self.use_fused)
        keys = sorted(st.params)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [st.params[k] for k in keys])))
        with torch.no_grad():
            params, opt_state, applied, norms = self.tx.update(
                grads, st.opt_state, st.params)
            ema = st.ema
            if ema is not None and applied:
                ema = ema_update(ema, params, cfg.ema_decay)
        if applied:
            params = _leaves(params)
        self.state = TrainState(params, opt_state, st.step + 1, ema)
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics.update(norms)
        return metrics

    def _batch(self, batch):
        """A host batch -> (tokens, mel or None) on the trainer's device."""
        mel = batch.get("mel")
        return (torch.from_numpy(batch["tokens"]).to(self.device),
                None if mel is None else torch.from_numpy(mel).to(self.device))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, num_steps: int, log_every: int = 50,
            checkpoint_every: Optional[int] = None, log_fn=print,
            metrics_fn=None) -> Dict[str, float]:
        """Train for num_steps; returns the last metrics plus throughput
        (steps_per_sec, audio_seconds_per_sec, samples_per_sec, first step
        excluded).  metrics_fn(global_step, dict) is called at every log
        point; metrics are fetched from the device only there and at the
        end."""
        if num_steps <= 0:
            return {}
        cfg = self.cfg
        samples_per_batch = cfg.batch_size * cfg.train_window
        meter = ThroughputMeter(samples_per_batch / cfg.sample_rate,
                                samples_per_batch)
        for i in range(num_steps):
            batch, self.iter_state = self.dataset.sample_batch(
                self.iter_state)
            metrics = self.step(*self._batch(batch))
            if i == 0:
                self._sync()                  # exclude the first step
            meter.tick()
            if log_every and i % log_every == 0 and i < num_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                log_fn(f"step {i + 1} loss {m['loss']:.4f} "
                       f"acc {m['accuracy']:.3f}")
                if metrics_fn:
                    metrics_fn(self.state.step, m)
            if self.ckpt and checkpoint_every and \
                    (i + 1) % checkpoint_every == 0:
                self.save()
        self._sync()
        last = {k: float(v) for k, v in metrics.items()}
        last.update(meter.rates())
        if log_every:
            log_fn(f"step {num_steps} loss {last['loss']:.4f} "
                   f"acc {last['accuracy']:.3f}")
        return last

    # ------------------------------------------------------------------
    def evaluate(self, dataset: Optional[AudioDataset] = None,
                 num_batches: int = 8, seed: int = 987) -> Dict[str, float]:
        """Mean loss/accuracy over deterministic held-out batches (the same
        stack routing as training, without gradients)."""
        ds = dataset or self.dataset
        it = IteratorState(seed=seed, step=0)
        sums: Dict[str, float] = {}
        with torch.no_grad():
            for _ in range(num_batches):
                batch, it = ds.sample_batch(it)
                tokens, mel = self._batch(batch)
                _, aux = wn.loss_fn(unflatten_tree(self.state.params),
                                    self.cfg, tokens, mel=mel,
                                    use_fused=self.use_fused)
                for k, v in aux.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
        return {f"eval_{k}": v / num_batches for k, v in sums.items()}

    # ------------------------------------------------------------------
    def save(self) -> None:
        """Checkpoint the current state (synchronous: durable on return)."""
        if self.ckpt is None:
            raise ValueError("no checkpoint_dir was given")
        st = self.state
        self.ckpt.save(st.step, {"params": st.params,
                                 "opt_state": st.opt_state, "ema": st.ema},
                       self.iter_state)

    def restore(self, step: Optional[int] = None) -> TrainState:
        """Load a checkpoint (the latest by default) into the trainer.  An
        EMA missing from the file starts from a copy of the params; one
        present but off in the config is dropped."""
        if self.ckpt is None:
            raise ValueError("no checkpoint_dir was given")
        raw, self.iter_state = self.ckpt.restore(step, self.device)
        params = _leaves(raw["params"])
        ema = None
        if self.cfg.ema_decay is not None:
            ema = raw.get("ema") or {k: v.detach().clone()
                                     for k, v in params.items()}
        self.state = TrainState(params, raw["opt_state"], int(raw["step"]),
                                ema)
        return self.state
