"""Training on one device, or data-parallel over processes: the optimizer,
the train step and `Trainer`.

Counterpart of wavenet_tpu/training/trainer.py on the data axis of its
mesh (the seq and model axes are not ported).  The
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
with the rest.  A speaker model's batches carry "speaker" ids; g_embed and
v_global train with the rest (the ids' lookup has a one-hot backward, so
two rows of one speaker add in a fixed order).
Data parallelism (data_parallel = the process group's world size, one
process per rank, parallel/distributed.initialize): every rank draws the
global batch from (seed, step) and feeds only its rows
(distributed.local_batch_slice; a StreamingAudioDataset assembles only
those rows), computes its loss share through the same stack
(parallel/dataparallel.loss_fn_dp), and the gradients are summed across
ranks before the optimizer, on every accumulation microstep, so the clip
sees the global norm as in the reference; the metrics are global.  Every
rank starts from rank 0's params (one broadcast) and applies the same
update, and each save first checks that the replicas are still equal.
Only rank 0 writes checkpoints; every rank restores the same file.
The state holds params, optimizer moments and EMA as flat
leaves under '/'-joined names ("upsampler/w0"), the model's nested params
rebuilt for each loss call; JAX's optax walks the same leaves in the same
sorted order.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from wavenet_tpu_torch.audio.dataset import AudioDataset, IteratorState
from wavenet_tpu_torch.audio.streaming import StreamingAudioDataset
from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops.cuda import train_stack
from wavenet_tpu_torch.parallel import dataparallel, distributed
from wavenet_tpu_torch.parallel import mesh as mesh_lib
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


Dataset = Union[AudioDataset, StreamingAudioDataset]


def _check_parallel(cfg: WaveNetConfig) -> None:
    """Refuse what the trainer does not take: the seq and model axes
    (NotImplementedError; the model axis decodes and serves, but its
    training half is not ported) and a data axis other than the process
    group's world size (ValueError)."""
    wn.check_trainable(cfg)
    if cfg.model_parallel > 1:
        raise NotImplementedError(
            "training over the model axis (model_parallel > 1: the "
            "sharded scan and the pipelined stack) is not ported yet "
            "(ROADMAP queue 1 item 11); decode and serving take it")
    mesh_lib.mesh_shape(cfg, distributed.world_size())


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
    """Training on one device, or on this rank's device of a data-parallel
    process group: deterministic data, the train step, eval, and
    exact-resume checkpoints.  dataset: an AudioDataset or a
    StreamingAudioDataset.  params: optional initial params (e.g. carried
    over from the JAX package); default: init_params seeded by cfg.seed.
    Under a process group every rank starts from rank 0's."""

    def __init__(self, cfg: WaveNetConfig, dataset: Dataset,
                 checkpoint_dir: Optional[str] = None, device="cuda",
                 params: Optional[Dict[str, torch.Tensor]] = None):
        _check_parallel(cfg)
        self.cfg = cfg
        self.dataset = dataset
        self.device = torch.device(device)
        self.use_fused = use_fused_stack(cfg, cfg.train_window, self.device)
        # the data axis' group and this rank's rows (None: one process)
        self.mesh = self.group = self.rows = None
        if dist.is_initialized():
            if self.device.type == "cuda":
                # the mesh would otherwise bind cuda:LOCAL_RANK (two ranks
                # may share one card, each naming cuda:0)
                torch.cuda.set_device(self.device)
            self.mesh = mesh_lib.make_mesh(cfg, self.device.type)
            self.group = self.mesh.get_group(mesh_lib.DATA_AXIS)
            if distributed.world_size() > 1:
                self.rows = distributed.local_batch_slice(cfg.batch_size)
        if params is None:
            params = wn.init_params(
                cfg, torch.Generator().manual_seed(cfg.seed), self.device)
        params = _leaves(dataparallel.broadcast_params(
            {k: torch.as_tensor(v).to(self.device)
             for k, v in flatten_tree(params).items()}, self.group))
        self.tx = make_optimizer(cfg)
        ema = ({k: v.detach().clone() for k, v in params.items()}
               if cfg.ema_decay is not None else None)
        self.state = TrainState(params, self.tx.init(params), 0, ema)
        self.iter_state = IteratorState(seed=cfg.seed, step=0)
        self.ckpt = None
        if checkpoint_dir is not None:
            from wavenet_tpu_torch.training.checkpoint import \
                CheckpointManager
            self.ckpt = CheckpointManager(checkpoint_dir, cfg,
                                          writer=distributed.is_primary())

    # ------------------------------------------------------------------
    def step(self, tokens: torch.Tensor,
             mel: Optional[torch.Tensor] = None,
             speaker: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """One optimizer step (or accumulation microstep) on [B, W+1]
        tokens (and a mel model's [B, F, M] frames, a speaker model's [B]
        ids), this rank's rows under data parallelism; returns the
        (global) metrics as 0-d tensors (not fetched)."""
        cfg, st = self.cfg, self.state
        loss, aux = dataparallel.loss_fn_dp(
            unflatten_tree(st.params), cfg, tokens, mel=mel,
            use_fused=self.use_fused, speaker=speaker, group=self.group)
        keys = sorted(st.params)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [st.params[k] for k in keys])))
        grads = dataparallel.reduce_gradients(grads, self.group)
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

    def _sample(self, ds: Dataset, state: IteratorState):
        """(this rank's rows of the batch of `state`, the next state)."""
        if self.rows is None:
            return ds.sample_batch(state)
        if isinstance(ds, StreamingAudioDataset):
            return ds.sample_batch(state, rows=self.rows)
        batch, nxt = ds.sample_batch(state)
        return {k: v[self.rows] for k, v in batch.items()}, nxt

    def _batch(self, batch):
        """A host batch -> (tokens, mel or None, speaker or None) on the
        trainer's device."""
        def dev(key):
            v = batch.get(key)
            return None if v is None else torch.from_numpy(v).to(self.device)
        return dev("tokens"), dev("mel"), dev("speaker")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, num_steps: int, log_every: int = 50,
            checkpoint_every: Optional[int] = None, log_fn=print,
            metrics_fn=None, wait_saves: bool = False) -> Dict[str, float]:
        """Train for num_steps; returns the last metrics plus throughput
        (steps_per_sec, audio_seconds_per_sec, samples_per_sec, first step
        excluded, the wait for the last saves included).
        metrics_fn(global_step, dict) is called at every log point; metrics
        are fetched from the device only there and at the end.  The
        checkpoint_every saves are asynchronous (wait_saves=True makes each
        block, the cost utils/profiling.host_costs compares them with);
        none is in flight when run() returns, on any rank."""
        if num_steps <= 0:
            return {}
        cfg = self.cfg
        samples_per_batch = cfg.batch_size * cfg.train_window
        meter = ThroughputMeter(samples_per_batch / cfg.sample_rate,
                                samples_per_batch)
        for i in range(num_steps):
            batch, self.iter_state = self._sample(self.dataset,
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
                self.save(wait=wait_saves)
        self._sync()
        if self.ckpt is not None:
            self.ckpt.wait()
            self._barrier()
        last = {k: float(v) for k, v in metrics.items()}
        last.update(meter.rates())
        if log_every:
            log_fn(f"step {num_steps} loss {last['loss']:.4f} "
                   f"acc {last['accuracy']:.3f}")
        return last

    # ------------------------------------------------------------------
    def evaluate(self, dataset: Optional[Dataset] = None,
                 num_batches: int = 8, seed: int = 987) -> Dict[str, float]:
        """Mean loss/accuracy over deterministic held-out batches (the
        same stack routing and rows as training, without gradients)."""
        ds = dataset or self.dataset
        it = IteratorState(seed=seed, step=0)
        sums: Dict[str, float] = {}
        with torch.no_grad():
            for _ in range(num_batches):
                batch, it = self._sample(ds, it)
                tokens, mel, speaker = self._batch(batch)
                _, aux = dataparallel.loss_fn_dp(
                    unflatten_tree(self.state.params), self.cfg, tokens,
                    mel=mel, use_fused=self.use_fused, speaker=speaker,
                    group=self.group)
                for k, v in aux.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
        return {f"eval_{k}": v / num_batches for k, v in sums.items()}

    # ------------------------------------------------------------------
    def save(self, wait: bool = True) -> None:
        """Checkpoint the current state: durable on return by default (on
        every rank); wait=False returns once the state's host copy is
        taken (the file lands in the background).  Under a process group
        every rank calls it: the replicas are checked equal, and rank 0
        writes."""
        if self.ckpt is None:
            raise ValueError("no checkpoint_dir was given")
        st = self.state
        dataparallel.check_replicas(st.params, self.group)
        if self.ckpt.writer:
            self.ckpt.save(st.step, {"params": st.params,
                                     "opt_state": st.opt_state,
                                     "ema": st.ema},
                           self.iter_state, wait=wait)
        if wait:
            self._barrier()

    def _barrier(self) -> None:
        """Under a process group: wait until every rank gets here."""
        if self.group is not None:
            dist.barrier(group=self.group)

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
