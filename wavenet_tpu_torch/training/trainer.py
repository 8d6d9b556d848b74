"""Training on one device, or over a mesh of processes: the optimizer, the
train step and `Trainer`.

Counterpart of wavenet_tpu/training/trainer.py over its (data, seq, model)
mesh.  The optimizer follows optax exactly, written as plain tensor code:
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
On bf16 and f16 leaves (cfg.param_dtype) the moments, the accumulated
gradient and the EMA are in the leaves' dtype, as optax keeps them, and
every constant meets a leaf as JAX's weak typing has it meet one: rounded
to the leaf's dtype first (adam_b2 = 0.999 is 1.0 in bf16, so nu adds and
never decays; eps = 1e-8 is 0 in f16), each operation rounded to that
dtype, the bias corrections computed in f32 and rounded, the step size
rounded before its product (_lowp).  At f16 that makes Adam divide by
zero where a gradient's square underflows, as the reference's does; no
loss scale or other guard is added.
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
The seq and model axes take the reference's routes (choose_route,
trainer.py:73-113 there), decided by device where the reference decides
by backend (on the CPU the stack's plain versions stand in for the
kernels, so every route runs there):
  * seq > 1: overlap-discard through the fused stack when it takes the
    config (parallel/seqpar.loss_fn_sp_fused), else the scan with one halo
    exchange a layer (loss_fn_sp); each rank takes its (data, seq) slice
    of the batch (parallel/sharding.batch_slice);
  * model > 1, fused-eligible: the layer pipeline on the stack
    (parallel/pipeline.loss_fn_pp), params in the "layer" layout;
  * model > 1 otherwise (and under seq): the scan split Megatron-style
    (parallel/megatron.py), params in the "megatron" layout.
Each rank holds its slice of the params, of Adam's moments and of the EMA;
gradients sum over the (data, seq) replicas (and, on the pipeline, the
replicated leaves each stage holds a part of over `model`); the clip and
grad_norm see the whole model's norm.  Saves gather the slices over
`model` first, so a checkpoint written on a mesh is the whole model: it
loads and decodes in one process, and a resume cuts it again.
While a torch.profiler runs, each step records its phases as spans
(utils/profiling.span, id the step): "train.sample" and "train.h2d" (the
batch drawn on the host and copied to the device, in `run`),
"train.forward", "train.backward" (the gradients and their sum over the
ranks) and "train.optimizer" (the update, the EMA and the new state); a
mel model's upsampler records "train.upsample" inside the first two, its
forward and its backward with their device time
(conditioning.upsample_mel_train).
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
from wavenet_tpu_torch.parallel import collectives as col
from wavenet_tpu_torch.parallel import dataparallel, distributed
from wavenet_tpu_torch.parallel import megatron, pipeline, seqpar, sharding
from wavenet_tpu_torch.parallel import mesh as mesh_lib
from wavenet_tpu_torch.training.metrics import ThroughputMeter
from wavenet_tpu_torch.utils import profiling
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


def _lowp(x: float, like: torch.Tensor) -> float:
    """The Python float x rounded to like's dtype: a JAX weak-typed
    constant meeting a leaf of that dtype (an f32 leaf's ops round the
    constant to f32 anyway).  torch's ops on a bf16 or f16 tensor compute
    in f32 and round the result once, so with constants rounded first they
    repeat JAX's rounding op by op."""
    return float(torch.tensor(x, dtype=like.dtype))


def _global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares, leaves in sorted key order (JAX's); in
    the leaves' dtype, as optax.global_norm (each leaf's sum accumulated in
    f32 and rounded, the leaves' sums added in that dtype)."""
    total = None
    for k in sorted(tree):
        s = torch.sum(tree[k] * tree[k])
        total = s if total is None else total + s
    return torch.sqrt(total)


class Optimizer:
    """The reference's make_optimizer(cfg) as plain tensor code.  State is
    a dict of tensors and ints (torch.save-able); update() is functional."""

    def __init__(self, cfg: WaveNetConfig, norm=None):
        """norm: tree -> the global norm the clip and the metrics use
        (default _global_norm; a sharded trainer passes one that adds the
        other ranks' slices)."""
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        self.norm = norm or _global_norm

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
            norm = self.norm(g)
            c = cfg.grad_clip_norm
            if not bool(norm < _lowp(c, norm)):
                g = {k: (v / norm.to(v.dtype)) * _lowp(c, v)
                     for k, v in g.items()}
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        count = state["count"]
        count_inc = count + 1
        bc1 = f32(1) - np.power(f32(b1), f32(count_inc))
        bc2 = f32(1) - np.power(f32(b2), f32(count_inc))
        step_size = float(f32(-1) * self.schedule(count))
        mu, nu, out = {}, {}, {}
        for k, p in params.items():
            q = lambda x: _lowp(x, p)
            mu[k] = q(1 - b1) * g[k] + q(b1) * state["mu"][k]
            nu[k] = q(1 - b2) * (g[k] * g[k]) + q(b2) * state["nu"][k]
            u = (mu[k] / q(bc1)) / (torch.sqrt(nu[k] / q(bc2)) + q(1e-8))
            out[k] = p + q(step_size) * u
        return out, dict(state, count=count_inc, mu=mu, nu=nu)

    def update(self, grads, state, params):
        """-> (params, state, applied, grad_norm tensors for the metrics)."""
        k = self.cfg.grad_accum
        if k == 1:
            p, s = self._apply(grads, state, params)
            return p, s, True, {"grad_norm": self.norm(grads)}
        n = state["mini_step"]
        acc = {key: a + (grads[key] - a) / float(n + 1)
               for key, a in state["acc_grads"].items()}
        norms = {"grad_norm": self.norm(acc),
                 "microbatch_grad_norm": self.norm(grads)}
        if n < k - 1:
            return params, dict(state, mini_step=n + 1, acc_grads=acc), \
                False, norms
        p, s = self._apply(acc, state, params)
        s = dict(s, mini_step=0,
                 acc_grads={key: torch.zeros_like(a) for key, a in acc.items()})
        return p, s, True, norms


def make_optimizer(cfg: WaveNetConfig, norm=None) -> Optimizer:
    return Optimizer(cfg, norm)


def ema_update(ema, params, decay: float):
    """Polyak average after an applied update: d * ema + (1 - d) * p, the
    constants rounded to a bf16 or f16 leaf's dtype as the reference's
    weak-typed decay meets them (a decay of 0.999 is 1.0 in bf16: such an
    EMA adds bf16(0.001) p every step)."""
    return {k: _lowp(decay, e) * e + _lowp(1.0 - decay, e) * params[k]
            for k, e in ema.items()}


Dataset = Union[AudioDataset, StreamingAudioDataset]


def _check_parallel(cfg: WaveNetConfig) -> None:
    """Refuse a mesh other than the process group's world size
    (ValueError)."""
    wn.check_trainable(cfg)
    mesh_lib.mesh_shape(cfg, distributed.world_size())


# the routes of a step, and the param layout over `model` each takes
ROUTE_LAYOUT = {"dp": None, "sp": "megatron", "sp_fused": None,
                "pp": "layer", "tp": "megatron"}


def use_pipeline(cfg: WaveNetConfig) -> bool:
    """The fused stack under model sharding is the layer pipeline (the
    reference's use_pipeline, without its backend test)."""
    return (cfg.fused_stack and cfg.model_parallel > 1
            and cfg.seq_parallel == 1
            and cfg.batch_size % max(cfg.data_parallel, 1) == 0
            and pipeline.supported(cfg, cfg.train_window,
                                   cfg.model_parallel))


def choose_route(cfg: WaveNetConfig) -> str:
    """The step's route over the mesh, as the reference picks it
    (trainer.py:73-113 there): "sp_fused" (overlap-discard on the stack),
    "sp" (the halo-exchange scan, Megatron-split under a model axis),
    "pp" (the stack as a layer pipeline), "tp" (the Megatron-split scan)
    or "dp" (one device's step on the rank's rows).  On a CUDA device the
    fused routes run the stack kernels at every width supported() takes."""
    sp, mp = cfg.seq_parallel, cfg.model_parallel
    route = "dp"
    if sp > 1:
        fused = (cfg.fused_stack and mp == 1 and seqpar.sp_fused_supported(
            cfg, cfg.train_window, sp))
        route = "sp_fused" if fused else "sp"
    elif mp > 1:
        route = "pp" if use_pipeline(cfg) else "tp"
    layout = ROUTE_LAYOUT[route]
    if layout is not None and mp > 1:
        sharding.validate(cfg, mp, layout)
    return route


def use_fused_stack(cfg: WaveNetConfig, T: int) -> bool:
    """The step's route, as the reference decides it: the fused stack when
    cfg.fused_stack and train_stack.supported(cfg, T), else the scan.  On
    a CUDA device the fused stack is the kernels, at every width
    supported() takes (train_stack.kernel_supported)."""
    return bool(cfg.fused_stack and train_stack.supported(cfg, T))


def _leaves(params) -> Dict[str, torch.Tensor]:
    """Nested or flat params -> flat trainable leaves ('/'-joined names)."""
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in flatten_tree(params).items()}


class Trainer:
    """Training on one device, or on this rank's device of a mesh of
    processes: deterministic data, the train step, eval, and exact-resume
    checkpoints.  dataset: an AudioDataset or a StreamingAudioDataset.
    params: optional initial params (e.g. carried over from the JAX
    package); default: init_params seeded by cfg.seed.  Under a process
    group every rank starts from rank 0's (its slice of them)."""

    def __init__(self, cfg: WaveNetConfig, dataset: Dataset,
                 checkpoint_dir: Optional[str] = None, device="cuda",
                 params: Optional[Dict[str, torch.Tensor]] = None):
        _check_parallel(cfg)
        self.cfg = cfg
        self.dataset = dataset
        self.device = torch.device(device)
        self.route = choose_route(cfg)
        self.layout = ROUTE_LAYOUT[self.route] \
            if cfg.model_parallel > 1 else None
        self.use_fused = (self.route == "dp" and use_fused_stack(
            cfg, cfg.train_window))
        # the data axis' group and this rank's rows (None: one process);
        # off the data-only route, this rank's MeshGroups
        self.mesh = self.group = self.rows = self.groups = None
        if dist.is_initialized():
            if self.device.type == "cuda":
                # the mesh would otherwise bind cuda:LOCAL_RANK (two ranks
                # may share one card, each naming cuda:0)
                torch.cuda.set_device(self.device)
            self.mesh = mesh_lib.make_mesh(cfg, self.device.type)
            self.group = self.mesh.get_group(mesh_lib.DATA_AXIS)
            if self.route != "dp":
                self.groups = mesh_lib.new_mesh_groups(self.mesh)
                b = cfg.batch_size // self.groups.dp
                i = self.groups.data_index
                self.rows = slice(i * b, (i + 1) * b)
            elif distributed.world_size() > 1:
                self.rows = distributed.local_batch_slice(cfg.batch_size)
        if params is None:
            params = wn.init_params(
                cfg, torch.Generator().manual_seed(cfg.seed), self.device)
        params = dataparallel.broadcast_params(
            {k: torch.as_tensor(v).to(self.device)
             for k, v in flatten_tree(params).items()},
            self.group if self.groups is None else None)
        params = _leaves(self._shard(params))
        self.tx = make_optimizer(cfg, None if self.layout is None
                                 else self._sharded_norm)
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
    # the model axis: slices of the whole params and back
    def _model_axis(self) -> col.Axis:
        return col.axis_of(self.groups, "model")

    def _shard(self, tree: Dict[str, torch.Tensor]):
        """This rank's slice of whole flat leaves (the route's layout)."""
        if self.layout is None:
            return tree
        ax = self._model_axis()
        return sharding.shard_params(tree, self.cfg, ax.size, ax.index,
                                     self.layout)

    def _gather(self, tree: Dict[str, torch.Tensor]):
        """The whole flat leaves of this rank's slices (every rank calls
        it: an all-gather over `model` per split leaf)."""
        if self.layout is None:
            return tree
        ax = self._model_axis()
        return sharding.gather_params(tree, self.cfg, ax.size, ax.group,
                                      self.layout)

    def _sharded_norm(self, tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The whole model's global norm from this rank's slices: the
        replicated leaves' squares here, the split leaves' summed over
        `model`."""
        def ss(keys):
            total = torch.zeros((), device=self.device,
                                dtype=tree[keys[0]].dtype if keys
                                else torch.float32)
            for k in keys:
                total = total + torch.sum(tree[k] * tree[k])
            return total
        keys = sorted(tree)
        split = [k for k in keys
                 if sharding.split_dim(k, self.layout) is not None]
        part = col.all_reduce(ss(split), self._model_axis().group)
        return torch.sqrt(ss([k for k in keys if k not in split]) + part)

    def full_params(self) -> Dict[str, torch.Tensor]:
        """The whole current params (flat leaves); on a model-split mesh
        every rank must call it."""
        return self._gather({k: v.detach()
                             for k, v in self.state.params.items()})

    # ------------------------------------------------------------------
    def _loss(self, params, tokens, mel, speaker):
        """(this rank's loss share, global metrics) through the route."""
        cfg, route = self.cfg, self.route
        if route == "dp":
            return dataparallel.loss_fn_dp(
                params, cfg, tokens, mel=mel, use_fused=self.use_fused,
                speaker=speaker, group=self.group)
        if route == "pp":
            return pipeline.loss_fn_pp(params, cfg, self.groups, tokens,
                                       mel=mel, speaker=speaker,
                                       microbatch=cfg.pipeline_microbatch)
        if route == "tp":
            return megatron.loss_fn_tp(params, cfg, self.groups, tokens,
                                       mel=mel, speaker=speaker)
        g = self.groups
        part = sharding.batch_slice({"tokens": tokens}, 1, g.sp, 0,
                                    g.seq_index, seq_sharded=True)
        fn = seqpar.loss_fn_sp_fused if route == "sp_fused" \
            else seqpar.loss_fn_sp
        return fn(params, cfg, g, part["inputs"], part["targets"], mel=mel,
                  speaker=speaker)

    def _reduce(self, grads: Dict[str, torch.Tensor]):
        """Sum the gradients over the ranks that share each leaf."""
        if self.groups is None:
            return dataparallel.reduce_gradients(grads, self.group)
        if self.route == "pp":
            part = {k: v for k, v in grads.items()
                    if pipeline.model_partial(k)}
            grads = dict(grads, **dataparallel.reduce_gradients(
                part, self.groups.model))
        return dataparallel.reduce_gradients(grads, self.groups.replica)

    def step(self, tokens: torch.Tensor,
             mel: Optional[torch.Tensor] = None,
             speaker: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """One optimizer step (or accumulation microstep) on [B, W+1]
        tokens (and a mel model's [B, F, M] frames, a speaker model's [B]
        ids), this rank's rows on a mesh (its time slice is cut here on
        the seq routes); returns the (global) metrics as 0-d tensors (not
        fetched)."""
        cfg, st = self.cfg, self.state
        with profiling.span("train.forward", id=st.step):
            loss, aux = self._loss(unflatten_tree(st.params), tokens, mel,
                                   speaker)
        with profiling.span("train.backward", id=st.step):
            keys = sorted(st.params)
            grads = dict(zip(keys, torch.autograd.grad(
                loss, [st.params[k] for k in keys])))
            grads = self._reduce(grads)
        with profiling.span("train.optimizer", id=st.step), \
                torch.no_grad():
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
            step = self.state.step
            with profiling.span("train.sample", id=step):
                batch, self.iter_state = self._sample(self.dataset,
                                                      self.iter_state)
            with profiling.span("train.h2d", id=step):
                inputs = self._batch(batch)
            metrics = self.step(*inputs)
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
                _, aux = self._loss(unflatten_tree(self.state.params),
                                    tokens, mel, speaker)
                for k, v in aux.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
        return {f"eval_{k}": v / num_batches for k, v in sums.items()}

    # ------------------------------------------------------------------
    def save(self, wait: bool = True) -> None:
        """Checkpoint the current state: durable on return by default (on
        every rank); wait=False returns once the state's host copy is
        taken (the file lands in the background).  Under a process group
        every rank calls it: the replicas are checked equal, and rank 0
        writes.  On a model-split mesh the slices are gathered first: the
        file holds the whole params, moments and EMA."""
        if self.ckpt is None:
            raise ValueError("no checkpoint_dir was given")
        st = self.state
        opt = self._map_opt(st.opt_state, self._gather)
        params = self._gather(st.params)
        ema = None if st.ema is None else self._gather(st.ema)
        dataparallel.check_replicas(
            params, self.group if self.groups is None else None)
        if self.ckpt.writer:
            self.ckpt.save(st.step, {"params": params, "opt_state": opt,
                                     "ema": ema},
                           self.iter_state, wait=wait)
        if wait:
            self._barrier()

    def _barrier(self) -> None:
        """Under a process group: wait until every rank gets here (every
        rank of the mesh, not only of the data axis)."""
        if self.group is not None:
            dist.barrier(group=self.group if self.groups is None else None)

    def restore(self, step: Optional[int] = None) -> TrainState:
        """Load a checkpoint (the latest by default) into the trainer.  An
        EMA missing from the file starts from a copy of the params; one
        present but off in the config is dropped."""
        if self.ckpt is None:
            raise ValueError("no checkpoint_dir was given")
        raw, self.iter_state = self.ckpt.restore(step, self.device)
        params = _leaves(self._shard(raw["params"]))
        ema = None
        if self.cfg.ema_decay is not None:
            ema = raw.get("ema")
            ema = ({k: v.detach().clone() for k, v in params.items()}
                   if not ema else self._shard(ema))
        self.state = TrainState(params,
                                self._map_opt(raw["opt_state"], self._shard),
                                int(raw["step"]), ema)
        return self.state

    @staticmethod
    def _map_opt(opt_state: dict, fn) -> dict:
        """opt_state with fn applied to each of its param-shaped trees."""
        return {k: fn(v) if isinstance(v, dict) else v
                for k, v in opt_state.items()}
