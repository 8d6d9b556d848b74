"""The reference's first training steps, and the numbers that compare them.

Adam (Kingma & Ba) as optax computes it: moments updated with the count
incremented first, bias corrections 1 - b^count, eps = 1e-8 outside the
square root, a constant learning rate; no clip, no accumulation, no EMA
(the configurations state none, and `steps` refuses one that does).

The numbers, each a gap between the program's reading and the reference's
(never the norm of their difference), as a share of the reference's:
  loss_gap    the worst of the steps' losses;
  grad_gap    the worst leaf's norm of the first gradient, over the larger
              of that leaf's reference norm and the median leaf's;
  change_gap  the worst leaf's norm of the parameters' change after the
              steps, likewise, over the leaves that the reference's first
              gradient moves (a leaf under a thousandth of the median
              leaf's gradient norm is nought to rounding and left out);
  grad_err    the worst leaf's norm of the first gradient's difference
              from the reference's, over the same denominator: the one
              number that sees each element's rounding, which a mean loss
              and a norm average away.
A cell compares the numbers its workload file gives limits for.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

from portbench.reference import model


def check_config(m: dict) -> None:
    if (m.get("lr_schedule") != "constant" or m.get("warmup_steps")
            or m.get("grad_clip_norm") is not None
            or m.get("grad_accum", 1) != 1 or m.get("ema_decay") is not None):
        raise NotImplementedError(
            "the reference trains a constant learning rate with no clip, "
            "no accumulation and no EMA")


class Readings(dict):
    """{"losses": [...], "grad_norms": {leaf: float},
    "change_norms": {leaf: float}, "first_grads": {leaf: tensor}}."""


def leaf_norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def steps(w0: Dict[str, torch.Tensor], dilations, batches: List[torch.Tensor],
          lr: float, b1: float, b2: float, rows: Optional[int] = None,
          precision: str = "float32",
          mels: Optional[List[torch.Tensor]] = None,
          speakers: Optional[List[torch.Tensor]] = None) -> Readings:
    """Train len(batches) Adam steps from w0 (not modified) in
    `precision` (model.logits) and read the losses, the first gradient's
    leaf norms and the change's leaf norms.  mels, speakers: each batch's
    [B, F, M] frames and [B] ids, for a mel or a speaker model."""
    dt = torch.float64 if precision == "float64" else torch.float32
    p = {k: v.detach().to(dt).clone() for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for count, window in enumerate(batches, start=1):
        loss, g = model.loss_and_grads(
            p, dilations, window, rows, precision,
            mel=None if mels is None else mels[count - 1],
            speaker=None if speakers is None else speakers[count - 1])
        losses.append(loss)
        if first is None:
            first = {k: v.detach().clone() for k, v in g.items()}
        bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        with torch.no_grad():
            for k in p:
                mu[k] = (1 - b1) * g[k] + b1 * mu[k]
                nu[k] = (1 - b2) * g[k] * g[k] + b2 * nu[k]
                p[k] = p[k] - lr * (mu[k] / bc1) / (
                    torch.sqrt(nu[k] / bc2) + 1e-8)
    change = {k: leaf_norm(p[k] - w0[k].to(dt)) for k in p}
    return Readings(losses=losses, change_norms=change, first_grads=first,
                    grad_norms={k: leaf_norm(v) for k, v in first.items()})


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def leaf_errs(prog: Readings, ref: Readings) -> Dict[str, float]:
    """Each leaf's norm of the first gradient's difference over the larger
    of the reference leaf's norm and the median leaf's: grad_err is the
    largest."""
    keys = sorted(ref["grad_norms"])
    med = statistics.median(ref["grad_norms"][k] for k in keys)
    return {k: leaf_norm(prog["first_grads"][k].double()
                         - ref["first_grads"][k].double())
            / max(ref["grad_norms"][k], med) for k in keys}


def leaf_gaps(prog: Readings, ref: Readings) -> Dict[str, Dict[str, float]]:
    """Each leaf's share in grad_gap, change_gap and grad_err (for the look
    at which leaf sets them)."""
    out = {}
    for kind in ("grad_norms", "change_norms"):
        p, r = prog[kind], ref[kind]
        med = statistics.median(r.values())
        out[kind] = {k: abs(p[k] - r[k]) / max(r[k], med) for k in sorted(r)}
    out["grad_err"] = leaf_errs(prog, ref)
    return out


def gaps(prog: Readings, ref: Readings) -> Dict[str, float]:
    """The three numbers of the module doc."""
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(prog["losses"], ref["losses"]))
    keys = sorted(ref["grad_norms"])
    med = statistics.median(ref["grad_norms"][k] for k in keys)
    moved = [k for k in keys if ref["grad_norms"][k] >= 1e-3 * med]
    return {"loss_gap": loss,
            "grad_gap": _leaf_gap(prog["grad_norms"], ref["grad_norms"],
                                  keys),
            "change_gap": _leaf_gap(prog["change_norms"],
                                    ref["change_norms"], moved),
            "grad_err": max(leaf_errs(prog, ref).values())}
