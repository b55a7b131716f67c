"""QAT training of the paper's keyword classifier, on the card by default.

Counterpart of `examples/train_kws.py` and of `benchmarks/common.py`'s
`train_classifier` / `evaluate`: the 16 -> GRU(48) -> GRU(48) -> FC(12)
classifier with 8-bit weights and Q6.8 activations through the
straight-through fake-quant (`core.quant`, `core.gru`), AdamW and
ReduceLROnPlateau (the paper's recipe, Section III-F;
`training.optimizer`), trained on the synthetic GSCD corpus
(`data.gscd`) whose features the software frontend records (K1 on the
card), with periodic checkpoints, resume and straggler monitoring
(`distributed.fault_tolerance`).

    python -m repro_torch.training.kws [--steps 300] [--batch 64]
        [--n-per-class 24] [--ckpt-dir kws_ckpt] [--resume] [--device cpu]
        [--dp N [--compress-grads] [--devices cuda:0 cuda:0 ...]]

The forward and backward are PyTorch operations on the card, as the
reference's are ``jnp`` operations under ``jax.grad``; the trained model
is then replayed on integer codes (``classifier="integer"``, K2 on the
card), which must reproduce the QAT decisions exactly.

A checkpoint holds ``(params, opt)`` in the reference's tree and format,
so either package resumes from the other's. Each step draws its batch
from ``(seed, step)``, and the scheduler's state is kept beside the
checkpoint (``schedule.json``), so a resumed run takes the steps an
unbroken one takes.

Data-parallel training (``dp=N``, the reference example's ``--dp N
--compress-grads``): each of N shards holds a parameter replica and its
AdamW state on its device (`stream_devices`: entries may name the same
card), takes its ``batch / N`` rows of the step's batch in order and
computes its loss and gradients there; the losses are averaged, the
gradients synced (`distributed.collectives`: the plain mean, or the
int8 all-reduce with error feedback), and the same update is applied to
every replica. The error-feedback residual starts at zero and is not
checkpointed, as in the reference, so a resumed compressed run restarts
its residual.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.classifier import get_classifier, resolve_classifier_key
from repro_torch.core.fex import fit_norm_stats
from repro_torch.core.gru import GRUConfig, gru_classifier_forward, init_gru_classifier
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro_torch.data.gscd import CLASSES, make_dataset
from repro_torch.distributed.collectives import (
    compressed_psum_with_error_feedback,
    init_residual,
    pmean,
)
from repro_torch.distributed.fault_tolerance import (
    CheckpointManager,
    CheckpointPolicy,
    StragglerMonitor,
)
from repro_torch.distributed.sharding import stream_devices
from repro_torch.kernels.build import resolve_device
from repro_torch.training import train_loop
from repro_torch.training.optimizer import (
    AdamWConfig,
    ReduceLROnPlateau,
    _leaves,
    adamw_update,
    init_opt_state,
    tree_map,
)

__all__ = [
    "loss_fn",
    "value_and_grad",
    "train_step",
    "dp_devices",
    "dp_value_and_grad",
    "dp_train_step",
    "train_classifier",
    "evaluate",
    "corpus_features",
    "fit",
    "resume",
    "train",
    "main",
]

Tree = Any
# the paper's recipe: AdamW 1e-3, wd 0.01; ReduceLROnPlateau 0.8 / 3 / 5e-4
OPT = AdamWConfig(lr=1e-3, weight_decay=0.01)
SCHEDULE = (1e-3, 0.8, 3, 5e-4)
WINDOW = 20  # steps a scheduler step averages (and a log line reports)
SCHEDULE_FILE = "schedule.json"


def _full_float32(device: torch.device) -> None:
    # the QAT products and sums are exact only without TF32, backward too
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def loss_fn(params: Tree, fv: torch.Tensor, labels: torch.Tensor,
            config: GRUConfig = GRUConfig()) -> torch.Tensor:
    """Mean cross-entropy of the final frame's logits:
    ``logsumexp(logits) - logits[label]`` over the batch."""
    logits = gru_classifier_forward(params, fv, config)[:, -1, :]
    gold = torch.gather(logits, -1, labels[:, None].to(torch.int64))[:, 0]
    return torch.mean(torch.logsumexp(logits, -1) - gold)


def value_and_grad(params: Tree, fv: torch.Tensor, labels: torch.Tensor,
                   config: GRUConfig = GRUConfig()) -> Tuple[torch.Tensor, Tree]:
    """(loss, gradients shaped like ``params``) by autograd."""
    return train_loop.value_and_grad(loss_fn, params, fv, labels, config)


def train_step(params: Tree, opt: Tree, fv: torch.Tensor, labels: torch.Tensor,
               lr, config: GRUConfig = GRUConfig(), ocfg: AdamWConfig = OPT):
    """One step: forward, backward, `adamw_update` -> (params, opt, loss)."""
    loss, grads = value_and_grad(params, fv, labels, config)
    params, opt, _ = adamw_update(params, grads, opt, ocfg, lr)
    return params, opt, loss


def dp_devices(dp: int, devices=None, device=None) -> List[torch.device]:
    """The shard devices of a ``dp``-way data-parallel run: ``devices``
    (an int: the first that many cards, raising above the visible count;
    or a list, whose entries may repeat) through `stream_devices`, or
    without it ``dp`` shards on the first ``dp`` cards, or all on the CPU
    where ``device`` is the CPU."""
    if devices is None:
        device = resolve_device(device)
        devices = [device] * dp if device.type == "cpu" else dp
    devs = stream_devices(devices)
    if len(devs) != dp:
        raise ValueError(f"dp={dp} but {len(devs)} shard device(s): {[str(d) for d in devs]}")
    return devs


def dp_value_and_grad(replicas: Sequence[Tree], fv: torch.Tensor, labels: torch.Tensor,
                      config: GRUConfig = GRUConfig(),
                      residual: Optional[Sequence[Tree]] = None):
    """One data-parallel forward and backward over ``len(replicas)``
    shards: shard i takes rows ``[i * B / N, (i + 1) * B / N)`` of the
    batch to its replica's device and computes `value_and_grad` there;
    then the losses' mean and the gradients' sync: with ``residual`` (one
    tree a shard) `compressed_psum_with_error_feedback`, else `pmean`.
    Returns (loss, the synced gradients one tree a shard, the new
    residuals or None)."""
    n = len(replicas)
    if fv.shape[0] % n:
        raise ValueError(f"a batch of {fv.shape[0]} rows does not split over {n} shards")
    per = fv.shape[0] // n
    losses, grads = [], []
    for i, params in enumerate(replicas):
        dev = _leaves(params)[0].device
        rows = slice(i * per, (i + 1) * per)
        loss, g = value_and_grad(params, fv[rows].to(dev), labels[rows].to(dev), config)
        losses.append(loss)
        grads.append(g)
    loss = pmean(losses)[0]
    if residual is not None:
        grads, residual = compressed_psum_with_error_feedback(grads, residual)
    else:
        grads = pmean(grads)
    return loss, grads, residual


def dp_train_step(replicas: Sequence[Tree], opts: Sequence[Tree], fv: torch.Tensor,
                  labels: torch.Tensor, lr, residual: Optional[Sequence[Tree]] = None,
                  config: GRUConfig = GRUConfig(), ocfg: AdamWConfig = OPT):
    """`dp_value_and_grad` (compressed with ``residual``), then
    `adamw_update` with the synced gradients on every replica alike ->
    (replicas, opts, loss, residual)."""
    loss, grads, residual = dp_value_and_grad(replicas, fv, labels, config, residual)
    out = [adamw_update(p, g, o, ocfg, lr) for p, g, o in zip(replicas, grads, opts)]
    return [o[0] for o in out], [o[1] for o in out], loss, residual


def train_classifier(
    feats: np.ndarray,
    labels: np.ndarray,
    seed: int = 0,
    epochs: int = 60,
    batch: int = 64,
    device=None,
    verbose: bool = False,
) -> Dict:
    """QAT training of the 2 x 48 GRU-FC over whole epochs of FV_Norm
    features (N, T, C), on ``device`` (the card by default). Returns
    {"params", "config", "history": mean loss an epoch}."""
    device = resolve_device(device)
    _full_float32(device)
    gcfg = GRUConfig()
    params = init_gru_classifier(gcfg, torch.Generator().manual_seed(seed), device)
    opt = init_opt_state(params, OPT)
    sched = ReduceLROnPlateau(*SCHEDULE)
    fv = torch.as_tensor(np.asarray(feats, np.float32), device=device)
    y = torch.as_tensor(np.asarray(labels), device=device)
    n = len(labels)
    rng = np.random.default_rng(seed)
    lr = SCHEDULE[0]
    history = []
    for epoch in range(epochs):
        order = rng.permutation(n)
        losses = []
        for i in range(0, n - n % batch, batch):
            sl = torch.as_tensor(order[i:i + batch], device=device)
            params, opt, loss = train_step(params, opt, fv[sl], y[sl], lr, gcfg)
            losses.append(float(loss))
        mean_loss = float(np.mean(losses))
        lr = sched.step(mean_loss)
        history.append(mean_loss)
        if verbose and epoch % 10 == 0:
            print(f"    epoch {epoch:3d} loss {mean_loss:.4f} lr {lr:.2e}")
    return {"params": params, "config": gcfg, "history": history}


def evaluate(model: Dict, feats, labels: np.ndarray, batch: int = 128,
             classifier: Optional[str] = None):
    """Accuracy and confusion matrix (true class x predicted, int32) of
    the final frame's argmax, on the params' device, through a registered
    backend: ``None`` resolves from the config (QAT), ``"integer"`` replays
    the model on int8 / Q6.8 codes (K2 on the card)."""
    gcfg = model["config"]
    backend = get_classifier(resolve_classifier_key(classifier, gcfg))
    params = backend.prepare(model["params"], gcfg)
    device = model["params"]["fc"]["w"].device
    fv = torch.as_tensor(feats, dtype=torch.float32, device=device)
    preds = []
    with torch.no_grad():
        for i in range(0, len(labels), batch):
            logits = backend.forward(params, fv[i:i + batch], gcfg)[:, -1, :]
            preds.append(torch.argmax(logits, -1).cpu().numpy())
    preds = np.concatenate(preds)
    labels = np.asarray(labels)
    conf = np.zeros((gcfg.num_classes, gcfg.num_classes), np.int32)
    np.add.at(conf, (labels, preds), 1)
    return float((preds == labels).mean()), conf


def corpus_features(train_audio: np.ndarray, test_audio: np.ndarray, device):
    """FV_Norm of the two corpora on ``device``, as the reference's example
    makes them eagerly (`examples/train_kws.py:55-75`): FV_Raw recorded by
    the software frontend (K1 on the card), FV_Log by the eager closed
    form (`quant.log_compress_eager`: 512 at code 63, where the chip's ROM
    gives 511), the normalizer fitted on the training set's FV_Log
    (`fit_norm_stats`), then ``(x - mu) / sigma`` on the Q6.8 grid."""
    pipe = KWSPipeline(KWSPipelineConfig())
    fexc = pipe.config.fex
    logs = [quant.log_compress_eager(
        torch.as_tensor(pipe.record_features(audio, device=device), device=device),
        fexc.quant_bits, fexc.log_bits) for audio in (train_audio, test_audio)]
    stats = fit_norm_stats(logs[0])
    return tuple(quant.fake_quant((x - stats.mu) / stats.sigma, quant.ACT_Q6_8) for x in logs)


def _batch(seed: int, step: int, n: int, batch: int) -> np.ndarray:
    """The rows of step ``step``: a draw of its own, so a resumed run
    takes the batches an unbroken one takes."""
    return np.random.default_rng([seed, step]).choice(n, batch, replace=False)


def _save_schedule(directory: str, step: int, sched: ReduceLROnPlateau) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, SCHEDULE_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"step": step, "lr": sched.lr, "best": sched.best,
                   "bad_epochs": sched.bad_epochs}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, SCHEDULE_FILE))


def resume(ckpt: CheckpointManager, params: Tree, opt: Tree,
           sched: ReduceLROnPlateau, log: Callable = print):
    """The newest checkpoint of ``(params, opt)``, written by either
    package, on the devices of ``params`` / ``opt`` -> (params, opt,
    step). ``sched`` takes the state saved with that step; a checkpoint
    without one (the reference's) starts the schedule afresh."""
    (params, opt), step = ckpt.restore_latest((params, opt))
    path = os.path.join(ckpt.policy.directory, SCHEDULE_FILE)
    saved = None
    if os.path.exists(path):
        with open(path) as f:
            saved = json.load(f)
    if saved is not None and saved["step"] == step:
        sched.lr, sched.best, sched.bad_epochs = saved["lr"], saved["best"], saved["bad_epochs"]
    else:
        log(f"no schedule saved at step {step}; the schedule starts afresh")
    return params, opt, step


def fit(
    params: Tree,
    opt: Tree,
    feats: torch.Tensor,
    labels: torch.Tensor,
    steps: int,
    batch: int = 64,
    start_step: int = 0,
    sched: Optional[ReduceLROnPlateau] = None,
    ckpt: Optional[CheckpointManager] = None,
    monitor: Optional[StragglerMonitor] = None,
    seed: int = 0,
    log: Callable = print,
    dp: int = 0,
    compress_grads: bool = False,
    devices=None,
) -> Dict:
    """Steps ``start_step`` .. ``steps``: a batch a step, a scheduler
    step and a log line every `WINDOW` steps, a checkpoint (and the
    scheduler's state) where ``ckpt``'s policy says. Each step is a
    `dp_train_step` over the shards of `dp_devices` with ``dp`` > 0
    (``compress_grads``: the int8 all-reduce, its residual from zero),
    else over one shard on the features' device, where the sync is exact
    and the step is `train_step`'s. The checkpoint and the result hold
    shard 0's replica. Returns {"params", "opt", "sched", "losses",
    "step_s", "seconds", "stragglers", "residual" (None without
    compression)}."""
    sched = sched if sched is not None else ReduceLROnPlateau(*SCHEDULE)
    monitor = monitor if monitor is not None else StragglerMonitor()
    gcfg = GRUConfig()
    if not dp and (compress_grads or devices is not None):
        raise ValueError("compress_grads and devices need dp > 0")
    devs = dp_devices(dp, devices, feats.device) if dp else [feats.device]
    params = [tree_map(lambda t, d=d: t.to(d), params) for d in devs]
    opt = [tree_map(lambda t, d=d: t.to(d), opt) for d in devs]
    residual = [init_residual(p) for p in params] if compress_grads else None
    losses, step_s = [], []
    t0 = time.perf_counter()
    for it in range(start_step, steps):
        sl = torch.as_tensor(_batch(seed, it, len(labels), batch), device=feats.device)
        with monitor.timed(it):
            s0 = time.perf_counter()
            params, opt, loss, residual = dp_train_step(
                params, opt, feats[sl], labels[sl], sched.lr, residual, gcfg)
            losses.append(float(loss))  # waits for the step
            step_s.append(time.perf_counter() - s0)
        if (it + 1) % WINDOW == 0:
            mean = float(np.mean(losses[-WINDOW:]))
            sched.step(mean)
            log(f"  step {it + 1:4d} loss {mean:.4f} lr {sched.lr:.2e}")
        if ckpt is not None:
            ckpt.maybe_save(it + 1, (params[0], opt[0]))
            if (it + 1) % ckpt.policy.every_steps == 0:
                _save_schedule(ckpt.policy.directory, it + 1, sched)
    if ckpt is not None:
        ckpt.wait()
    return {"params": params[0], "opt": opt[0], "sched": sched, "losses": losses,
            "step_s": step_s, "seconds": time.perf_counter() - t0,
            "stragglers": len(monitor.events), "residual": residual}


def train(
    steps: int = 300,
    batch: int = 64,
    n_per_class: int = 24,
    ckpt_dir: str = "kws_ckpt",
    resume_run: bool = False,
    device=None,
    seed: int = 0,
    ckpt_every: int = 100,
    log: Callable = print,
    dp: int = 0,
    compress_grads: bool = False,
    devices=None,
) -> Dict:
    """The whole flow of `main`: corpus, features, training (``dp``,
    ``compress_grads``, ``devices``: data-parallel, as `fit`), test
    accuracy of the QAT model and of its integer replay. Returns `fit`'s
    dict with "start_step", "features" (train, test), "labels",
    "accuracy" / "confusion" and "int_accuracy" / "int_confusion"."""
    device = resolve_device(device)
    _full_float32(device)
    log("== synthesizing corpus ==")
    train_set = make_dataset(n_per_class, seed=0, unknown_split="train")
    test_set = make_dataset(max(n_per_class // 3, 4), seed=1, unknown_split="test")
    log("== extracting features (frontend='software') ==")
    ftr, fte = corpus_features(train_set["audio"], test_set["audio"], device)
    ytr = torch.as_tensor(train_set["label"], device=device)

    gcfg = GRUConfig()
    params = init_gru_classifier(gcfg, torch.Generator().manual_seed(seed), device)
    opt = init_opt_state(params, OPT)
    sched = ReduceLROnPlateau(*SCHEDULE)
    ckpt = CheckpointManager(CheckpointPolicy(ckpt_dir, every_steps=ckpt_every,
                                              async_save=True))
    start = 0
    if resume_run:
        try:
            params, opt, start = resume(ckpt, params, opt, sched, log)
            log(f"resumed from step {start}")
        except FileNotFoundError:
            log("no checkpoint found; starting fresh")
    if dp:
        log(f"== {dp}-way data parallel"
            f"{' + int8 compressed grads' if compress_grads else ''} on "
            f"{[str(d) for d in dp_devices(dp, devices, device)]} ==")
    log(f"== training steps {start}..{steps} on {device} ==")
    out = fit(params, opt, ftr, ytr, steps, batch, start, sched, ckpt, seed=seed, log=log,
              dp=dp, compress_grads=compress_grads, devices=devices)
    log(f"trained in {out['seconds']:.1f}s; stragglers flagged: {out['stragglers']}")

    model = {"params": out["params"], "config": gcfg}
    acc, conf = evaluate(model, fte, test_set["label"])
    int_acc, int_conf = evaluate(model, fte, test_set["label"], classifier="integer")
    log(f"test accuracy: {acc:.2%} over {len(CLASSES)} classes "
        f"(paper software model: 91.35% on real GSCD); integer replay "
        f"{int_acc:.2%}, {'the same' if np.array_equal(conf, int_conf) else 'NOT the same'} "
        f"confusion matrix")
    out.update(start_step=start, features=(ftr, fte), labels=(train_set["label"], test_set["label"]),
               accuracy=acc, confusion=conf, int_accuracy=int_acc, int_confusion=int_conf)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-per-class", type=int, default=24)
    ap.add_argument("--ckpt-dir", default="kws_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    ap.add_argument("--dp", type=int, default=0, help="data-parallel shards")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradient all-reduce with error feedback (with --dp)")
    ap.add_argument("--devices", nargs="+", default=None,
                    help="the shards' devices (with --dp; entries may repeat; default: the "
                         "first --dp cards, or all on the CPU with --device cpu)")
    args = ap.parse_args(argv)
    out = train(args.steps, args.batch, args.n_per_class, args.ckpt_dir, args.resume,
                args.device, dp=args.dp, compress_grads=args.compress_grads,
                devices=args.devices)
    return 0 if np.array_equal(out["confusion"], out["int_confusion"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
