"""Training driver (port of ``repro/launch/train.py``): config → synthetic
data → train loop with fault tolerance, on one device.

- resume from the latest checkpoint (atomic checkpoints and a counter-based
  data pipeline: a resumed run takes the batches the uninterrupted one
  would have);
- a checkpoint on SIGTERM (preemption), taken at the end of the step it
  lands in;
- a per-step deadline watchdog that flags stragglers.

The reference's mesh and its sharded restore are not ported: one device.
Checkpoints are the reference's files, so either package resumes the
other's.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--smoke] \\
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import List

from repro_torch.checkpoint.manager import (CheckpointManager,
                                            install_sigterm_checkpoint)
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_train_step


class StepWatchdog:
    """Flags steps exceeding a deadline (straggler / hang detection)."""

    def __init__(self, deadline_s: float = 300.0):
        self.deadline = deadline_s
        self.slow_steps = 0

    def observe(self, dt: float, step: int) -> bool:
        if dt > self.deadline:
            self.slow_steps += 1
            print(f"[watchdog] step {step} took {dt:.1f}s "
                  f"(deadline {self.deadline}s) — straggler suspected")
            return True
        return False


def main(argv=None) -> List[float]:
    """Train and return the losses of the steps run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true", help="use reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    tc = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10), microbatch=args.microbatch,
        grad_compression=args.grad_compression,
    )
    data = SyntheticTokens(DataConfig(
        seed=0, vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch), cfg, device=dev)

    params = api.init_model(cfg, seed=0, device=dev)
    opt = adamw.init_opt_state(params, tc)
    start_step = 0

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and mgr.latest_step() is not None:
        (params, opt), meta = mgr.restore((params, opt), device=dev)
        start_step = int(meta["step"])
        print(f"[resume] restored step {start_step} from {mgr.dir}")

    step_fn = make_train_step(cfg, tc)
    watchdog = StepWatchdog(deadline_s=600.0)

    # the step updates params and state in place: a SIGTERM waits for the
    # step (and any save) to end, so the checkpoint holds one whole step
    state = {"params": params, "opt": opt, "step": start_step}
    whole_step = contextlib.nullcontext
    if mgr:
        whole_step = install_sigterm_checkpoint(
            lambda: mgr.save(state["step"], (state["params"], state["opt"]),
                             {"reason": "sigterm"})).deferred

    losses = []
    for step in range(start_step, args.steps):
        with whole_step():
            t0 = time.time()
            batch = data.batch_at(step)
            params, opt, metrics = step_fn(params, opt, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            state.update(params=params, opt=opt, step=step + 1)
            dt = time.time() - t0
            watchdog.observe(dt, step)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"gnorm {float(metrics['grad_norm']):.2f}  {dt:.2f}s",
                      flush=True)
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, (params, opt), {"loss": loss})
    if mgr:
        with whole_step():
            mgr.save(args.steps, (params, opt), {"loss": losses[-1]})
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses

if __name__ == "__main__":
    main()
