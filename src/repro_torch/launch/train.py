"""Train loop of the port: train steps on the synthetic token stream,
with checkpoints and restart, on one device or on a mesh.

The reference's loop (``repro.launch.train``) with its fault-tolerance
contract:
  * a checkpoint every ``ckpt_every`` steps (host copy at once,
    serialized on a thread) and one at the end;
  * a restart resumes from the latest committed manifest — params,
    optimizer moments, error-feedback buffers and the data step, so the
    token stream continues exactly where it stopped;
  * a straggler watchdog: a step slower than ``straggler_factor`` times
    the trailing median is logged with its index;
  * ``mesh=`` (a ``DeviceMesh`` with ``data`` and ``model`` dims, and
    optionally ``pod``; one process per rank, its process group started):
    the rules of the train cell (``launch.mesh.rules_for``) place the
    parameters, moments and error buffers as DTensors, each rank reads
    its rows of the batch, and a restart re-shards the checkpoint onto
    the current mesh (elastic: save on one mesh, resume on another or on
    one device).  Only rank 0 prints and writes checkpoints.

The step runs as the reference's ``jax.jit(train_step, donate_argnums=
(0, 1, 2))`` does (:class:`TrainGraph`): the train state is written in
place, and on a card, with no mesh, the step is captured once a run as a
CUDA graph (after the first step, eager, has warmed it up) and replayed
at every later step.  On the CPU and on a mesh each step runs eagerly.

Labels are aligned with the positions: the stream's ``tokens`` go to
:func:`..models.model.lm_loss` as both inputs and labels, and its causal
shift scores the logit at position t against token t + 1.  The
reference's loop passes the stream's ``labels`` (already shifted by one)
and so trains on the token two ahead (ROADMAP.md Queue 3); the port does
not copy that.

A frontend model (no token embedding) is fed a stub: a normal draw from
a ``torch.Generator`` seeded by ``(seed, step)`` on the run's device,
plus ``tokens * 1e-3``, as the reference draws one with JAX's PRNG.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 20 --seq-len 4096 --global-batch 2
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --cpu \\
      --steps 20 --ckpt-dir ckpt

On a mesh, one process per rank (``torchrun`` sets the rendezvous)::

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \\
      --mesh 2,2 --steps 20 --global-batch 8
"""

from __future__ import annotations

import argparse
import gc
import statistics
import time
from typing import Optional, Union

import numpy as np
import torch

from .. import devices
from ..checkpoint import CheckpointManager
from ..configs import ARCHS, smoke_config
from ..configs.base import ShapeConfig
from ..data import DataConfig, ShardedTokenStream
from ..data.pipeline import batch_rows
from ..models.model import DTYPE, init_params, schema
from ..models.sharding import is_dtensor, local, mesh_dims
from ..optim import init as opt_init
from ..optim.grad_compress import init_error_feedback
from ..tree import leaves_with_paths
from . import mesh as mesh_lib
from .steps import make_train_step


def frontend_embeds(cfg, tokens: torch.Tensor, seed: int, step: int,
                    rank: int = 0, world: int = 1) -> torch.Tensor:
    """The frontend stub's (B, S, d) bf16 embeds for ``step``: a standard
    normal draw from a generator on ``tokens``' device seeded by ``(seed,
    step)``, plus ``tokens * 1e-3``.  ``tokens`` may be rows ``rank`` of
    ``world`` equal shares of the global batch: the draw is the global
    batch's, and those rows of it are kept."""
    dev = tokens.device
    key = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    gen = torch.Generator(device=dev).manual_seed(key)
    B, S = tokens.shape
    noise = torch.randn((B * world, S, cfg.d_model), generator=gen,
                        device=dev, dtype=DTYPE)[rank * B : (rank + 1) * B]
    return noise + tokens.to(DTYPE)[..., None] * 1e-3


class TrainGraph:
    """The train step as the reference's ``jax.jit(train_step,
    donate_argnums=(0, 1, 2))`` runs it: this object owns the train state
    — ``params``, ``opt_state`` (``mu``, ``nu``, the int32 ``step``) and
    the bf16 error buffers ``err`` — and static batch buffers, made from
    the first batch, and every step writes the state in place, so each
    tensor keeps its storage as a donated buffer does (AdamW writes the
    parameters and moments, this wrapper the new step counter and
    residuals, with ``copy_``).

    On a card, with no mesh, the first step is the warm-up: a real step,
    eager, on the side stream the capture then uses (it initialises the
    libraries' per-stream state, which a capture may not).  At the second
    step the warm-up's garbage is collected and the allocator's cached
    blocks released, so the graph's private pool can take them;
    ``train_step`` is captured with ``torch.cuda.graph`` (a capture runs
    no kernel: the state is not stepped) and replayed; every later step
    replays it.  A replay copies the batch into the static buffers
    first; its metrics are the graph's static ``loss`` / ``grad_norm`` /
    ``lr`` tensors, which the next step overwrites.  On the CPU, and on
    a mesh (DTensors: there the step stays eager), every step runs the
    same code eagerly.  A batch of another shape or dtype raises
    ``ValueError``: a graph replays only what it captured.  A failed
    capture or replay raises; nothing falls back to the eager step."""

    def __init__(self, train_step, params: dict, opt_state: dict, err: dict):
        self.train_step = train_step
        self.params, self.opt_state, self.err = params, opt_state, err
        leaf = leaves_with_paths(params)[0][1]
        self.captures = local(leaf).device.type == "cuda" \
            and not is_dtensor(leaf)
        self.batch: Optional[dict] = None
        self.stream: Optional["torch.cuda.Stream"] = None
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.metrics: Optional[dict] = None
        # host seconds of the warm-up step and of the capture
        self.warmup_s: Optional[float] = None
        self.capture_s: Optional[float] = None

    @property
    def state(self) -> dict:
        """The train state as a checkpoint stores it."""
        return {"params": self.params, "opt": self.opt_state,
                "err": self.err}

    def __call__(self, batch: dict) -> dict:
        """One step on ``batch`` → ``{"loss", "grad_norm", "lr"}``, scalar
        tensors on the device."""
        self._fill(batch)
        if not self.captures:
            return self._step()
        if self.stream is None:
            return self._warm_up()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        return self.metrics

    def _fill(self, batch: dict):
        if self.batch is None:
            self.batch = {k: v.clone() for k, v in batch.items()}
            return
        want = {k: (tuple(v.shape), v.dtype) for k, v in self.batch.items()}
        got = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
        if got != want:
            raise ValueError(f"batch {got} is not the step's {want}: the "
                             "step replays only the shapes it captured")
        for k, v in batch.items():
            self.batch[k].copy_(v)

    def _step(self) -> dict:
        """``train_step`` on the static state and batch; the new step
        counter and residuals copied into the state's own tensors."""
        _, opt_state, err, metrics = self.train_step(
            self.params, dict(self.opt_state), self.err, self.batch)
        with torch.no_grad():
            self.opt_state["step"].copy_(opt_state["step"])
            if err is not self.err:
                new = dict(leaves_with_paths(err))
                for path, e in leaves_with_paths(self.err):
                    local(e).copy_(local(new[path]))
        return metrics

    def _warm_up(self) -> dict:
        main = torch.cuda.current_stream(self.opt_state["step"].device)
        self.stream = torch.cuda.Stream(main.device)
        t0 = time.perf_counter()
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            metrics = self._step()
        main.wait_stream(self.stream)
        self.warmup_s = time.perf_counter() - t0
        return metrics

    def _capture(self):
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.stream.device)
        # the warm-up's garbage first: remat's checkpoint leaves reference
        # cycles that hold its gradients, whose blocks the pool could take
        gc.collect()
        torch.cuda.empty_cache()
        self.graph = torch.cuda.CUDAGraph()
        # the outer context gives the caller its stream back if the
        # capture fails (torch.cuda.graph's exit then leaves its own)
        with torch.cuda.stream(main), \
                torch.cuda.graph(self.graph, stream=self.stream):
            self.metrics = self._step()
        self.capture_s = time.perf_counter() - t0


def train(
    arch: str = "qwen2-0.5b",
    steps: int = 20,
    smoke: bool = True,
    seq_len: int = 128,
    global_batch: int = 8,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 10,
    grad_compression: bool = True,
    straggler_factor: float = 3.0,
    log_every: int = 1,
    seed: int = 0,
    device: Union[str, torch.device, None] = None,
    mesh=None,
) -> dict:
    """Train ``arch`` (``smoke``: its reduced config) to step ``steps`` on
    ``device`` (default: the card), from step 0 or the latest checkpoint
    under ``ckpt_dir``; on ``mesh`` (a ``DeviceMesh`` on ``device``'s
    type) with the train cell's rules.  The step runs through a
    :class:`TrainGraph`: on a card with no mesh the run's first step (or
    the first after a restore) is its eager warm-up, and the step is
    captured once at the second and replayed at it and every later step;
    on the CPU, and on a mesh, eagerly.  Returns ``losses`` and
    ``history`` (per step run: ``step``, ``loss``, ``grad_norm``, ``lr``,
    ``seconds``; the loss the global batch's; the first step's seconds
    are the warm-up's, the second's hold the capture), the first step run
    (``start_step``), the final ``params``, ``opt_state`` and ``err``
    (the error-feedback buffers; DTensors on a mesh), the ``rules`` (None
    without a mesh) and the host seconds of the warm-up step and of the
    capture (``warmup_s``, ``capture_s``; None where nothing was
    captured)."""
    dev = devices.resolve(device)
    cfg = ARCHS[arch]
    if smoke:
        cfg = smoke_config(cfg)
    rules = shardings = batch_sh = None
    if mesh is not None:
        rules = mesh_lib.rules_for(
            cfg, ShapeConfig("train", seq_len, global_batch, "train"), mesh)
        shardings = mesh_lib.param_shardings(cfg, rules)
        batch_sh = rules.act().sharding_for_shape(("batch", "seq"),
                                                  (global_batch, seq_len))
        if mesh_dims(batch_sh.spec[0]) != rules.batch_axes():
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over the batch dims {rules.batch_axes()}")
    rank, world = batch_rows(batch_sh)
    main = _is_main()
    train_step, ocfg = make_train_step(cfg, rules=rules,
                                       grad_compression=grad_compression)

    # --- state init or restore ------------------------------------------------
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        spec = schema(cfg)          # the keys a restore reads
        place = None if shardings is None else {
            "params": shardings, "opt": {"mu": shardings, "nu": shardings},
            "err": shardings}
        state, manifest = mgr.restore(
            {"params": spec, "opt": {"mu": spec, "nu": spec, "step": 0},
             "err": spec}, device=dev, shardings=place)
        params, opt_state, err = state["params"], state["opt"], state["err"]
        start_step = manifest["step"]
        if main:
            print(f"[train] restored step {start_step} from {ckpt_dir}",
                  flush=True)
    else:
        if rules is None:
            params = init_params(cfg, seed=seed, device=dev)
        else:
            params = mesh_lib.init_sharded_params(cfg, rules, seed, dev)
        opt_state = opt_init(ocfg, params)
        err = init_error_feedback(params)

    data = ShardedTokenStream(
        DataConfig(cfg.vocab, seq_len, global_batch, seed=seed))

    # --- loop -------------------------------------------------------------------
    run = TrainGraph(train_step, params, opt_state, err)
    losses, durations, history = [], [], []
    for step in range(start_step, steps):
        tokens = torch.from_numpy(np.ascontiguousarray(
            data.batch_at(step, rank, world)["tokens"])).to(dev)
        batch = {"labels": tokens}
        if cfg.uses_tokens:
            batch["tokens"] = tokens
        else:
            batch["embeds"] = frontend_embeds(cfg, tokens, seed, step, rank,
                                              world)
        t0 = time.perf_counter()
        metrics = run(batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        durations.append(dt)
        history.append({"step": step, "loss": loss,
                        "grad_norm": float(metrics["grad_norm"]),
                        "lr": float(metrics["lr"]), "seconds": dt})
        if len(durations) >= 5 and main:
            med = statistics.median(durations[-20:])
            if dt > straggler_factor * med:
                print(f"[straggler] step {step}: {dt:.3f}s vs median "
                      f"{med:.3f}s", flush=True)
        if step % log_every == 0 and main:
            print(f"[train] step {step} loss {loss:.4f} gnorm "
                  f"{history[-1]['grad_norm']:.3f} lr "
                  f"{history[-1]['lr']:.3g} {dt * 1e3:.0f}ms", flush=True)
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, run.state, blocking=False,
                     extra={"arch": arch, "loss": loss})
    if mgr:
        mgr.save(steps, run.state,
                 extra={"arch": arch, "loss": losses[-1] if losses else None})
        mgr.wait()
        if mesh is not None:        # every rank sees the committed step
            torch.distributed.barrier()
    return {"losses": losses, "history": history, "start_step": start_step,
            "params": run.params, "opt_state": run.opt_state, "err": run.err,
            "rules": rules, "warmup_s": run.warmup_s,
            "capture_s": run.capture_s}


def _is_main() -> bool:
    return (not torch.distributed.is_initialized()
            or torch.distributed.get_rank() == 0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced-width model (the CPU smoke config)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--no-grad-compression", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights and the data stream")
    ap.add_argument("--mesh", default=None,
                    help="data,model (or pod,data,model) sizes: train on a "
                    "mesh, one process per rank, as torchrun starts them")
    args = ap.parse_args()
    device = "cpu" if args.cpu else None
    mesh = None
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.split(","))
        axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                          "model")
        mesh = mesh_lib.make_mesh(shape, axes, device)
    out = train(
        arch=args.arch, steps=args.steps, smoke=args.smoke,
        seq_len=args.seq_len, global_batch=args.global_batch,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        grad_compression=not args.no_grad_compression, seed=args.seed,
        device=device, mesh=mesh,
    )
    if _is_main():
        if out["losses"]:
            print(f"[train] done; final loss {out['losses'][-1]:.4f}")
        else:
            print(f"[train] done; already at step {out['start_step']}")
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
