"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
        [--smoke] [--steps 20] [--batch 4] [--seq 64] [--quant-bits 8] \
        [--ckpt-dir DIR] [--lr 1e-3] [--data D] [--model N] \
        [--device cuda|cpu]

Trains on the card by default (`--device cpu` runs the plain PyTorch
versions of the kernels), from random weights drawn from a seeded
generator, on the stateless `SyntheticLM` stream, resuming from the
newest checkpoint in --ckpt-dir if there is one.  --quant-bits trains
with the BRAMAC fake-quant forward (QAT, straight-through gradients).
The flags are the reference launcher's.  `--data D` and `--model N`
train on a data x model mesh of D·N ranks (`parallel.comm.spawn`: gloo,
every rank on the card, all on cuda:0 on one H100, with host staging):
each rank draws the same whole weights and keeps its blocks of them (its
`model` blocks and, ZeRO-3, 1/D of every leaf cut on its `fsdp` dim, the
AdamW state alike), takes B/D rows of each batch, gathers each block's
weights per use, and gets its gradients reduce-scattered over `data`
(`runtime.trainer`); every rank joins a checkpoint's gather and rank 0
prints and writes them, whole leaves.  A `model` axis trains every layer
kind (the experts split over it, either `ep_dispatch`; the MLA, mamba,
xLSTM and cross-attention mixers with their own collectives); a mesh
axis other than `data` and `model` raises NotImplementedError before any
rank starts.  The last line reads as the reference's: `loss a -> b over
n steps; straggler events: k`.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core.bramac_linear import QuantConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import build_mesh, dry_mesh
from repro_torch.runtime.serve import resolve_device
from repro_torch.runtime.trainer import Trainer, TrainerConfig, check_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--data", type=int, default=None)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--quant-bits", type=int, default=0, choices=(0, 2, 4, 8))
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    data = args.data or 1
    if data * args.model > 1:
        spec = f"data={data},model={args.model}"
        check_mesh(_config(args), dry_mesh(spec))    # before any rank starts
        comm.spawn(_train_rank, data * args.model, args, spec,
                   device=args.device)
        return
    _train(args, resolve_device(args.device))


def _train_rank(rank, world, device, args, spec):
    """One rank of the `--data` x `--model` mesh; rank 0 reports."""
    _train(args, device, mesh=build_mesh(spec), report=rank == 0)


def _config(args):
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.quant_bits:
        cfg = cfg.replace(quant=QuantConfig(enabled=True,
                                            bits_w=args.quant_bits,
                                            bits_a=args.quant_bits))
    return cfg


def _train(args, device, mesh=None, report=True):
    cfg = _config(args)
    if report:
        print(f"{'' if mesh is None else f'mesh {mesh.shape}  '}"
              f"device {device}  arch {cfg.name}  "
              f"params {cfg.param_count() / 1e6:.1f}M")

    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device)
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=25,
                         opt=adamw.AdamWConfig(lr=args.lr))
    trainer = Trainer(cfg, tcfg, params, mesh=mesh)
    del params                          # a mesh rank keeps its blocks only
    trainer.restore_latest()
    pipe = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch))
    hist = trainer.train(pipe, args.steps)
    if hist and report:
        print(f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
              f"over {len(hist)} steps; straggler events: "
              f"{len(trainer.straggler_events)}")


if __name__ == "__main__":
    main()
