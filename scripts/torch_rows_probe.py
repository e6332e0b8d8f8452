"""Find where a port model's rows depend on the batch they are computed in.

A data-parallel step computes each rank's rows as a batch of their own.
Where an op's result for a row depends on the other rows of its batch
(another kernel or summation order picked for another batch size), the
mesh step's loss parts from the meshless whole-batch step's although both
compute the same function.  This script runs the loss forward of one
model twice on the same seeded weights and batch: on the first half of
the batch alone, then on the whole batch, and compares every ATen op's
output on the half's rows (an output whose leading dim is the batch's,
or the batch's times S, compared on its first half; one of equal shape
compared whole; an uninitialized buffer skipped).  It prints the losses
of the whole batch, of each half and their mean, and the first ops whose
outputs differ, each with the model code line that called it.

    python scripts/torch_rows_probe.py --arch xlstm-1.3b --layers 8
    python scripts/torch_rows_probe.py --arch xlstm-1.3b --smoke --device cpu

Weights and batch as chip_smoke.py's 15k draws them (seed 0 on the
device, `SyntheticLM` batch 0, B=4 S=64), QAT 8/8 unless --quant-bits 0.
The last line is a JSON object of the readings.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.bramac_linear import QuantConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


def _site() -> str:
    """The innermost model-code frame of the current call stack."""
    for f in reversed(traceback.extract_stack()):
        if "repro_torch" in f.filename and "models" in f.filename:
            return f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
    return "?"


# ops whose outputs hold no values yet (a kernel's output buffer)
_UNSET = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}


class _Record(TorchDispatchMode):
    """Keeps every op's first tensor output (`keep`), or compares it with
    the output of the same op in a kept run (`against`)."""

    def __init__(self, against=None, limit=8):
        super().__init__()
        self.outs, self.against = [], against
        self.diffs, self.limit, self.compared = [], limit, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        t = out[0] if isinstance(out, (tuple, list)) and out else out
        if not isinstance(t, torch.Tensor) or t.is_sparse or \
                func.overloadpacket.__name__ in _UNSET:
            t = None
        if self.against is None:
            self.outs.append(None if t is None else t.detach().clone())
            return out
        k = len(self.outs)
        self.outs.append(None)
        if t is None or k >= len(self.against) or self.against[k] is None:
            return out
        h = self.against[k]
        w = t.detach()
        if w.shape != h.shape:
            if w.dim() == 0 or w.shape[1:] != h.shape[1:] or \
                    w.shape[0] != 2 * h.shape[0]:
                return out
            w = w[:h.shape[0]]
        self.compared += 1
        if len(self.diffs) < self.limit and not torch.equal(w, h):
            d = (w.to(torch.float64) - h.to(torch.float64)).abs()
            self.diffs.append(dict(op=k, func=str(func), site=_site(),
                                   shape=list(t.shape),
                                   max_abs=float(d.max()),
                                   differing=int((d > 0).sum())))
        return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (default: all)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant-bits", type=int, default=8)
    ap.add_argument("--dtype", default=None, help="override cfg.dtype")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cfg = get_config(a.arch, smoke=a.smoke)
    if a.layers:
        cfg = cfg.replace(num_layers=a.layers)
    if a.quant_bits:
        cfg = cfg.replace(quant=QuantConfig(enabled=True, bits_w=a.quant_bits,
                                            bits_a=a.quant_bits))
    if a.dtype:
        cfg = cfg.replace(dtype=a.dtype)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    gen = torch.Generator(device=a.device).manual_seed(0)
    params = M.init_params(cfg, gen, a.device)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, a.seq, a.batch)).batch(
        0, a.device)
    if cfg.vision_tokens:
        raise SystemExit("a vlm's batch needs vision embeddings: not probed")
    half = a.batch // 2
    halves = [{k: v[i * half:(i + 1) * half] for k, v in batch.items()}
              for i in range(2)]
    with torch.no_grad():
        losses = [M.loss_fn(params, h, cfg)[0] for h in halves[1:]]
        with _Record() as kept:
            first = M.loss_fn(params, halves[0], cfg)[0]
        with _Record(against=kept.outs) as cmp:
            whole = M.loss_fn(params, batch, cfg)[0]
    mean = (first + losses[0]) / 2
    out = dict(arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
               quant_bits=a.quant_bits, device=a.device,
               card=torch.cuda.get_device_name(0) if a.device == "cuda"
               else None, whole=float(whole), halves=[float(first),
                                                     float(losses[0])],
               halves_mean=float(mean),
               rel=float((mean - whole).abs() / whole.abs()),
               ops=len(kept.outs), compared=cmp.compared, first=cmp.diffs)
    print(f"{cfg.name}, {cfg.num_layers} layers, {cfg.dtype}, QAT "
          f"{a.quant_bits or 'off'}, B={a.batch} S={a.seq} on {a.device}: "
          f"whole-batch loss {out['whole']!r}, halves {out['halves']}, "
          f"their mean {out['halves_mean']!r} (relative {out['rel']:.3e}); "
          f"{cmp.compared} of {len(kept.outs)} op outputs compared on the "
          f"first half's rows")
    for d in cmp.diffs:
        print(f"  op {d['op']} {d['func']} at {d['site']}: shape "
              f"{d['shape']}, {d['differing']} values differ, max "
              f"{d['max_abs']:.3e}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
