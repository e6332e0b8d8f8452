"""What a step of the port costs, counted on the `meta` device.

`Counter` is a `TorchDispatchMode`: every aten op the step dispatches
passes through it, on meta tensors that hold shapes and dtypes and no
data, so a full-width step of any arch is counted on a CPU without
allocating its bytes.  Per op it counts:

- FLOPs of the matmul-class ops (`torch.utils.flop_counter`'s formulas),
  by the operands' dtype class ("bf16", "f32", "int");
- bytes: each op reads its tensor inputs and writes its outputs (the eager
  program's HBM traffic, the counterpart of XLA's "bytes accessed").  View
  ops move nothing; an indexed write (`index_put_`, `scatter`,
  `index_copy_`) moves its values and indices, not the whole destination;
  `copy_` reads its source and writes its destination;
- an index's backward (`index_backward`: an embedding lookup's gradient)
  writes into fresh zeros in place on the card (`_index_put_impl_`), but
  takes the out-of-place `index_put` under any dispatch mode, this one
  included: the counter counts that `index_put` as the in-place write it
  stands for (its bytes as an indexed write's, and the zeros' storage
  handed to the result, not a second copy of it live);
- live bytes: every storage an op creates is live until its last tensor
  dies, so the peak over the step is the device memory the eager program
  needs, the tracked arguments included; `mark()` splits the step into
  phases with a peak each.  Each storage is also rounded up to the CUDA
  caching allocator's 512-byte granule (`peaks_rounded`).

The hand-written `bramac_matmul` has a meta route that allocates what its
CUDA route allocates and counts its 2·M·N·K int8 operations and operand
bytes (`bramac_matmul.meta_*`); the counter adds them to its own totals.

Elementwise ops on meta tensors run PyTorch's Python reference meta
functions, ~0.1-1 ms each (a random draw's tens of milliseconds), and a
step-by-step scan at S = 32768 issues millions of them.  `FastMeta`, the
mode `Counter` builds on, gives an op that creates a new tensor the
metadata its reference meta function gave the first time the same
operand metadata and arguments came (a meta result depends on nothing
else), an in-place pointwise op its first operand, and a draw its
shape: the same results at a few microseconds.  `Counter(fast=False)`
takes the reference functions throughout; the tests hold the two equal.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.bramac_matmul import bramac_matmul
from repro_torch.tree import tree_items

GRANULE = 512                     # the caching allocator's rounding
_aten = torch.ops.aten
META = torch.device("meta")
# a random draw's meta result is its shape: its reference meta function
# takes tens of milliseconds
_RANDN = {_aten.randn.default, _aten.randn.generator}
_INDEXED_WRITES = {_aten.index_put_.default, _aten._index_put_impl_.default,
                   _aten.index_copy_.default, _aten.scatter_.src,
                   _aten.scatter_.value, _aten.scatter_add_.default,
                   _aten.scatter_reduce_.two, _aten.index_put.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results (tensors, lists and
    tuples of them, dicts of keyword arguments), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def dtype_class(dtype: torch.dtype) -> str:
    """The peak a matmul of this operand dtype runs at: "bf16" (bf16 and
    fp16 tensor cores), "f32" (no TF32) or "int" (int8 tensor cores)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype.is_floating_point:
        return "f32"
    return "int"


def _shape(x):
    """What `flop_counter`'s formulas take: tensors as their shapes."""
    if isinstance(x, torch.Tensor):
        return x.shape
    if isinstance(x, (list, tuple)):
        return type(x)(_shape(v) for v in x)
    return x


def _key(x):
    """A hashable key of an op argument's metadata: a tensor's shape,
    strides and dtype (every operand of a memoized op is on meta); other
    values as they are, with their type (a generator by its type alone:
    it does not shape the output)."""
    t = type(x)
    if t is torch.Tensor or isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype)
    if t is list or t is tuple:
        return tuple([_key(v) for v in x])
    if t is dict:
        return tuple([(k, _key(v)) for k, v in x.items()])
    if isinstance(x, torch.Generator):
        return torch.Generator
    hash(x)
    return (t, x)


def _broadcast(shapes):
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for i, d in enumerate(s, nd - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


class FastMeta(TorchDispatchMode):
    """Runs ops on meta tensors without their slow reference meta
    functions where it can (see the module docstring); also the mode the
    stand-ins (`launch.specs`) are built under.  `_seen(func, args,
    kwargs, ins, out)` is called after every op."""

    # op -> route, and (op, argument metadata) -> output metadata: pure
    # functions of their keys, shared by every instance
    _route: dict = {}
    _memo: dict = {}

    def _fresh(self, func, args, kwargs):
        """The op's meta output rebuilt from the metadata its reference meta
        function gave for the same operand metadata and arguments the
        first time (shapes, strides, dtypes: meta results depend on nothing
        else); on a first call, the op's own result."""
        try:
            key = (func, _key(args), _key(kwargs))
        except TypeError:                        # an argument we cannot key
            return func(*args, **kwargs)
        meta = self._memo.get(key)
        if meta is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if all(isinstance(t, torch.Tensor) and t.is_meta for t in outs):
                self._memo[key] = (isinstance(out, (tuple, list)), [
                    (tuple(t.shape), t.stride(), t.dtype) for t in outs])
            return out
        many, metas = meta
        outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                for sh, st, dt in metas]
        return tuple(outs) if many else outs[0]

    @staticmethod
    def _inplace(args, kwargs, ins):
        """A pointwise in-place op (`add_`, `mul_`, ...) whose operands
        broadcast to its first one: that operand, or None."""
        if "out" in kwargs:
            return None
        shapes = [tuple(a.shape) for a in ins]
        try:
            if _broadcast(shapes) == shapes[0]:
                return args[0]
        except ValueError:
            return None
        return None

    def _seen(self, func, args, kwargs, ins, out) -> None:
        pass

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors(args, [])
        if kwargs:
            _tensors(kwargs, ins)
        out = None
        route = self._route.get(func)
        if route is None:
            route = self._route[func] = (
                "fresh" if not func._schema.is_mutable and not func.is_view
                else "inplace" if torch.Tag.pointwise in func.tags and
                func._schema.name.endswith("_") else "")
        if self.fast and route and all(t.is_meta for t in ins):
            if func in _RANDN and kwargs.get("device") == META:
                out = torch.empty(args[0], dtype=kwargs.get("dtype") or
                                  torch.get_default_dtype(), device=META)
                self._seen(func, args, kwargs, ins, out)
                return out
            if route == "fresh":
                out = self._fresh(func, args, kwargs)
                self._seen(func, args, kwargs, ins, out)
                return out
            out = self._inplace(args, kwargs, ins)
        if out is None:
            out = func(*args, **kwargs)
        self._seen(func, args, kwargs, ins, out)
        return out

    fast = True


class Counter(FastMeta):
    """Counts FLOPs, bytes and live bytes of the ops run under it (see the
    module docstring).  `track(tree)` adds existing tensors (the step's
    arguments) to the live set first.  `fast=False` runs every op through
    its reference meta function (the tests compare the two)."""

    def __init__(self, fast: bool = True):
        super().__init__()
        self.fast = fast
        self.flops = collections.Counter()
        self.mm_flops = collections.Counter()
        self.bytes = 0
        self.ops = 0
        self.live = self.live_rounded = 0
        # the peak of each phase of the step (`mark` closes one): exact
        # and rounded to the allocator's granule
        self.peaks, self.peaks_rounded = [0], [0]
        self.kernel_calls = 0
        self._sizes: dict[int, int] = {}
        self._refs: dict[int, weakref.ref] = {}
        self._k0 = None

    # -- live bytes --------------------------------------------------------
    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.live_rounded += -(-n // GRANULE) * GRANULE
        self.peaks[-1] = max(self.peaks[-1], self.live)
        self.peaks_rounded[-1] = max(self.peaks_rounded[-1],
                                     self.live_rounded)
        self._refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))

    def _free(self, key: int) -> None:
        n = self._sizes.pop(key, None)
        self._refs.pop(key, None)
        if n is not None:
            self.live -= n
            self.live_rounded -= -(-n // GRANULE) * GRANULE

    @property
    def peak(self) -> int:
        return max(self.peaks)

    @property
    def peak_rounded(self) -> int:
        return max(self.peaks_rounded)

    def mark(self) -> None:
        """Close a phase of the step (a training step's forward, backward
        and update peak at different places, each affine in the number of
        periods with its own slope): the next phase's peak starts from the
        live bytes now."""
        self.peaks.append(self.live)
        self.peaks_rounded.append(self.live_rounded)

    def track(self, tree) -> int:
        """Add the tensors of `tree` to the live set; returns the bytes of
        the storages it added."""
        before = self.live
        for _, t in tree_items(tree):
            self._add(t)
        return self.live - before

    # -- the kernel's meta route ------------------------------------------
    def __enter__(self):
        self._k0 = self._kernel()
        return super().__enter__()

    def __exit__(self, *exc):
        k1 = self._kernel()
        self.flops["int"] += k1[1] - self._k0[1]
        self.bytes += k1[2] - self._k0[2]
        self.kernel_calls = k1[0] - self._k0[0]
        return super().__exit__(*exc)

    @staticmethod
    def _kernel():
        f = bramac_matmul
        return f.meta_calls, f.meta_ops, f.meta_bytes

    # -- dispatch ----------------------------------------------------------
    def _seen(self, func, args, kwargs, ins, out) -> None:
        self.ops += 1
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:            # its shape function, unwrapped
            n = formula.__wrapped__(*map(_shape, args), **{
                k: _shape(v) for k, v in kwargs.items()},
                out_shape=_shape(out))
            cls = dtype_class(ins[0].dtype)
            self.flops[cls] += n
            self.mm_flops[(cls,) + tuple(tuple(t.shape) for t in ins)] += n
        outs = _tensors(out, [])
        if not func.is_view:
            if func in _INDEXED_WRITES:        # indices + values, once
                written = _nbytes(ins[-1]) if len(ins) > 2 else \
                    ins[1].numel() * ins[0].element_size()
                self.bytes += sum(_nbytes(t) for t in ins[1:]) + written
            elif func is _aten.copy_.default:
                self.bytes += 2 * _nbytes(args[0])
            else:
                self.bytes += sum(_nbytes(t) for t in ins) + \
                    sum(_nbytes(t) for t in outs)
        if func is _aten.index_put.default:     # index_backward's in-place write
            self._free(id(ins[0].untyped_storage()))
        for t in outs:
            self._add(t)
