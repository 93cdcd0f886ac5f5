"""PyTorch wrappers of the hand-written CUDA kernels for the scheme ops'
modular arithmetic (csrc/rns_ops.cu).

  * K9 ``rns_map``: one launch per RNS primitive of ``ckks.modmath``
    (add_mod, sub_mod, neg_mod, mul_mod, mul_mod_shoup and its wide and
    lazy forms, the fused multiply-add mul_add_mod), the first operand
    optionally read through a permutation of the last dimension.
    Replaces the XLA-fused primitives of the JAX package
    (``hectr_tpu/ckks/modmath.py:58``, ``:64``, ``:70``, ``:76-85``,
    ``:100``, ``:115``); computes what ``ckks.modmath.<name>_plain``
    computes.
  * K10 ``mod_product_sum``: sum_mod(mul_mod(C, w), dim) in one pass, the
    BSGS group sum (``hectr_tpu/ckks/gemv.py:430-434``); computes what
    ``ckks.modmath.mod_product_sum_plain`` computes.

Both are bound by device memory (the source note in csrc/rns_ops.cu has
the design; ``bench.rns_bound`` the bound).  The kernels are compiled from
the repository's source with nvcc at first use
(``hectr_tpu_torch.ops.build``) and bound through a plain C interface with
ctypes; nothing here touches CUDA or nvcc at import time.

Operands are read through their own strides.  ``map_plan`` and
``reduce_plan`` turn the operands' shapes and strides into the kernels'
iteration space: the shapes broadcast against each other (a broadcast
dimension reads with stride 0, as ``torch.broadcast_tensors`` would give
it, without making the views), size-1 dimensions drop out, and adjacent
dimensions merge wherever every operand's strides let them, up to
MAX_DIMS (the paths' calls need 1-4: most are [rows, R, N] with a [R, 1]
column, 3; K10 over a batch of loops, whose summed axis lies between the
batch and the components, 4).  The plans are pure functions of shapes and
strides, and the wrappers cache them by (shapes, strides, dtypes, devices;
the per-row constants by identity), so a call's host work is a dictionary
lookup, an output allocation and the launch.

Each wrapper adds one to ``LAUNCHES[name]`` (and K9 to ``OP_LAUNCHES`` by
primitive) where it launches its kernel, and nowhere else.  Each raises on
a tensor off the card, of another dtype than int64, on operands that do
not broadcast, and on an iteration space of more than MAX_DIMS dimensions.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math

import torch

from hectr_tpu_torch.ops import launches
from hectr_tpu_torch.ops.build import launch_on, load, raise_on

MAX_DIMS = 6          # merged dimensions the kernels take
# K9's primitives: (code in csrc/rns_ops.cu, operands)
OPS = {
    "add_mod": (0, 3),             # a, b, p
    "sub_mod": (1, 3),             # a, b, p
    "neg_mod": (2, 2),             # a, p
    "mul_mod": (3, 5),             # a, b, p, mu, k
    "mul_mod_shoup": (4, 4),       # a, w, w_shoup, p
    "mul_mod_shoup_wide": (5, 4),
    "mul_mod_shoup_lazy": (6, 4),
    "mul_add_mod": (7, 6),         # a, b, c, p, mu, k
}

# how many of a primitive's trailing operands are per-row constants
CONSTANTS = {op: 3 if op in ("mul_mod", "mul_add_mod") else 1 for op in OPS}

LAUNCHES = launches.register({"rns_map": 0, "mod_product_sum": 0})
OP_LAUNCHES: collections.Counter = launches.register(
    collections.Counter())
reset_launches = launches.resetter(LAUNCHES, OP_LAUNCHES)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    lib = load("rns_ops.cu")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.hectr_rns_map.argtypes = [i32, i32, i32, ptr, ptr] + [ptr] * 9
    lib.hectr_rns_map.restype = i32
    lib.hectr_mod_product_sum.argtypes = [i32, ptr, ptr, ptr, i64] + [ptr] * 7
    lib.hectr_mod_product_sum.restype = i32
    return lib


# ---------------------------------------------------------------------------
# the stride plans (pure functions of shapes and strides)
# ---------------------------------------------------------------------------


def broadcast(shapes, strides) -> tuple[tuple[int, ...], list[list[int]]]:
    """The broadcast shape of `shapes` and each operand's strides over it:
    stride 0 along every dimension the operand broadcasts (missing or of
    size 1), as ``torch.broadcast_tensors`` gives its views."""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for shape in shapes:
        for i, n in enumerate(shape, nd - len(shape)):
            if n != 1:
                if out[i] not in (1, n):
                    raise ValueError(f"shapes {[tuple(s) for s in shapes]} "
                                     f"do not broadcast")
                out[i] = n
    full = []
    for shape, stride in zip(shapes, strides):
        pad = nd - len(shape)
        full.append([0] * pad + [st if n != 1 else 0
                                 for n, st in zip(shape, stride)])
    return tuple(out), full


def merge(sizes, strides, keep_last: bool = False
          ) -> tuple[list[int], list[list[int]]]:
    """Drop size-1 dimensions and merge each dimension into the next inner
    one wherever every operand's stride allows it (stride[i] ==
    stride[i+1] * size[i+1]); with `keep_last` the last dimension stays
    apart (it is the one a permutation indexes).  Returns the merged
    sizes (at least one) and strides, outer to inner."""
    last = len(sizes) - 1
    m_sizes: list[int] = []                 # inner to outer while built
    m_strides: list[list[int]] = [[] for _ in strides]
    for i in reversed(range(len(sizes))):
        if sizes[i] == 1 and not (keep_last and i == last):
            continue
        g = len(m_sizes) - 1                # the outermost group so far
        if g >= 0 and not (keep_last and g == 0) and all(
                st[i] == m[g] * m_sizes[g]
                for st, m in zip(strides, m_strides)):
            m_sizes[g] *= sizes[i]
            continue
        m_sizes.append(sizes[i])
        for st, m in zip(strides, m_strides):
            m.append(st[i])
    if not m_sizes:
        return [1], [[0] for _ in strides]
    return m_sizes[::-1], [m[::-1] for m in m_strides]


def map_plan(shapes, strides, keep_last: bool = False):
    """K9's iteration space for operands of these shapes and strides:
    (output shape, merged sizes, each operand's merged strides)."""
    out_shape, full = broadcast(shapes, strides)
    sizes, m_strides = merge(out_shape, full, keep_last)
    if len(sizes) > MAX_DIMS:
        raise ValueError(f"{len(sizes)} dimensions after merging "
                         f"{[tuple(s) for s in shapes]}: the kernel takes at "
                         f"most {MAX_DIMS}")
    return out_shape, sizes, m_strides


def reduce_plan(shapes, strides, dim: int, fixed: int = 2):
    """K10's iteration space: the operands broadcast to one shape, `dim`
    taken out as the reduction axis, the other dimensions merged.
    Returns (output shape, reduction size, each operand's stride along
    it, merged sizes, merged strides).  Operands from index `fixed` on
    (the per-row constants) must not vary along `dim`."""
    full_shape, full = broadcast(shapes, strides)
    nd = len(full_shape)
    if not -nd <= dim < nd:
        raise ValueError(f"dim {dim} of a {nd}-dimensional product")
    dim %= nd
    red_size = full_shape[dim]
    red_strides = [st[dim] if red_size != 1 else 0 for st in full]
    if any(red_strides[fixed:]):
        raise ValueError("the per-row constants vary along the summed "
                         "dimension")
    rest = [n for i, n in enumerate(full_shape) if i != dim]
    rest_strides = [[s for i, s in enumerate(st) if i != dim] for st in full]
    sizes, m_strides = merge(rest, rest_strides)
    if len(sizes) > MAX_DIMS:
        raise ValueError(f"{len(sizes)} dimensions after merging "
                         f"{[tuple(s) for s in shapes]}: the kernel takes at "
                         f"most {MAX_DIMS}")
    return tuple(rest), red_size, red_strides, sizes, m_strides


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Launch:
    """A cached plan, its arrays ready for the C entry point, and the
    per-row constants it was built for (kept alive: see ``_key``)."""

    out_shape: tuple
    device: int
    ndim: int
    sizes: ctypes.Array
    strides: ctypes.Array
    empty: bool
    consts: tuple
    red_size: int = 0
    red_strides: ctypes.Array | None = None


_PLANS: dict = {}
MAX_PLANS = 4096      # the cache is emptied when it grows past this


def _key(head, data, consts) -> tuple:
    """The plan cache's key: each data operand's shape, strides, dtype and
    device, and each per-row constant (the trailing p, or p, mu, k: the
    contexts' tables) by identity, which is cheaper on the host.  A plan
    holds its constants, so no other tensor takes their identity while it
    is cached; a table is never resized in place."""
    return (*head, *[(x.shape, x.stride(), x.dtype, x.get_device())
                     for x in data], *[id(x) for x in consts])


def _validate(name: str, tensors) -> int:
    """The one CUDA device index every operand lies on, or raise."""
    for i, x in enumerate(tensors):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"CUDA {name}: operand {i} is a "
                            f"{type(x).__name__}, not a tensor")
        if x.dtype != torch.int64:
            raise TypeError(f"CUDA {name} kernel takes int64 tensors: "
                            f"operand {i} is {x.dtype}")
    devices = {x.get_device() for x in tensors}
    if len(devices) != 1 or min(devices) < 0 or not tensors[0].is_cuda:
        raise ValueError(f"CUDA {name} kernel given tensors on "
                         f"{sorted({str(x.device) for x in tensors})}")
    return devices.pop()


def _arrays(sizes, strides):
    flat = [s for st in strides for s in st]
    return ((ctypes.c_int64 * len(sizes))(*sizes),
            (ctypes.c_int64 * len(flat))(*flat))


def _cache(key, plan: _Launch) -> _Launch:
    if len(_PLANS) >= MAX_PLANS:
        _PLANS.clear()
    _PLANS[key] = plan
    return plan


def _map_launch(op: str, operands, perm, nconst: int) -> _Launch:
    tensors = list(operands) + ([] if perm is None else [perm])
    device = _validate(op, tensors)
    out_shape, sizes, strides = map_plan(
        [x.shape for x in operands], [x.stride() for x in operands],
        keep_last=perm is not None)
    if perm is not None:
        n = out_shape[-1] if out_shape else 1
        if perm.dim() != 1 or perm.shape[0] != n or perm.stride(0) != 1 \
                or operands[0].dim() == 0 or operands[0].shape[-1] != n:
            raise ValueError(f"a permutation of the last dimension ({n}) of "
                             f"the first operand, got {tuple(perm.shape)} for "
                             f"{tuple(operands[0].shape)}")
    return _Launch(out_shape, device, len(sizes), *_arrays(sizes, strides),
                   empty=math.prod(out_shape) == 0,
                   consts=tuple(operands[len(operands) - nconst:]))


def rns_map(op: str, *operands: torch.Tensor,
            perm: torch.Tensor | None = None) -> torch.Tensor:
    """K9: the primitive `op` (a key of OPS) of ``ckks.modmath`` over
    int64 CUDA tensors that broadcast against each other, in its plain
    version's operand order; with `perm` (int64 [N], contiguous) operand
    0 is read at column perm[n] for column n of its last dimension."""
    code, arity = OPS[op]
    if len(operands) != arity:
        raise TypeError(f"{op} takes {arity} operands, got {len(operands)}")
    nconst = CONSTANTS[op]
    try:
        key = _key((code, perm is not None),
                   operands[:arity - nconst] + (() if perm is None
                                                 else (perm,)),
                   operands[arity - nconst:])
    except AttributeError:
        _validate(op, operands)     # names the operand that is no tensor
        raise
    plan = _PLANS.get(key)
    if plan is None:
        plan = _cache(key, _map_launch(op, operands, perm, nconst))
    out = torch.empty(plan.out_shape, dtype=torch.int64, device=plan.device)
    if plan.empty:
        return out
    lib = library()
    rc = launch_on(lib.hectr_rns_map, plan.device, code, plan.ndim, arity,
               plan.sizes, plan.strides,
               *[x.data_ptr() for x in operands], *[None] * (6 - arity),
               out.data_ptr(), None if perm is None else perm.data_ptr())
    raise_on(lib, rc, "rns_map")
    LAUNCHES["rns_map"] += 1
    OP_LAUNCHES[op] += 1
    return out


def _sum_launch(operands, dim: int) -> _Launch:
    device = _validate("mod_product_sum", operands)
    out_shape, red_size, red_strides, sizes, strides = reduce_plan(
        [x.shape for x in operands], [x.stride() for x in operands], dim)
    return _Launch(out_shape, device, len(sizes), *_arrays(sizes, strides),
                   empty=math.prod(out_shape) == 0, consts=operands[2:],
                   red_size=red_size,
                   red_strides=(ctypes.c_int64 * 5)(*red_strides))


def mod_product_sum(C: torch.Tensor, w: torch.Tensor, dim: int,
                    p: torch.Tensor, mu: torch.Tensor, k: torch.Tensor
                    ) -> torch.Tensor:
    """K10: sum over `dim` of mul_mod(C, w), reduced once more by Barrett,
    for int64 CUDA tensors that broadcast against each other; p, mu, k
    (the per-row Barrett constants) must not vary along `dim`."""
    operands = (C, w, p, mu, k)
    try:
        key = _key(("sum", dim), (C, w), (p, mu, k))
    except AttributeError:
        _validate("mod_product_sum", operands)
        raise
    plan = _PLANS.get(key)
    if plan is None:
        plan = _cache(key, _sum_launch(operands, dim))
    out = torch.empty(plan.out_shape, dtype=torch.int64, device=plan.device)
    if plan.empty:
        return out
    lib = library()
    rc = launch_on(lib.hectr_mod_product_sum, plan.device, plan.ndim, plan.sizes,
               plan.strides, plan.red_strides, plan.red_size,
               *[x.data_ptr() for x in operands], out.data_ptr())
    raise_on(lib, rc, "mod_product_sum")
    LAUNCHES["mod_product_sum"] += 1
    return out
