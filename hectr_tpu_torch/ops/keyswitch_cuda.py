"""PyTorch wrappers of the hand-written CUDA kernels for the fused passes of
hybrid key switching (csrc/keyswitch.cu).

  * K6 ``base_convert_cuda``: RNS base conversion, the grouped form of the
    digit decomposition (ModUp) and the one-group form of the mod-down, in
    one launch.  Replaces the XLA-fused ``grouped_convert`` /
    ``base_convert`` of the JAX package (``hectr_tpu/ckks/basecvt.py:134``,
    ``:157``); computes what ``ckks.basecvt.grouped_convert`` and
    ``base_convert`` compute.
  * K7 ``key_inner_product_cuda``: sum_j digits[j] * key[j] over the
    extended modulus, in either key layout, optionally reading the digits
    through a Galois permutation.  Replaces ``_inner_product``
    (``hectr_tpu/ckks/keyswitch.py:281``); computes what
    ``ckks.keyswitch.key_inner_product`` computes.
  * K8 ``mod_down_tail_cuda``: (acc - ext) * P^-1 mod p, the tail of
    ``_mod_down_special`` (``hectr_tpu/ckks/keyswitch.py:302``); computes
    what ``ckks.keyswitch.mod_down_tail`` computes.

All three are bound by device memory (the source note in
csrc/keyswitch.cu has the design; ``bench.keyswitch_bound`` the bound).
The kernels are compiled from the repository's source with nvcc at first
use (``hectr_tpu_torch.ops.build``) and bound through a plain C interface
with ctypes; nothing here touches CUDA or nvcc at import time.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel,
and nowhere else, and one to ``LAUNCH_SHAPES`` under a key from which
``bench.keyswitch_launch_work`` prices the launch: ("base_convert", input
shape as [..., G, A, C] (G = 1 for the one-group form), targets),
("key_inner_product", digits shape, key shape, permuted) and
("mod_down_tail", input shape).  Each raises on a tensor off the card, of
another dtype than int64, or of a shape the kernel does not take.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from hectr_tpu_torch.ops import launches
from hectr_tpu_torch.ops.build import load, raise_on

MAX_GROUP = 4            # rows of one conversion group (the kernel's A)
MAX_LEAD_TILES = 65535   # K7's grid rows: tiles of 8 leading rows

LAUNCHES = launches.register({"base_convert": 0, "key_inner_product": 0,
                               "mod_down_tail": 0})
LAUNCH_SHAPES: collections.Counter = launches.register(
    collections.Counter())
reset_launches = launches.resetter(LAUNCHES, LAUNCH_SHAPES)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    lib = load("keyswitch.cu")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.hectr_base_convert.argtypes = [ptr] * 10 + [i64, i32, i32, i32, i64,
                                                    ptr]
    lib.hectr_base_convert.restype = i32
    lib.hectr_key_inner_product.argtypes = [ptr] * 5 + [i64, i32, i32, i64,
                                                        i32, ptr]
    lib.hectr_key_inner_product.restype = i32
    lib.hectr_mod_down_tail.argtypes = [ptr, i64] + [ptr] * 5 + [i64, i32,
                                                                 i64, ptr]
    lib.hectr_mod_down_tail.restype = i32
    return lib


def _int64(name: str, **tensors: torch.Tensor) -> None:
    for what, x in tensors.items():
        if x.dtype != torch.int64:
            raise TypeError(f"CUDA {name} kernel takes int64 tensors: {what} "
                            f"is {x.dtype}")


def _dense(name: str, **tensors: torch.Tensor) -> None:
    for what, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"CUDA {name} kernel takes a contiguous {what}")


def _columns(name: str, rows: int, **tensors: torch.Tensor) -> None:
    """Per-row constants: `rows` values each, contiguous."""
    _dense(name, **tensors)
    for what, x in tensors.items():
        if x.numel() != rows:
            raise ValueError(f"CUDA {name} kernel: {what} of {rows} values "
                             f"expected, got {tuple(x.shape)}")


def _on_card(name: str, **tensors: torch.Tensor) -> torch.device:
    """The one CUDA device every tensor lies on, or raise."""
    devices = {x.device for x in tensors.values()}
    device = next(iter(devices))
    if len(devices) > 1 or device.type != "cuda":
        raise ValueError(f"CUDA {name} kernel given tensors on "
                         f"{sorted(map(str, devices))}")
    return device


def _launch(name: str, lib, rc: int, *key) -> None:
    raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, *key)] += 1


def base_convert_cuda(x: torch.Tensor, c, grouped: bool) -> torch.Tensor:
    """K6.  grouped: x int64 [..., dnum, alpha, C] canonical residues of the
    digit groups of ``c`` (a ``GroupedConvConstants``; dummy rows zero) ->
    [..., dnum, t, C]; else x [..., g, C] over the source primes of ``c``
    (a ``BaseConvConstants``) -> [..., t, C].  Any column count C."""
    name = "base_convert"
    consts = {"inv": c.inv, "inv_shoup": c.inv_shoup, "q": c.q_col, "M": c.M,
              "M_shoup": c.M_shoup, "Qmod": c.Qmod,
              "Qmod_shoup": c.Qmod_shoup, "p": c.p}
    _int64(name, x=x, **consts)
    _dense(name, x=x)
    G, A = (c.dnum, c.alpha) if grouped else (1, c.g)
    want = (G, A) if grouped else (A,)
    if x.dim() < len(want) + 1 or tuple(x.shape[-1 - len(want):-1]) != want:
        raise ValueError(f"base conversion of {want} rows, got "
                         f"{tuple(x.shape)}")
    if not 1 <= A <= MAX_GROUP:
        raise ValueError(f"groups of {A} rows; the kernel takes 1-{MAX_GROUP}")
    C = x.shape[-1]
    lead = math.prod(x.shape[:-1 - len(want)])
    if lead * C == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    T = c.t
    _columns(name, G * A, **{k: consts[k] for k in ("inv", "inv_shoup", "q")})
    _columns(name, G * A * T, M=c.M, M_shoup=c.M_shoup)
    _columns(name, G * T, Qmod=c.Qmod, Qmod_shoup=c.Qmod_shoup)
    _columns(name, T, p=c.p)
    device = _on_card(name, x=x, **consts)
    out = x.new_empty((*x.shape[:-1 - len(want)], *want[:-1], T, C))
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hectr_base_convert(x.data_ptr(), out.data_ptr(),
                                    *(t.data_ptr() for t in consts.values()),
                                    lead, G, A, T, C, stream)
    _launch(name, lib, rc, (*x.shape[:-1 - len(want)], G, A, C), T)
    return out


def key_inner_product_cuda(digits: torch.Tensor, ksk_l: torch.Tensor,
                           p: torch.Tensor, perm: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """K7: digits int64 [..., dnum, R, C], key [dnum, 4, R, C] (Shoup
    companions stored) or [dnum, 2, R, C] (compact), p the R primes ->
    [..., 2, R, C].  With `perm` (int64 [C], a permutation of the columns)
    digit column perm[n] stands in for column n."""
    name = "key_inner_product"
    tensors = {"digits": digits, "key": ksk_l, "p": p}
    if perm is not None:
        tensors["perm"] = perm
    _int64(name, **tensors)
    _dense(name, digits=digits, key=ksk_l)
    if ksk_l.dim() != 4 or ksk_l.shape[1] not in (2, 4):
        raise ValueError(f"key [dnum, 4 or 2, R, C], got {tuple(ksk_l.shape)}")
    dnum, _, R, C = ksk_l.shape
    if digits.dim() < 3 or tuple(digits.shape[-3:]) != (dnum, R, C):
        raise ValueError(f"digits [..., {dnum}, {R}, {C}] for the key "
                         f"{tuple(ksk_l.shape)}, got {tuple(digits.shape)}")
    lead = math.prod(digits.shape[:-3])
    if lead * dnum * R * C == 0:
        raise ValueError(f"empty input {tuple(digits.shape)}")
    if -(-lead // 8) > MAX_LEAD_TILES:
        raise ValueError(f"{lead} leading rows: at most {8 * MAX_LEAD_TILES}")
    _columns(name, R, p=p)
    if perm is not None:
        _columns(name, C, perm=perm)
    device = _on_card(name, **tensors)
    out = digits.new_empty((*digits.shape[:-3], 2, R, C))
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hectr_key_inner_product(
            digits.data_ptr(), ksk_l.data_ptr(),
            None if perm is None else perm.data_ptr(), out.data_ptr(),
            p.data_ptr(), lead, dnum, R, C, int(ksk_l.shape[1] == 4), stream)
    _launch(name, lib, rc, tuple(digits.shape), tuple(ksk_l.shape),
            perm is not None)
    return out


def lead_stride(x: torch.Tensor) -> int | None:
    """The stride of x's leading dims flattened into one, for x [..., R, C]
    whose last two dims are dense (the first R rows of a wider tensor
    qualify); None where they do not flatten to one stride."""
    R, C = x.shape[-2:]
    if (x.stride(-1) != 1 and C > 1) or (x.stride(-2) != C and R > 1):
        return None
    stride, span = R * C, None
    for size, st in zip(reversed(x.shape[:-2]), reversed(x.stride()[:-2])):
        if size == 1:
            continue
        if span is None:
            stride, span = st, st * size
        elif st != span:
            return None
        else:
            span *= size
    return stride


def mod_down_tail_cuda(acc_k: torch.Tensor, ext: torch.Tensor,
                       pinv: torch.Tensor, pinv_sh: torch.Tensor,
                       p: torch.Tensor) -> torch.Tensor:
    """K8: (acc_k - ext) * P^-1 mod p over [..., R, C]: acc_k may be the
    first R rows of a wider tensor (``lead_stride``), ext contiguous;
    pinv, its Shoup companion and p hold R values each."""
    name = "mod_down_tail"
    tensors = {"acc": acc_k, "ext": ext, "pinv": pinv, "pinv_sh": pinv_sh,
               "p": p}
    _int64(name, **tensors)
    _dense(name, ext=ext)
    if acc_k.dim() < 2 or acc_k.shape != ext.shape:
        raise ValueError(f"acc {tuple(acc_k.shape)} and ext "
                         f"{tuple(ext.shape)} differ")
    R, C = acc_k.shape[-2:]
    lead = math.prod(acc_k.shape[:-2])
    if lead * R * C == 0:
        raise ValueError(f"empty input {tuple(acc_k.shape)}")
    _columns(name, R, pinv=pinv, pinv_sh=pinv_sh, p=p)
    stride = lead_stride(acc_k)
    if stride is None:
        raise ValueError(f"acc of strides {acc_k.stride()}: its leading "
                         f"dims do not flatten to one stride")
    device = _on_card(name, **tensors)
    out = ext.new_empty(ext.shape)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hectr_mod_down_tail(acc_k.data_ptr(), stride, ext.data_ptr(),
                                     pinv.data_ptr(), pinv_sh.data_ptr(),
                                     p.data_ptr(), out.data_ptr(), lead, R, C,
                                     stream)
    _launch(name, lib, rc, tuple(acc_k.shape))
    return out
