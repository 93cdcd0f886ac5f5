"""PyTorch wrapper of the hand-written CUDA kernel for the CSTR closed
loop's own stages (csrc/loop_stages.cu).

K13 ``loop_stages``: one step of everything of a loop step but the
regulator, for the CSTR plant, every plant row of a batch in one launch:
the plant's two linearly-implicit substeps (``control.stages.actuate``
with ``plants.cstr``'s right-hand side and Jacobian, solved by
``control.ode.solve_pivoted``'s pivot rule), the estimator's time update
and, where asked, the next step's measurement update and target
selector; or that last part alone (an episode's first step).  It
computes what ``control.simulate.Stages.step`` and ``.observe`` compute,
which are its plain version; the source note in csrc/loop_stages.cu
gives the design and what bounds it.

``pack`` lays a ``Stages``' constants (the model's matrices, the
estimator's and selector's gains, the steady state) with the CSTR's
scalars (``plants.cstr.cstr_scalars``) and dt / 2 into one float64
buffer of WORDS words on the ``Stages``' device, once.  ``loop_stages``
checks its operands (each one's dtype, shape and strides, then their
device) and raises on anything the kernel does not take, before the
library is built; it reads each operand where it lies, its rows at one
stride, allocates one [*lead, 11 + nd] output and launches.  The kernel
is compiled from the repository's source with nvcc at first use
(``ops.build``) and bound through a plain C interface with ctypes;
nothing here touches CUDA or nvcc at import time.  The wrapper adds one to ``LAUNCHES["loop_stages"]`` where it launches the
kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from hectr_tpu_torch.ops import launches
from hectr_tpu_torch.ops.build import launch_on, load, raise_on

NX, NU, NP = 3, 2, 1        # the CSTR's states, moves and disturbance
MAX_OUT = 3                 # outputs ny and disturbances nd the kernel takes
ROW = 3                     # words a matrix row, Ginv's aside
# offset of each constant in the buffer (csrc/loop_stages.cu kA ... kPlant)
LAYOUT = {"A": 0, "B": 9, "C": 18, "Bd": 27, "Cd": 36, "Hr": 45, "Lx": 51,
          "Ld": 60, "Ginv": 69, "xs": 94, "us": 97, "ps": 99, "plant": 100}
# the plant's scalars from LAYOUT["plant"] on, in the kernel's order, then
# the substep dt / 2 of ``stages.actuate``
PLANT = ("S", "inv_S", "heat", "cool", "K0", "E", "neg_E", "C0", "T0")
WORDS = 112
STEP, STEP_OBSERVE, OBSERVE = 0, 1, 2   # the kernel's modes

LAUNCHES = launches.register({"loop_stages": 0})
reset_launches = launches.resetter(LAUNCHES)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    lib = load("loop_stages.cu")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.hectr_loop_stages.argtypes = [ptr] * 7 + [i64] * 6 + [ptr, i64, i32,
                                                              i32, i32, ptr]
    lib.hectr_loop_stages.restype = i32
    return lib


@dataclasses.dataclass(frozen=True)
class Constants:
    """A ``Stages``' constants packed for K13: the buffer (float64
    [WORDS] on the stages' device), the outputs ny and disturbances nd."""

    buffer: torch.Tensor
    ny: int
    nd: int

    @property
    def widths(self) -> list[int]:
        """The output's parts a row: x, xhat, dhat, xr, ur."""
        return [NX, NX, self.nd, NX, NU]

    @property
    def width(self) -> int:
        """The output's words a row."""
        return 2 * NX + self.nd + NX + NU


def _shape(name: str, M, want: tuple) -> None:
    if M is None or tuple(M.shape) != want:
        got = None if M is None else tuple(M.shape)
        raise ValueError(f"CUDA loop stages take {name} of shape {want}, "
                         f"got {got}")
    if M.dtype != torch.float64:
        raise TypeError(f"CUDA loop stages take {name} as float64, got "
                        f"{M.dtype}")


def pack(stages, plant: dict[str, float]) -> Constants:
    """The constants of `stages` (a ``control.simulate.Stages`` of the CSTR
    plant) and the plant's scalars `plant` (``plants.cstr.cstr_scalars``,
    by the names of PLANT) as K13 reads them.  Raises where the model is
    not one the kernel takes: nx = 3, nu = 2, np = 1, ny and nd of 1..3
    and 0..3."""
    C, Bd = stages.C, stages.Bd
    ny = C.shape[0] if C.dim() == 2 else 0
    nd = Bd.shape[1] if Bd is not None and Bd.dim() == 2 else -1
    if not 1 <= ny <= MAX_OUT:
        raise ValueError(f"CUDA loop stages take 1 to {MAX_OUT} outputs, "
                         f"C has shape {tuple(C.shape)}")
    if not 0 <= nd <= MAX_OUT:
        got = None if Bd is None else tuple(Bd.shape)
        raise ValueError(f"CUDA loop stages take 0 to {MAX_OUT} disturbances"
                         f" in a [{NX}, nd] Bd, got {got}")
    shapes = {"A": (NX, NX), "B": (NX, NU), "C": (ny, NX), "Bd": (NX, nd),
              "Cd": (ny, nd), "Hr": (NU, ny), "Lx": (NX, ny), "Ld": (nd, ny),
              "Ginv": (NX + NU, NX + NU), "xs": (NX,), "us": (NU,),
              "ps": (NP,)}
    buf = torch.zeros(WORDS, dtype=torch.float64)
    for name, want in shapes.items():
        M = getattr(stages, name)
        _shape(name, M, want)
        off = LAYOUT[name]
        if M.dim() == 1:
            buf[off:off + M.numel()] = M.cpu()
        else:
            stride = NX + NU if name == "Ginv" else ROW
            rows = buf[off:off + want[0] * stride].view(want[0], stride)
            rows[:, :want[1]] = M.cpu()
    off = LAYOUT["plant"]
    buf[off:off + len(PLANT) + 1] = torch.tensor(
        [plant[k] for k in PLANT] + [stages.dt / 2], dtype=torch.float64)
    return Constants(buf.to(stages.xs.device), ny, nd)


def _row_stride(label: str, t: torch.Tensor, lead: tuple, width: int) -> int:
    """The one stride, in words, between the rows [*lead] of the float64 t
    [*lead, width] (0 for a single row, or a row t [width] broadcast over
    them); raises where t is no such tensor or its rows lie at several
    strides."""
    if t.dtype != torch.float64:
        raise TypeError(f"CUDA loop stages take {label} as float64, got "
                        f"{t.dtype}")
    shape, stride = t.shape, t.stride()
    if not shape or shape[-1] != width or (width > 1 and stride[-1] != 1):
        raise ValueError(f"CUDA loop stages take {label} as rows of {width} "
                         f"contiguous words, got shape {tuple(shape)}, "
                         f"strides {stride}")
    if len(shape) == 1:
        return 0
    if shape[:-1] != lead:
        raise ValueError(f"CUDA loop stages: {label} has rows "
                         f"{tuple(shape[:-1])}, x has {tuple(lead)}")
    dims = [(n, s) for n, s in zip(shape[:-1], stride[:-1]) if n != 1]
    for (_, outer), (n, inner) in zip(dims, dims[1:]):
        if outer != inner * n:
            raise ValueError(f"CUDA loop stages: {label}'s rows lie at "
                             f"several strides ({stride})")
    return dims[-1][1] if dims else 0


def loop_stages(consts: Constants, x: torch.Tensor, u, p, xhat: torch.Tensor,
                dhat: torch.Tensor, rsp: torch.Tensor, mode: int
                ) -> tuple[torch.Tensor, ...]:
    """K13 over the plant rows [*lead] of x [*lead, 3]: with mode STEP
    the plant under u [*lead, 2] and p [*lead, 1] (the new x alone is
    written); STEP_OBSERVE that, the time update of xhat [*lead, 3] and
    dhat [*lead, nd], then the next step's measurement update and selector
    against rsp [*lead, 2]; OBSERVE that last part alone on (x, xhat,
    dhat), the time update's, with u and p None.  Returns views of one new
    float64 [*lead, 11 + nd] output: (x, xhat, dhat, xr, ur)."""
    if mode not in (STEP, STEP_OBSERVE, OBSERVE):
        raise ValueError(f"CUDA loop stages: no mode {mode}")
    stepping = mode != OBSERVE
    observing = mode != STEP
    operands = [("x", x, NX),
                ("u", u if stepping else None, NU),
                ("p", p if stepping else None, NP),
                ("xhat", xhat if observing else None, NX),
                ("dhat", dhat if observing else None, consts.nd),
                ("rsp", rsp if observing else None, NU)]
    lead = x.shape[:-1]
    strides = [0 if t is None else _row_stride(label, t, lead, width)
               for label, t, width in operands]
    tensors = [t for _, t, _ in operands]
    device = consts.buffer.device
    given = [t for t in tensors if t is not None]
    if any(t.device != device for t in given):
        raise ValueError("CUDA loop stages given tensors on "
                         f"{sorted({str(t.device) for t in given})} and "
                         f"constants on {device}")
    out = torch.empty((*lead, consts.width), dtype=torch.float64,
                      device=device)
    rows = math.prod(lead)
    if rows:
        _launch(consts, out, tensors, strides, rows, mode)
    return out.split_with_sizes(consts.widths, dim=-1)


def _launch(consts: Constants, out: torch.Tensor, tensors: list,
            strides: list[int], rows: int, mode: int) -> None:
    """K13 on the checked operands (x, u, p, xhat, dhat, rsp; None where
    the mode reads none) into out; raises off a CUDA device."""
    if out.device.type != "cuda":
        raise ValueError(f"CUDA loop stages given tensors on {out.device}")
    lib = library()
    ptrs = [0 if t is None else t.data_ptr() for t in tensors]
    rc = launch_on(lib.hectr_loop_stages, out.device.index,
                   consts.buffer.data_ptr(), *ptrs, *strides, out.data_ptr(),
                   rows, consts.ny, consts.nd, mode)
    raise_on(lib, rc, "loop_stages")
    LAUNCHES["loop_stages"] += 1
