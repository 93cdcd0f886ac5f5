"""The multiply-ceiling probe (K3's plain version and its bench module) held
against the JAX package's lazy Shoup multiply and the JAX script's
inputs.

The plain int64 chain must equal a chain of ``mul_mod_shoup_u32_lazy``
bit for bit (the lazy result in [0, 2p) is fixed by the exact high
product), and reduced mod p it must equal x * w^R mod p.  The CUDA
kernel itself is held to the plain chain on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectr_tpu.ckks.modmath import mul_mod_shoup_u32_lazy
from hectr_tpu.ckks.primes import find_ntt_primes as jfind_ntt_primes
from hectr_tpu_torch.bench import vpu_ceiling as V
from hectr_tpu_torch.ckks.modmath import mul_mod_shoup_lazy
from hectr_tpu_torch.ops import mulmod_cuda

torch.set_num_threads(1)

ROWS, R = 64, 16


def jax_chain(x0, c, r):
    """r chained mul_mod_shoup_u32_lazy on uint32, as the TPU kernel's
    loop body does."""
    as_u32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))  # noqa: E731
    w, wsh, p = as_u32(c.w), as_u32(c.w_shoup), as_u32(c.pv)
    f = jax.jit(lambda x: jax.lax.fori_loop(
        0, r, lambda i, v: mul_mod_shoup_u32_lazy(v, w, wsh, p), x))
    return np.asarray(f(as_u32(x0)))


def test_probe_inputs_are_the_jax_scripts():
    """scripts/bench_vpu_ceiling.py:52-59: the same prime, multipliers,
    Shoup companions and block, drawn in the same order."""
    x0, c = V.probe_inputs(torch.device("cpu"))
    p = jfind_ntt_primes(30, 1, 2 * (1 << 15))[0]
    rng = np.random.default_rng(0)
    w = rng.integers(1, p, size=(1, V.LANES), dtype=np.uint64)
    wsh = ((w.astype(object) << 32) // p % (1 << 32)).astype(np.uint32)
    want_x0 = rng.integers(0, p, size=(V.ROWS, V.LANES), dtype=np.uint64)
    assert c.p == p and x0.shape == (4096, 128)
    assert np.array_equal(x0.numpy(), want_x0.astype(np.int64))
    assert np.array_equal(c.w.numpy(), w[0].astype(np.int64))
    assert np.array_equal(c.w_shoup.numpy(), wsh[0].astype(np.int64))
    # the kernel's int32 views carry the same 32-bit patterns
    assert np.array_equal(c.w_shoup32.numpy().view(np.uint32), wsh[0])
    assert np.array_equal(c.p32.numpy().view(np.uint32),
                          np.full(V.LANES, p, dtype=np.uint32))


def test_lazy_chain_bit_equal_jax_and_pow_identity():
    x0, c = V.probe_inputs(torch.device("cpu"), rows=ROWS)
    got = V.chain_plain(x0, c, R)
    want = jax_chain(x0, c, R)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert bool((got < 2 * c.p).all()) and bool((got >= c.p).any())  # lazy
    assert V.pow_probe_ok(x0, got, c, R)
    assert not V.pow_probe_ok(x0, got, c, R + 1)
    # the dispatching chain takes the plain version for a CPU tensor and
    # launches nothing; CALLS chained calls compose
    before = dict(mulmod_cuda.LAUNCHES)
    out = V.dispatch(x0, c, r=R // 4, calls=4)
    assert torch.equal(out, got) and mulmod_cuda.LAUNCHES == before


def test_lazy_multiply_edges_match_jax():
    """Inputs across the lazy domain, 0 to 2^31 - 1."""
    _, c = V.probe_inputs(torch.device("cpu"), rows=1)
    p = c.p
    a = np.array([[0, 1, p - 1, p, 2 * p - 1, 2**31 - 1]], dtype=np.int64).T
    a = np.broadcast_to(a, (6, V.LANES)).copy()
    got = mul_mod_shoup_lazy(torch.from_numpy(a), c.w, c.w_shoup, c.pv)
    want = mul_mod_shoup_u32_lazy(
        *(jnp.asarray(np.asarray(v).astype(np.uint32))
          for v in (a, c.w, c.w_shoup, c.pv)))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert np.array_equal(got.numpy() % p,
                          (a.astype(object) * c.w.numpy().astype(object)) % p)


# The loop region of the kernel as `cuobjdump -sass` listed it for sm_90a
# (encodings dropped): an 8-way unrolled main loop and a remainder loop.
SASS = """
		Function : _ZN48_GLOBAL__N__43603568_15_mulmod_chain_cu_0a2d9fcb19mulmod_chain_kernelEPKlPlPKjS4_S4_lii
        /*0390*/              @!P0 BRA 0x650 ;
        /*03a0*/                   LDG.E.CONSTANT R3, desc[UR6][R8.64] ;
        /*0410*/              @!P0 BRA 0x5e0 ;
        /*0420*/                   IMAD.IADD R7, R15, 0x1, -R6 ;
        /*0430*/                   IMAD.HI.U32 R8, R14, R4, RZ ;
        /*0440*/                   IADD3 R7, R7, -0x8, RZ ;
        /*0450*/                   IMAD R8, R5, R8, RZ ;
        /*0460*/                   ISETP.NE.AND P0, PT, R7, RZ, PT ;
        /*0470*/                   IMAD R8, R3, R14, -R8 ;
""" + "".join(
    f"        /*{a:04x}*/                   IMAD.HI.U32 R10, R8, R4, RZ ;\n"
    f"        /*{a + 16:04x}*/                   IMAD R10, R5, R10, RZ ;\n"
    f"        /*{a + 32:04x}*/                   IMAD R10, R3, R8, -R10 ;\n"
    for a in range(0x480, 0x5d0, 0x30)) + """\
        /*05d0*/               @P0 BRA 0x430 ;
        /*05e0*/              @!P1 BRA 0x650 ;
        /*05f0*/                   VIADD R6, R6, 0xffffffff ;
        /*0600*/                   IMAD.HI.U32 R8, R14, R4, RZ ;
        /*0610*/                   ISETP.NE.AND P0, PT, R6, RZ, PT ;
        /*0620*/                   IMAD R8, R5, R8, RZ ;
        /*0630*/                   IMAD R14, R3, R14, -R8 ;
        /*0640*/               @P0 BRA 0x5f0 ;
        /*0650*/                   EXIT ;
        /*0660*/                   BRA 0x660;
		Function : _ZN12_GLOBAL__N_114ntt_fwd_kernelEPKlPlPKjS4_S4_ii
        /*0000*/                   EXIT ;
"""


@pytest.mark.parametrize("labels", [False, True], ids=["hex", "labels"])
def test_sass_loop_body(labels):
    """The hottest loop is the 8-way unrolled one: 8 high products, 16
    multiply-adds and 3 loop-control instructions.  Older cuobjdump
    prints branch targets as labels instead of addresses."""
    sass = SASS
    if labels:
        sass = (sass.replace("BRA 0x430", "BRA `(.L_x_1)")
                .replace("        /*0430*/", ".L_x_1:\n        /*0430*/"))
    got = V.sass_loop_body(sass, "mulmod_chain_kernel")
    assert got["multiplies"] == 8 and got["body_instructions"] == 27
    assert got["per_multiply"] == 27 / 8
    assert got["opcodes"] == {"IMAD.HI.U32": 8, "IADD3": 1, "IMAD": 16,
                              "ISETP.NE.AND": 1, "BRA": 1}
    with pytest.raises(ValueError, match="no loop"):
        V.sass_loop_body(sass, "ntt_fwd_kernel")
    with pytest.raises(ValueError, match="no function"):
        V.sass_loop_body(sass, "absent_kernel")


def test_ntt_share_counts_the_port_kernels_multiplies():
    rate, share = V.ntt_share(0.25, 1e12)
    assert rate == 264 * 15 * 2**14 / 0.25e-3
    assert share == rate / 1e12


def test_kernel_wrapper_refuses_cpu_tensors():
    x0, c = V.probe_inputs(torch.device("cpu"), rows=4)
    with pytest.raises(ValueError, match="tensor on cpu"):
        mulmod_cuda.mulmod_chain_cuda(x0, c.w32, c.w_shoup32, c.p32, 2)
