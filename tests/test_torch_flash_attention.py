"""Parity of the port's FlashAttention-2 module with the JAX reference.

The plain versions of the three FA2 kernels (forward, dQ, dK/dV) and
the ``FlashAttention`` autograd function that binds them are held, on
seeded numpy inputs, against the reference's Pallas kernels run in
interpret mode (one small case, as ``tests/test_kernels.py`` runs them
on the CPU) and against its XLA path ``_sdpa_reference_with_lse`` under
``jax.vjp``: grouped heads G in {1, 2, 4}, causal and not, a ragged S
and a cotangent on the log-sum-exp. The CUDA kernels run only on the
card, where ``chip_smoke.py`` compiles them and holds them against
these plain versions; here the wrappers' CPU dispatch, the route each
input type takes on CUDA (the C call stubbed), argument checks and C
interfaces are checked.

Tolerances: fp32, the same function with sums in other orders, the
scale multiplied (kernels) or divided (reference) and an online softmax
against a one-pass one: 2e-6 on outputs and gradients of order 1.
Torch, the port and JAX are imported inside fixtures and tests.
"""

import re
import types

import numpy as np
import pytest

TOL = 2e-6


@pytest.fixture(scope="module")
def m():
    import jax
    import jax.numpy as jnp
    import torch
    from paddle_tpu.kernels import flash_attention as jfa
    from paddle_tpu_torch.kernels import flash_attention as fa
    return types.SimpleNamespace(jax=jax, jnp=jnp, torch=torch, jfa=jfa,
                                 fa=fa)


def _inputs(B, S, H, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)  # noqa: E731
    return (f(B, S, H, D), f(B, S, Hkv, D), f(B, S, Hkv, D),
            f(B, S, H, D) * 2, f(B * H, 1, S))


def _port(m, q, k, v, g_out, g_lse, causal):
    """(out, lse, dq, dk, dv) of the port's FlashAttention on the CPU."""
    t = [m.torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, lse = m.fa.flash_attention_with_lse(*t, causal)
    loss = (out * m.torch.from_numpy(g_out)).sum() \
        + (lse * m.torch.from_numpy(g_lse)).sum()
    grads = m.torch.autograd.grad(loss, t)
    return [a.detach().numpy() for a in (out, lse, *grads)]


def _jax(m, fn, q, k, v, g_out, g_lse):
    """(out, lse, dq, dk, dv) of a JAX (out, lse) function by jax.vjp,
    jitted (one compile costs a tenth of op-by-op dispatch here)."""
    def run(q, k, v, g_out, g_lse):
        res, vjp = m.jax.vjp(fn, q, k, v)
        return (*res, *vjp((g_out, g_lse)))
    return [np.asarray(a) for a in m.jax.jit(run)(
        *(m.jnp.asarray(a) for a in (q, k, v, g_out, g_lse)))]


def _close(got, want, names=("out", "lse", "dq", "dk", "dv")):
    for g, w, n in zip(got, want, names):
        assert g.shape == w.shape, n
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=n)


def test_matches_interpret_mode_kernels(m):
    """The reference's Pallas forward, dQ and dK/dV kernels in interpret
    mode (S = 128, D = 32, G = 2, causal), an lse cotangent included."""
    q, k, v, g_out, g_lse = _inputs(1, 128, 4, 2, 32, seed=0)
    fn = lambda q, k, v: m.jfa.flash_attention_with_lse(  # noqa: E731
        q, k, v, True, True)
    _close(_port(m, q, k, v, g_out, g_lse, True),
           _jax(m, fn, q, k, v, g_out, g_lse))


@pytest.mark.parametrize("G,causal,S", [(1, True, 64), (2, False, 64),
                                        (4, True, 77), (2, True, 100)])
def test_matches_xla_reference_and_its_vjp(m, G, causal, S):
    """Against ``_sdpa_reference_with_lse`` and ``jax.vjp``; S = 77 and
    100 are ragged against the kernels' 64- and 32-key blocks."""
    q, k, v, g_out, g_lse = _inputs(2, S, 2 * G, 2, 16, seed=S + G)
    fn = lambda q, k, v: m.jfa._sdpa_reference_with_lse(  # noqa: E731
        q, k, v, causal)
    want = _jax(m, fn, q, k, v, g_out, g_lse)
    _close(_port(m, q, k, v, g_out, g_lse, causal), want)
    # the port's own copy of the XLA path, and the plain forward alone
    t = [m.torch.from_numpy(a) for a in (q, k, v)]
    _close(m.fa.sdpa_reference_with_lse(*t, causal), want[:2])
    _close([m.fa.sdpa_reference(*t, causal)], want[:1])
    out = m.jfa._sdpa_reference(*(m.jnp.asarray(a) for a in (q, k, v)),
                                causal)
    _close([m.fa.flash_attention_fwd(*t, causal)], [np.asarray(out)])


def test_out_only_and_bf16_roundings(m):
    """``flash_attention`` (no lse cotangent) against the reference's
    vjp; in bf16 the plain forward rounds P to v's type before P.V as
    the kernels do, which moves it from the fp32 result by bf16's
    rounding only."""
    torch = m.torch
    q, k, v, g_out, _ = _inputs(1, 40, 4, 1, 32, seed=9)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = m.fa.flash_attention(*t, True)
    grads = torch.autograd.grad((out * torch.from_numpy(g_out)).sum(), t)
    fn = lambda q, k, v: (m.jfa._sdpa_reference(q, k, v, True),  # noqa
                          m.jnp.zeros((4, 1, 40)))
    want = _jax(m, fn, q, k, v, g_out, np.zeros((4, 1, 40), np.float32))
    _close([a.detach().numpy() for a in (out, *grads)],
           [want[0], *want[2:]], names=("out", "dq", "dk", "dv"))
    b16 = [a.detach().bfloat16() for a in t]
    o16, l16 = m.fa.flash_fwd_reference(*b16, True)
    assert o16.dtype == torch.bfloat16 and l16.dtype == torch.float32
    o32, _ = m.fa.flash_fwd_reference(*(a.float() for a in b16), True)
    assert float((o16.float() - o32).abs().max()) < 2e-2
    dq, dk, dv = m.fa.flash_bwd_reference(
        *b16, o16, l16, torch.from_numpy(g_out).bfloat16(), True)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3


def test_gradcheck_float64(m):
    """torch.autograd.gradcheck of the plain path (both outputs) in
    float64 on a tiny causal grouped shape."""
    torch = m.torch
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 9, h, 16, generator=g, dtype=torch.float64,
                           requires_grad=True) for h in (2, 1, 1))
    assert torch.autograd.gradcheck(
        lambda q, k, v: m.fa.flash_attention_with_lse(q, k, v, True),
        (q, k, v))


def test_wrapper_checks_and_dispatch(m):
    torch, fa = m.torch, m.fa
    q = torch.zeros(1, 8, 4, 32)
    kv = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention(q, kv.to("meta"), kv)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(torch.zeros(1, 8, 4, 24), torch.zeros(1, 8, 2, 24),
                           torch.zeros(1, 8, 2, 24))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, torch.zeros(1, 8, 3, 32),
                           torch.zeros(1, 8, 3, 32))
    with pytest.raises(ValueError, match="share a type"):
        fa.flash_attention(q, kv.double(), kv)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))
    fa.launch_counts.clear()
    fa.flash_attention(q, kv, kv, True)
    assert not fa.launch_counts         # the CPU runs no kernel


@pytest.mark.parametrize("dtype,code,fwd,dq,dkv", [
    ("bfloat16", 2, "flash_fwd_mma", "flash_dq_mma", "flash_dkv_mma"),
    ("float16", 1, "flash_fwd_mma", "flash_dq_mma", "flash_dkv_mma"),
    ("float32", 0, "flash_fwd", "flash_dq", "flash_dkv")])
def test_cuda_route_by_dtype(m, monkeypatch, dtype, code, fwd, dq, dkv):
    """The C entry each kernel calls on CUDA: bf16 and fp16 take the
    tensor-core forward, dQ and dK/dV, fp32 the CUDA-core ones. The
    library and the C call are stubbed, so nothing is built or launched;
    the counts record kernel and route."""
    torch, fa = m.torch, m.fa
    lib = types.SimpleNamespace(**{n: n for n in fa._ENTRY.values()})
    calls = []
    monkeypatch.setattr(fa._build, "load", lambda name, bind: lib)
    monkeypatch.setattr(fa, "_call", lambda fn, args, device:
                        calls.append((fn, args)) or 0)
    dt = getattr(torch, dtype)
    q, kv = torch.zeros(2, 8, 4, 32, dtype=dt), torch.zeros(2, 8, 2, 32,
                                                            dtype=dt)
    fa.launch_counts.clear()
    fa.route_counts.clear()
    out, lse = fa._fwd_kernel(q, kv, kv, True)
    fa._bwd_kernels(q, kv, kv, out, lse, q, True, None)
    assert [fn for fn, _ in calls] == [fwd, dq, dkv]
    for (_, args), n_ptrs in zip(calls, (5, 7, 8)):
        assert args[n_ptrs:] == (2, 8, 4, 2, 32, code, 1, 1 / 32 ** 0.5)
    way = fa.route("flash_fwd", dt)
    assert way == ("cuda_core" if dtype == "float32" else "tensor_core")
    assert fa.launch_counts == {"flash_fwd": 1, "flash_dq": 1,
                                "flash_dkv": 1}
    assert fa.route_counts == {f"flash_fwd/{way}": 1,
                               f"flash_dq/{way}": 1,
                               f"flash_dkv/{way}": 1}
    # the tensor-core kernels copy 16-byte chunks: a misaligned view
    # raises there and passes on the CUDA-core route
    skew = torch.zeros(q.numel() + 1, dtype=dt)[1:].view(q.shape)
    if way == "tensor_core":
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa._fwd_kernel(skew, kv, kv, True)
    else:
        fa._fwd_kernel(skew, kv, kv, True)


def test_c_interfaces(m, monkeypatch):
    """The exported C functions take as many arguments as their ctypes
    bindings declare, and the sources build with the others' command."""
    from paddle_tpu_torch.kernels import _build
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                   for n in m.fa._ENTRY.values()})
    m.fa._bind_fwd(lib)
    m.fa._bind_bwd(lib)
    for src, fn, n in (("flash_fwd", "flash_fwd", 14),
                       ("flash_fwd", "flash_fwd_mma", 14),
                       ("flash_bwd", "flash_dq", 16),
                       ("flash_bwd", "flash_dq_mma", 16),
                       ("flash_bwd", "flash_dkv", 17),
                       ("flash_bwd", "flash_dkv_mma", 17)):
        text = (_build.CSRC / f"{src}.cu").read_text()
        found = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text)
        assert found, fn
        assert len(found.group(1).split(",")) == n \
            == len(getattr(lib, fn).argtypes), fn
        assert "sm_90a" in text and "_flash_" in text
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.nvcc_command("flash_bwd", _build.library_path("flash_bwd"))
    assert cmd[-1].endswith("csrc/flash_bwd.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd
