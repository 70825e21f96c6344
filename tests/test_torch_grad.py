"""Gradients of the ELL SpMV and residual wrappers (B3–B6): each call that
records an autograd node goes through an ``autograd.Function`` whose
backward is plain torch.  On the CPU the forward is the plain version, so
these tests hold the Functions' ``vals̄``, ``x̄`` and ``f̄`` against
``jax.grad`` of the JAX package's jnp ``ell`` SpMV and residual, run
``gradcheck`` in float64, check that no padding-slot gradient reaches
``CSR.vals`` through ``csr_to_ell``, and check that a call with nothing to
differentiate records no node.  The ``cuda`` twins run the same on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.core as jc  # noqa: E402  (x64 on)
from repro.core import sparse as jsparse, weakform as jwf  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

import repro_torch.core as tc  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import csr_to_ell  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    StreamPlan,
    ell_matvec,
    ell_matvec_stream,
    galerkin_residual_ell,
    galerkin_residual_ell_stream,
    spmv_ell,
    spmv_ell_stream,
)

# (N, L, block_n): ragged N against block_n and 32, L = 1, one block, several,
# rows past 32 slots
SHAPES = [(1, 1, 128), (37, 5, 16), (129, 15, 64), (300, 7, 128), (97, 45, 64)]
KINDS = ["spmv", "residual", "spmv_stream", "residual_stream"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ell_inputs(n, width, seed):
    """An ELL operator with padded rows (a zero value and the row's own
    column, as ``ell_layout`` builds them), x, f and a cotangent."""
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.integers(0, n, size=(n, width)), axis=1)
    vals = rng.normal(size=(n, width))
    pad = rng.uniform(size=(n, width)) < 0.3
    cols = np.where(pad, np.arange(n)[:, None], cols).astype(np.int32)
    vals = np.where(pad, 0.0, vals)
    x, f, w = (rng.normal(size=n) for _ in range(3))
    return vals, cols, x, f, w


def _torch_call(kind, cols, block_n):
    """The wrapper of ``kind`` as a function of (vals, x, f)."""
    plan = StreamPlan(cols, block_n)
    c = torch.as_tensor(cols)
    return {
        "spmv": lambda v, x, f: spmv_ell(v, c, x),
        "residual": lambda v, x, f: galerkin_residual_ell(v, c, x, f),
        "spmv_stream": lambda v, x, f: spmv_ell_stream(v, plan, x),
        "residual_stream": lambda v, x, f: galerkin_residual_ell_stream(v, plan, x, f),
    }[kind]


def _jax_grads(kind, vals, cols, x, f, w):
    """``jax.grad`` of Σ w·y through the reference's jnp ELL SpMV or
    residual (both plans compute the same y in global columns)."""
    residual = kind.startswith("residual")

    def loss(v, xx, ff):
        y = (jref.galerkin_residual_ell_ref(v, jnp.asarray(cols), xx, ff) if residual
             else jref.spmv_ell_ref(v, jnp.asarray(cols), xx))
        return jnp.sum(jnp.asarray(w) * y)

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (vals, x, f)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,width,block_n", SHAPES)
def test_function_grads_match_jax(kind, n, width, block_n):
    vals, cols, x, f, w = _ell_inputs(n, width, seed=n + width)
    call = _torch_call(kind, cols, block_n)
    tv, tx, tf = (torch.as_tensor(a).requires_grad_() for a in (vals, x, f))
    y = call(tv, tx, tf)
    assert type(y.grad_fn).__name__ == ("_StreamEllBackward" if kind.endswith("stream")
                                        else "_EllBackward")
    (torch.as_tensor(w) * y).sum().backward()
    jv, jx, jf = _jax_grads(kind, vals, cols, x, f, w)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jv), atol=1e-12, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), atol=1e-12, rtol=0)
    if kind.startswith("residual"):
        np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jf), atol=1e-12, rtol=0)
        np.testing.assert_array_equal(tf.grad.numpy(), -w)
    else:
        assert tf.grad is None
    # padded slots get ȳ[r]·x[r]: the Function does not hide them
    pad = (vals == 0) & (cols == np.arange(n)[:, None])
    np.testing.assert_allclose(tv.grad.numpy()[pad], (w[:, None] * x[:, None] * pad)[pad],
                               atol=1e-15, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_function_gradcheck(kind):
    vals, cols, x, f, _ = _ell_inputs(23, 4, seed=5)
    call = _torch_call(kind, cols, 8)
    inputs = tuple(torch.as_tensor(a).requires_grad_() for a in (vals, x, f))
    fn = call if kind.startswith("residual") else (lambda v, xx: call(v, xx, None))
    assert torch.autograd.gradcheck(fn, inputs if kind.startswith("residual") else inputs[:2])


@pytest.mark.parametrize("backend", ["ell", "ell_stream"])
def test_no_padding_gradient_reaches_csr_vals(backend):
    """Through ``csr_to_ell`` the ELL backends give ``CSR.vals`` the same
    gradient as the CSR matvec, and as ``jax.grad`` of the JAX package's
    ELL matvec, though the ELL values' own gradient is nonzero at padded
    slots."""
    jm = jc.unit_square_tri(5)
    jk = jc.GalerkinAssembler(jc.FunctionSpace(jm, jc.mesh.element_for_mesh(jm))).assemble(
        jwf.diffusion(1.0))
    tm = tc.unit_square_tri(5)
    tk = tc.GalerkinAssembler(tc.FunctionSpace(tm, tc.element_for_mesh(tm)), device="cpu") \
        .assemble(tc.weakform.diffusion(1.0))
    np.testing.assert_array_equal(tk.indices, jk.indices)
    rng = np.random.default_rng(3)
    x, w = rng.normal(size=tk.shape[0]), rng.normal(size=tk.shape[0])

    vals = tk.vals.detach().clone().requires_grad_()
    ell = csr_to_ell(tk.with_vals(vals))
    ell.vals.retain_grad()
    apply = ell_matvec if backend == "ell" else ell_matvec_stream
    (torch.as_tensor(w) * apply(ell, torch.as_tensor(x))).sum().backward()

    vals_csr = tk.vals.detach().clone().requires_grad_()
    (torch.as_tensor(w) * tk.with_vals(vals_csr).matvec(torch.as_tensor(x))).sum().backward()

    def jloss(v):
        op = jc.CSR(v, jk.indptr, jk.indices, jk.row_of_nnz, jk.shape, jk.diag_pos)
        return jnp.sum(jnp.asarray(w) * jsparse.csr_to_ell(op).matvec(jnp.asarray(x)))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(np.asarray(jk.vals))))
    np.testing.assert_allclose(vals.grad.numpy(), want, atol=1e-12, rtol=0)
    np.testing.assert_allclose(vals.grad.numpy(), vals_csr.grad.numpy(), atol=1e-12, rtol=0)
    cols = ell.cols
    pad = np.ones(cols.shape, dtype=bool)
    pad.reshape(-1)[tk.pattern.ell_layout()[1]] = False
    assert pad.any(), "the mesh has no padded ELL slots"
    np.testing.assert_allclose(ell.vals.grad.numpy()[pad],
                               np.broadcast_to((w * x)[:, None], cols.shape)[pad], rtol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_no_graph_without_grad(kind):
    """With grad disabled, or no input requiring it, the wrapper calls the
    kernel (here its plain version) directly and records no node."""
    vals, cols, x, f, _ = _ell_inputs(40, 3, seed=9)
    call = _torch_call(kind, cols, 16)
    plain = [torch.as_tensor(a) for a in (vals, x, f)]
    assert call(*plain).grad_fn is None
    with torch.no_grad():
        assert call(*(t.clone().requires_grad_() for t in plain)).grad_fn is None
    kernels.reset_launches()
    call(*plain)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# ---------------------------------------------------------------------------
# on a CUDA machine: the same Functions around the CUDA kernels
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,width,block_n", SHAPES)
def test_cuda_function_grads_match_cpu(cuda, kind, n, width, block_n):
    vals, cols, x, f, w = _ell_inputs(n, width, seed=n + width)
    grads = []
    for device in ("cpu", cuda):
        c = torch.as_tensor(cols, device=device)
        plan = StreamPlan(cols, block_n)
        call = {
            "spmv": lambda v, xx, ff: spmv_ell(v, c, xx),
            "residual": lambda v, xx, ff: galerkin_residual_ell(v, c, xx, ff),
            "spmv_stream": lambda v, xx, ff: spmv_ell_stream(v, plan, xx),
            "residual_stream": lambda v, xx, ff: galerkin_residual_ell_stream(v, plan, xx, ff),
        }[kind]
        ts = [torch.as_tensor(a, device=device).requires_grad_() for a in (vals, x, f)]
        (torch.as_tensor(w, device=device) * call(*ts)).sum().backward()
        grads.append([None if t.grad is None else t.grad.cpu() for t in ts])
    for got, want in zip(grads[1], grads[0]):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, atol=1e-12, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_function_gradcheck(cuda, kind):
    vals, cols, x, f, _ = _ell_inputs(45, 7, seed=11)
    c = torch.as_tensor(cols, device=cuda)
    plan = StreamPlan(cols, 16)
    call = {
        "spmv": lambda v, xx: spmv_ell(v, c, xx),
        "residual": lambda v, xx, ff: galerkin_residual_ell(v, c, xx, ff),
        "spmv_stream": lambda v, xx: spmv_ell_stream(v, plan, xx),
        "residual_stream": lambda v, xx, ff: galerkin_residual_ell_stream(v, plan, xx, ff),
    }[kind]
    inputs = [torch.as_tensor(a, device=cuda).requires_grad_() for a in (vals, x, f)]
    kernels.reset_launches()
    assert torch.autograd.gradcheck(call, tuple(inputs[:3 if "residual" in kind else 2]))
    name = {"spmv": "spmv_ell", "residual": "galerkin_residual_ell",
            "spmv_stream": "spmv_ell_stream", "residual_stream": "galerkin_residual_ell_stream"}
    assert kernels.LAUNCHES[name[kind]] > 0
