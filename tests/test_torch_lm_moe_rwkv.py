"""Torch port parity for the LM harness's MoE and RWKV6 families (A17b):
``repro_torch.models.{moe,rwkv6}`` and their branches of
``repro_torch.models.transformer`` against ``repro.models`` on the CPU.

Parameters are drawn once with numpy at the reference's law and loaded by
both packages (``tests/torch_lm_cases.py``).  Tolerances, as the largest
absolute difference over the largest magnitude of the JAX result: the
functions, losses and every gradient leaf 1e-4 (float32 compute, A17a's
bar); caches within one bfloat16 ulp (bfloat16 leaves) or 1e-4 (float32
states); prefill/decode logits 1e-3 (A17a's bar); chunked against stepwise
and across chunk sizes the reference tests' 1e-3."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.models import moe as jmoe  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.model_zoo import build_model as j_build  # noqa: E402

from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.layers import numpy_params  # noqa: E402

from torch_lm_cases import (both, both_params, cfgs, check_cache, check_loss_and_grads, err,  # noqa: E402
                            jax_init_params, jax_loss_and_grads, model_params, perturbed, to_np)
from torch_lm_cases import batch as make_batch  # noqa: E402

MOE = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")
RWKV = "rwkv6-1.6b"


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def test_top_k_breaks_ties_toward_the_lower_index_as_lax_top_k():
    rows = np.array([[0.25, 0.25, 0.25, 0.25, 0.0, 0.0],
                     [0.1, 0.3, 0.1, 0.3, 0.1, 0.1],
                     [0.0, 0.2, 0.2, 0.0, 0.3, 0.3],
                     [1 / 6] * 6], np.float32)
    for k in (1, 2, 3, 5):
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        tv, ti = tmoe.top_k_lower_index_first(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # every tied row picks its lowest indices
    _, ti = tmoe.top_k_lower_index_first(torch.from_numpy(rows[3:]), 4)
    assert ti.tolist() == [[0, 1, 2, 3]]


def _moe_case(case):
    """(jcfg, tcfg, host params, x) for a MoE layer case."""
    name = "llama4-maverick-400b-a17b" if case == "shared" else "qwen3-moe-30b-a3b"
    kw = {"moe_capacity_factor": 0.25} if case == "drops" else {}
    jcfg, tcfg = cfgs(name, **kw)
    host = numpy_params(tmoe.moe_specs(tcfg), 3)
    if case == "ties":
        host["router"] = np.zeros_like(host["router"])   # every gate 1/E
    x = np.random.default_rng(4).standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, host, x


@pytest.mark.parametrize("case", ["routed", "ties", "drops", "shared"])
def test_moe_apply_matches_jax(case):
    """Output and aux loss against ``repro.models.moe.moe_apply``: routed
    (capacity 1.25), tied gates (a zero router), dropped slots (capacity
    0.25) and llama4-maverick's top-1 with the shared expert."""
    jcfg, tcfg, host, x = _moe_case(case)
    jout, jaux = jax.jit(functools.partial(jmoe.moe_apply, jcfg))(
        jax.tree.map(jnp.asarray, host), jnp.asarray(x))
    tout, taux = tmoe.moe_apply(tcfg, lm_params_from_numpy(host, "cpu"), torch.from_numpy(x))
    assert tout.shape == x.shape
    assert err(to_np(tout), jout) <= 1e-4
    assert abs(float(taux) / float(jaux) - 1) <= 1e-5
    assert ("shared" in host) == (case == "shared")


def test_moe_tied_gates_route_to_the_lowest_experts():
    """A zero router ties all E gates: every token goes to experts 0..k−1,
    so with capacity C only the first C tokens (k-major) of each are kept,
    and the rest of the output is the zero of the dropped tokens."""
    jcfg, tcfg, host, x = _moe_case("ties")
    e, k = tcfg.num_experts, tcfg.experts_per_token
    gates = torch.full((2, 24, e), 1.0 / e)
    _, idx = tmoe.top_k_lower_index_first(gates, k)
    assert idx.unique().tolist() == list(range(k))
    c = tmoe._capacity(tcfg, 24)
    out, _ = tmoe.moe_apply(tcfg, lm_params_from_numpy(host, "cpu"), torch.from_numpy(x))
    kept = (out.abs().sum(-1) > 0).numpy()
    assert kept[:, :c].all() and not kept[:, c:].any()


def test_moe_drops_slots_past_capacity_as_jax_one_hot():
    """At capacity factor 0.25 a token past its expert's capacity gets a
    zero slot row (``jax.nn.one_hot`` beyond the classes), where
    ``torch.nn.functional.one_hot`` would raise."""
    jcfg, tcfg, host, x = _moe_case("drops")
    c = tmoe._capacity(tcfg, x.shape[1])
    assert c == tcfg.experts_per_token
    with pytest.raises(RuntimeError):
        torch.nn.functional.one_hot(torch.tensor([c]), c)
    tout, _ = tmoe.moe_apply(tcfg, lm_params_from_numpy(host, "cpu"), torch.from_numpy(x))
    jout, _ = jmoe.moe_apply(jcfg, jax.tree.map(jnp.asarray, host), jnp.asarray(x))
    dropped = (tout.abs().sum(-1) == 0).numpy()
    assert dropped.any() and np.array_equal(dropped, np.abs(np.asarray(jout)).sum(-1) == 0)


def test_moe_capacity_follows_the_call_length():
    _, tcfg = cfgs("qwen3-moe-30b-a3b")
    k = tcfg.experts_per_token
    assert tmoe._capacity(tcfg, 1) == k
    assert tmoe._capacity(tcfg, 512) == int(512 * k / tcfg.num_experts * 1.25)


def test_moe_routes_and_conserves():
    """The port's copy of the reference test, held to JAX's numbers."""
    jcfg, tcfg = cfgs("qwen3-moe-30b-a3b", compute_dtype="bfloat16")
    host = numpy_params(tmoe.moe_specs(tcfg), 0)
    x = np.random.default_rng(1).standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    out, aux = tmoe.moe_apply(tcfg, lm_params_from_numpy(host, "cpu"), torch.from_numpy(x))
    jout, jaux = jmoe.moe_apply(jcfg, jax.tree.map(jnp.asarray, host), jnp.asarray(x))
    assert out.shape == x.shape
    assert np.isfinite(float(aux)) and float(aux) > 0
    assert np.all(np.isfinite(to_np(out)))
    assert abs(float(aux) / float(jaux) - 1) <= 1e-5
    assert err(to_np(out), jout) <= 1e-4


@pytest.mark.parametrize("tokens,seed", [(8, 0), (37, 11), (64, 2024)])
def test_moe_combine_weights_sum_to_one_when_kept(tokens, seed):
    """The port's copy of the reference property test (generous capacity:
    nothing dropped), on fixed draws, held to JAX's output."""
    jcfg, tcfg = cfgs("qwen3-moe-30b-a3b", moe_capacity_factor=8.0, compute_dtype="bfloat16")
    host = numpy_params(tmoe.moe_specs(tcfg), seed)
    x = np.random.default_rng(seed + 1).standard_normal((1, tokens, tcfg.d_model)).astype(
        np.float32)
    out, _ = tmoe.moe_apply(tcfg, lm_params_from_numpy(host, "cpu"), torch.from_numpy(x))
    jout, _ = jmoe.moe_apply(jcfg, jax.tree.map(jnp.asarray, host), jnp.asarray(x))
    assert np.all(np.isfinite(to_np(out)))
    assert float(out.abs().max()) > 0
    assert err(to_np(out), jout) <= 1e-4


def test_init_params_draws_a_large_leaf_in_slices(monkeypatch):
    """A leaf past ``DRAW_SLICE`` entries (maverick's experts at their
    widths) is drawn a slice at a time into its own dtype: the reference's
    law (stddev 1/√fan_in), the slices drawn afresh, small leaves as
    before."""
    from repro_torch.models import layers as tlayers

    small = {"w": tlayers.P((50, 40), (None, None))}
    want_small = tlayers.init_params(small, torch.Generator().manual_seed(0), "cpu")["w"]
    monkeypatch.setattr(tlayers, "DRAW_SLICE", 7_000)
    got = tlayers.init_params({"big": tlayers.P((3, 50, 400), (None, None, None),
                                                dtype=torch.bfloat16)},
                              torch.Generator().manual_seed(0), "cpu")["big"]
    big = got.float().reshape(-1)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 50, 400)
    assert abs(float(big.std()) * np.sqrt(50) - 1) < 0.02 and abs(float(big.mean())) < 0.01
    assert not torch.equal(big[:7_000], big[7_000:14_000])
    assert torch.equal(tlayers.init_params(small, torch.Generator().manual_seed(0), "cpu")["w"],
                       want_small)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _wkv_inputs(b=2, s=45, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    logw = (-np.exp(0.5 * rng.standard_normal((b, s, h, d)) - 1.0)).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32)
    state = rng.standard_normal((b, h, d, d)).astype(np.float32)
    return r, k, v, logw, u, state


@pytest.mark.parametrize("chunk", [8, 16, 37])
def test_wkv_chunked_matches_jax(chunk):
    """45 tokens: padded at every chunk size."""
    args = _wkv_inputs()
    tout, tst = trwkv._wkv_chunked(*(torch.from_numpy(a) for a in args), chunk)
    jout, jst = jrwkv._wkv_chunked(*(jnp.asarray(a) for a in args), chunk)
    assert tout.shape == args[0].shape and tout.dtype == torch.float32
    assert err(to_np(tout), jout) <= 1e-4
    assert err(to_np(tst), jst) <= 1e-4


def test_wkv_bonus_sums_over_d_before_scaling_v():
    """``einsum("bchd,bchd,bche->bche")``: r·u·k summed over d, times v —
    not an elementwise product.  One token, zero state, so the output is
    the bonus alone."""
    r, k, v, logw, u, state = _wkv_inputs(b=1, s=1, h=1, d=4)
    out, _ = trwkv._wkv_chunked(*(torch.from_numpy(a) for a in (r, k, v, logw, u)),
                                torch.zeros((1, 1, 4, 4)), 8)
    want = np.sum(r[0, 0, 0] * u[0] * k[0, 0, 0]) * v[0, 0, 0]
    np.testing.assert_allclose(out[0, 0, 0].numpy(), want, rtol=1e-6)


def test_wkv_chunk_overflow_is_the_references():
    """ROADMAP C4, a property of the reference kept by the port: a constant
    log-decay of −2 stays finite at chunk 16 (cumulated −32 a chunk), and
    at chunk 64 the first chunk's exp(−Λ) overflows and inf·0 makes its
    rows NaN in both packages; the padded second chunk (cumulated −72)
    stays finite, with the same rows finite in both, agreeing."""
    b, s, h, d = 1, 100, 2, 4
    r, k, v, _, u, state = _wkv_inputs(b, s, h, d, seed=5)
    logw = np.full((b, s, h, d), -2.0, np.float32)
    for chunk in (16, 64):
        args = (r, k, v, logw, u, state)
        tout, _ = trwkv._wkv_chunked(*(torch.from_numpy(a) for a in args), chunk)
        jout = np.asarray(jrwkv._wkv_chunked(*(jnp.asarray(a) for a in args), chunk)[0])
        tfin = np.isfinite(to_np(tout)).all(axis=(0, 2, 3))
        jfin = np.isfinite(jout).all(axis=(0, 2, 3))
        np.testing.assert_array_equal(tfin, jfin)
        if chunk == 16:
            assert tfin.all()
        else:
            assert not tfin[:64].any() and tfin[64:].all()
        assert err(to_np(tout)[:, tfin], jout[:, jfin]) <= 1e-4


def _rwkv_block_case(seed=0):
    jcfg, tcfg = cfgs(RWKV)
    host = perturbed(numpy_params(trwkv.rwkv6_block_specs(tcfg), seed), seed + 1)
    rng = np.random.default_rng(seed + 2)
    # base decay about e^-1 a token: a chunk of 16 stays far from the
    # overflow of ROADMAP C4
    host["time"]["w0"] = (host["time"]["w0"] - 1.0).astype(np.float32)
    h, hd = tcfg.d_model // tcfg.ssm_head_dim, tcfg.ssm_head_dim
    state = {"wkv": rng.standard_normal((2, h, hd, hd)).astype(np.float32),
             "shift": rng.standard_normal((2, tcfg.d_model)).astype(np.float32),
             "shift_c": rng.standard_normal((2, tcfg.d_model)).astype(np.float32)}
    return jcfg, tcfg, host, state, rng


@pytest.mark.parametrize("chunk", [8, 16])
def test_rwkv6_block_matches_jax(chunk):
    """One block from a non-zero state, every leaf perturbed off its init."""
    jcfg, tcfg, host, state, rng = _rwkv_block_case()
    x = rng.standard_normal((2, 21, tcfg.d_model)).astype(np.float32)
    jp, tp = both_params(host)
    jx, jst = jrwkv.rwkv6_block(jcfg, jp, jnp.asarray(x), jax.tree.map(jnp.asarray, state), chunk)
    tx, tst = trwkv.rwkv6_block(tcfg, tp, torch.from_numpy(x), lm_params_from_numpy(state, "cpu"),
                                chunk)
    assert err(to_np(tx), jx) <= 1e-4
    for key in state:
        assert err(to_np(tst[key]), jst[key]) <= 1e-4, key


def test_rwkv6_decode_step_matches_jax():
    jcfg, tcfg, host, state, rng = _rwkv_block_case(seed=3)
    jp, tp = both_params(host)
    jst, tst = jax.tree.map(jnp.asarray, state), lm_params_from_numpy(state, "cpu")
    for i in range(3):
        x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        jx, jst = jrwkv.rwkv6_decode_step(jcfg, jp, jnp.asarray(x), jst)
        tx, tst = trwkv.rwkv6_decode_step(tcfg, tp, torch.from_numpy(x), tst)
        assert err(to_np(tx), jx) <= 1e-4, i
        for key in state:
            assert err(to_np(tst[key]), jst[key]) <= 1e-4, (i, key)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(name):
    jcfg, tcfg = cfgs(name)
    jp, _ = model_params(tcfg)
    jb, _ = both(make_batch(tcfg))
    return jax_loss_and_grads(jcfg, jp, jb)


@pytest.mark.parametrize("policy", ["nothing", "dots", "off"])
@pytest.mark.parametrize("name", MOE + (RWKV,))
def test_loss_and_gradients_match_jax(name, policy):
    """The loss (with the MoE aux term) and every gradient leaf against
    ``jax.value_and_grad``, under each activation-checkpointing policy."""
    jloss, jgrads = _jax_loss_and_grads(name)
    kw = {"remat": False} if policy == "off" else {"remat": True, "remat_policy": policy}
    _, tcfg = cfgs(name, **kw)
    _, tp = model_params(tcfg)
    _, tb = both(make_batch(tcfg))
    check_loss_and_grads(tcfg, tp, tb, jloss, jgrads)


@pytest.mark.parametrize("name", MOE)
def test_moe_forward_returns_the_summed_aux(name):
    jcfg, tcfg = cfgs(name)
    jp, tp = model_params(tcfg)
    jb, tb = both(make_batch(tcfg))
    jlog, jaux = jax.jit(functools.partial(jtr.decoder_forward, jcfg))(jp, jb)
    tlog, taux = ttr.decoder_forward(tcfg, tp, tb)
    assert err(to_np(tlog), jlog) <= 1e-4
    assert abs(float(taux) / float(jaux) - 1) <= 1e-5 and float(taux) > 0
    loss = float(build_model(tcfg).loss(tp, tb))
    assert abs(loss - float(ttr.nll(tlog, tb["labels"])) - 0.01 * float(taux)) <= 1e-5


@pytest.mark.parametrize("tp_degree", [16, 1])
@pytest.mark.parametrize("name", MOE + (RWKV,))
def test_prefill_and_decode_match_jax(name, tp_degree):
    """Prefill's cache (KV within one bfloat16 ulp, RWKV6 states 1e-4) and
    logits (1e-3), then three decode steps on each side."""
    jcfg, tcfg = cfgs(name)
    jp, tp = model_params(tcfg)
    batch = make_batch(tcfg, labels=False)
    jb, tb = both(batch)
    prompt = batch["tokens"].shape[1]
    max_len = prompt + 3
    jm, tm = j_build(jcfg, tp_degree), build_model(tcfg, tp_degree)
    jlog, jcache = jax.jit(jm.prefill, static_argnums=2)(jp, jb, max_len)
    tlog, tcache = tm.prefill(tp, tb, max_len)
    check_cache(tcache, jcache, "prefill")
    assert err(to_np(tlog), jlog) <= 1e-3
    step = np.array([[5], [7]], np.int32)
    jd = jax.jit(jm.decode)
    for i in range(3):
        jlog, jcache = jd(jp, {"tokens": jnp.asarray(step), "cache_len": jnp.int32(prompt + i)},
                          jcache)
        tlog, tcache2 = tm.decode(tp, {"tokens": torch.from_numpy(step), "cache_len": prompt + i},
                                  tcache)
        assert tcache2 is tcache                            # updated in place
        assert err(to_np(tlog), jlog) <= 1e-3, i
        step = (step + 11) % tcfg.vocab_size
    check_cache(tcache, jcache, "decode")


def test_rwkv6_cache_specs_match_jax():
    jcfg, tcfg = cfgs(RWKV)
    jspecs = j_build(jcfg).cache_specs(3, 10)
    tspecs = build_model(tcfg).cache_specs(3, 10)
    for key in ("wkv", "shift", "shift_c"):
        assert tspecs[key].shape == jspecs[key].shape and tspecs[key].axes == jspecs[key].axes


def _rwkv_logits_stepwise(cfg, tp, tokens):
    model = build_model(cfg, tp_degree=1)
    s = tokens.shape[1]
    logits, cache = model.prefill(tp, {"tokens": tokens[:, :1]}, s)
    outs = [logits[:, 0]]
    for t in range(1, s):
        logits, cache = model.decode(tp, {"tokens": tokens[:, t:t + 1], "cache_len": t}, cache)
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1)


def test_rwkv6_chunked_matches_stepwise():
    """The port's copy of the reference test (48 tokens, float32, the
    reference test's parameters): the chunked forward against the
    token-by-token decode at its bar, and the forward against JAX's at
    1e-4."""
    jcfg, tcfg = cfgs(RWKV)
    jp, tp = both_params(jax_init_params(jcfg))
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 48)).astype(np.int32)
    with torch.no_grad():
        full, _ = ttr.decoder_forward(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
        stepwise = _rwkv_logits_stepwise(tcfg, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(to_np(stepwise), to_np(full), rtol=1e-3, atol=1e-3)
    jfull, _ = jax.jit(functools.partial(jtr.decoder_forward, jcfg))(jp, {"tokens": jnp.asarray(
        tokens)})
    assert err(to_np(full), jfull) <= 1e-4


def test_rwkv6_chunk_size_invariance():
    """The port's copy of the reference test (chunks 8, 16, 40 over 40
    tokens, the reference test's parameters), each chunk size also against
    JAX's forward at 1e-4.  (With other draws chunk 40 can overflow in both
    packages: ROADMAP C4.)"""
    tokens = np.random.default_rng(5).integers(0, 256, (2, 40)).astype(np.int32)
    outs = []
    for chunk in (8, 16, 40):
        jcfg, tcfg = cfgs(RWKV, ssm_chunk=chunk)
        jp, tp = both_params(jax_init_params(jcfg))
        with torch.no_grad():
            lg, _ = ttr.decoder_forward(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
        jlg, _ = jax.jit(functools.partial(jtr.decoder_forward, jcfg))(
            jp, {"tokens": jnp.asarray(tokens)})
        assert err(to_np(lg), jlg) <= 1e-4, chunk
        outs.append(to_np(lg))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-3, atol=1e-3)


def test_moe_prefill_then_decode_is_not_a_full_forward():
    """Capacity follows each call's length: a 24-token prefill at capacity
    factor 0.25 drops tokens that a 25-token forward routes differently, so
    prefill + one decode step parts from the full forward — in JAX as in
    the port, by the same amount."""
    jcfg, tcfg = cfgs("qwen3-moe-30b-a3b", moe_capacity_factor=0.25)
    jp, tp = model_params(tcfg)
    tokens = np.random.default_rng(8).integers(0, 256, (2, 25)).astype(np.int32)
    model, jmodel = build_model(tcfg, 1), j_build(jcfg, 1)
    with torch.no_grad():
        full, _ = ttr.decoder_forward(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
        _, cache = model.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :24])}, 25)
        dec, _ = model.decode(tp, {"tokens": torch.from_numpy(tokens[:, 24:]), "cache_len": 24},
                              cache)
    jfull, _ = jtr.decoder_forward(jcfg, jp, {"tokens": jnp.asarray(tokens)})
    _, jcache = jmodel.prefill(jp, {"tokens": jnp.asarray(tokens[:, :24])}, 25)
    jdec, _ = jmodel.decode(jp, {"tokens": jnp.asarray(tokens[:, 24:]),
                                 "cache_len": jnp.int32(24)}, jcache)
    gap = np.abs(to_np(dec)[:, 0] - to_np(full)[:, 24]).max()
    jgap = np.abs(np.asarray(jdec)[:, 0] - np.asarray(jfull)[:, 24]).max()
    assert gap > 1e-2 and abs(gap / jgap - 1) <= 1e-3
    assert err(to_np(dec), jdec) <= 1e-3
