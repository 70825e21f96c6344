"""Torch port parity for the LM harness's Mamba2, hybrid (Zamba2) and audio
(Whisper) families (A17b): ``repro_torch.models.{mamba2,hybrid,encdec}``
against ``repro.models`` on the CPU, and checkpoints of a hybrid tree
across the two packages.

Parameters are drawn once with numpy at the reference's law and loaded by
both packages (``tests/torch_lm_cases.py``).  Tolerances, as the largest
absolute difference over the largest magnitude of the JAX result: the
functions, losses and every gradient leaf 1e-4 (float32 compute, A17a's
bar); caches within one bfloat16 ulp (bfloat16 leaves) or 1e-4 (float32
states); prefill/decode logits 1e-3 (A17a's bar); Mamba2 chunked against
stepwise the reference test's 5e-2; checkpoints bit-equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models.model_zoo import build_model as j_build  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import hybrid as thybrid  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models.layers import flatten_with_paths, numpy_params  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

from torch_lm_cases import (FRAMES, both, both_params, cfgs, check_cache,  # noqa: E402
                            check_loss_and_grads, err, jax_init_params, jax_loss_and_grads,
                            jflat, model_params, perturbed, to_np)
from torch_lm_cases import batch as make_batch  # noqa: E402

HYBRID = "zamba2-7b"
AUDIO = "whisper-tiny"
TAIL = {"num_layers": 5}          # period 2 (smoke): 2 groups of 2 and a tail of 1


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    targs = [torch.from_numpy(a) for a in (x, w, b)] + [
        None if state is None else torch.from_numpy(state)]
    jargs = [jnp.asarray(a) for a in (x, w, b)] + [None if state is None else jnp.asarray(state)]
    tout, tst = tm2._causal_conv(*targs)
    jout, jst = jm2._causal_conv(*jargs)
    assert err(to_np(tout), jout) <= 1e-5
    np.testing.assert_array_equal(to_np(tst), np.asarray(jst))
    np.testing.assert_array_equal(to_np(tst), x[:, -3:])


def test_causal_conv_one_token_keeps_the_older_rows():
    """The new state is the last K−1 rows of [state, x]: a one-token step
    shifts the state by one row and appends the token."""
    rng = np.random.default_rng(1)
    state = rng.standard_normal((1, 3, 5)).astype(np.float32)
    x = rng.standard_normal((1, 1, 5)).astype(np.float32)
    _, st = tm2._causal_conv(torch.from_numpy(x), torch.ones(4, 5), torch.zeros(5),
                             torch.from_numpy(state))
    np.testing.assert_array_equal(st.numpy(), np.concatenate([state[:, 1:], x], axis=1))


def _ssd_inputs(b=2, s=37, h=3, p=4, n=5, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = (0.5 * rng.standard_normal(h)).astype(np.float32)
    b_in, c_in = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a_log, b_in, c_in, state


@pytest.mark.parametrize("chunk", [1, 8, 16])
def test_ssd_chunked_matches_jax(chunk):
    """37 tokens: padded at chunks 8 and 16; chunk 1 is decode's form."""
    args = _ssd_inputs()
    ty, tst = tm2._ssd_chunked(*(torch.from_numpy(a) for a in args), chunk)
    jy, jst = jm2._ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
    assert err(to_np(ty), jy) <= 1e-4
    assert err(to_np(tst), jst) <= 1e-4


def test_ssd_chunk_overflow_is_the_references():
    """ROADMAP C5, a property of the reference kept by the port: the
    intra-chunk kernel exp(Λ_t − Λ_s) is formed for every pair and masked
    by multiplying with 0, so with decays of the init's size (A = −e,
    Δt = softplus of a standard normal, about −2.2 a step) a chunk of 16
    is finite and a chunk of 64 is not — the same rows in both packages,
    the finite rows agreeing."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 512, 4, 8, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = np.ones(h, np.float32)
    b_in, c_in = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    state = np.zeros((b, h, p, n), np.float32)
    for chunk in (16, 64):
        args = (x, dt, a_log, b_in, c_in, state)
        ty = to_np(tm2._ssd_chunked(*(torch.from_numpy(a) for a in args), chunk)[0])
        jy = np.asarray(jm2._ssd_chunked(*(jnp.asarray(a) for a in args), chunk)[0])
        tfin, jfin = np.isfinite(ty).all(axis=(0, 2, 3)), np.isfinite(jy).all(axis=(0, 2, 3))
        np.testing.assert_array_equal(tfin, jfin)
        assert tfin.all() if chunk == 16 else not tfin.all()
        assert err(ty[:, tfin], jy[:, jfin]) <= 1e-4


def _m2_case(seed=0):
    jcfg, tcfg = cfgs(HYBRID)
    host = perturbed(numpy_params(tm2.mamba2_block_specs(tcfg), seed), seed + 1)
    rng = np.random.default_rng(seed + 2)
    d_in, h, p, n = tm2._dims(tcfg)
    state = {"conv": rng.standard_normal((2, tcfg.ssm_conv - 1, d_in + 2 * n)).astype(np.float32),
             "ssm": rng.standard_normal((2, h, p, n)).astype(np.float32)}
    return jcfg, tcfg, host, state, rng


@pytest.mark.parametrize("chunk", [8, 16])
def test_mamba2_block_matches_jax(chunk):
    jcfg, tcfg, host, state, rng = _m2_case()
    x = rng.standard_normal((2, 21, tcfg.d_model)).astype(np.float32)
    jp, tp = both_params(host)
    jx, jst = jm2.mamba2_block(jcfg, jp, jnp.asarray(x), jax.tree.map(jnp.asarray, state), chunk)
    tx, tst = tm2.mamba2_block(tcfg, tp, torch.from_numpy(x), lm_params_from_numpy(state, "cpu"),
                               chunk)
    assert err(to_np(tx), jx) <= 1e-4
    for key in state:
        assert tst[key].dtype == torch.float32
        assert err(to_np(tst[key]), jst[key]) <= 1e-4, key


def test_mamba2_decode_step_matches_jax():
    """Three steps (the block at chunk 1) from a non-zero float32 state;
    then a bfloat16 step, whose conv state comes back in the state's dtype
    (float32)."""
    jcfg, tcfg, host, state, rng = _m2_case(seed=4)
    jp, tp = both_params(host)
    jst, tst = jax.tree.map(jnp.asarray, state), lm_params_from_numpy(state, "cpu")
    for i in range(3):
        x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        jx, jst = jm2.mamba2_decode_step(jcfg, jp, jnp.asarray(x), jst)
        tx, tst = tm2.mamba2_decode_step(tcfg, tp, torch.from_numpy(x), tst)
        assert err(to_np(tx), jx) <= 1e-4, i
        for key in state:
            assert err(to_np(tst[key]), jst[key]) <= 1e-4, (i, key)
    xb = torch.from_numpy(x).bfloat16()
    _, st = tm2.mamba2_decode_step(tcfg, tp, xb, tst)
    assert st["conv"].dtype == torch.float32 and st["ssm"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the hybrid
# ---------------------------------------------------------------------------

def test_hybrid_layout_and_specs_match_jax():
    """zamba2-7b: 81 layers are 13 groups of 6 and a tail of 3; the smoke
    variant at 5 layers is 2 groups of 2 and a tail of 1.  Spec trees key
    for key the reference's."""
    from repro_torch.configs import ARCHS

    assert thybrid._layout(ARCHS[HYBRID]) == (13, 6, 3)
    jcfg, tcfg = cfgs(HYBRID, **TAIL)
    assert thybrid._layout(tcfg) == (2, 2, 1)
    jspecs = jflat_specs(j_build(jcfg).param_specs())
    tspecs = {path: s for path, s in flatten_with_paths(build_model(tcfg).param_specs())}
    assert sorted(jspecs) == sorted(tspecs)
    for path, js in jspecs.items():
        ts = tspecs[path]
        assert (js.shape, js.axes, js.init, js.scale) == (ts.shape, ts.axes, ts.init, ts.scale)
    assert tspecs[("groups", "in_proj")].shape[:2] == (2, 2)
    assert tspecs[("tail", "in_proj")].shape[0] == 1


def jflat_specs(tree) -> dict:
    from repro.models.layers import is_spec

    return {tuple(k.key for k in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(name, layers=None):
    kw = {"num_layers": layers} if layers else {}
    jcfg, tcfg = cfgs(name, **kw)
    jp, _ = model_params(tcfg)
    jb, _ = both(make_batch(tcfg))
    return jax_loss_and_grads(jcfg, jp, jb)


@pytest.mark.parametrize("policy", ["nothing", "dots", "off"])
@pytest.mark.parametrize("name,layers", [(HYBRID, 5), (HYBRID, None), (AUDIO, None)])
def test_loss_and_gradients_match_jax(name, layers, policy):
    """The loss and every gradient leaf against ``jax.value_and_grad``
    under each activation-checkpointing policy: the hybrid with a tail (5
    layers, period 2) and without (the smoke 2), and whisper with 100
    encoder frames."""
    jloss, jgrads = _jax_loss_and_grads(name, layers)
    kw = {"remat": False} if policy == "off" else {"remat": True, "remat_policy": policy}
    if layers:
        kw["num_layers"] = layers
    _, tcfg = cfgs(name, **kw)
    _, tp = model_params(tcfg)
    _, tb = both(make_batch(tcfg))
    check_loss_and_grads(tcfg, tp, tb, jloss, jgrads)


def test_hybrid_forward_with_a_tail_matches_jax():
    jcfg, tcfg = cfgs(HYBRID, **TAIL)
    jp, tp = model_params(tcfg, seed=3)
    jb, tb = both(make_batch(tcfg, labels=False))
    jlog = jax.jit(functools.partial(jhybrid.hybrid_forward, jcfg))(jp, jb)
    with torch.no_grad():
        tlog = thybrid.hybrid_forward(tcfg, tp, tb)
    assert tlog.dtype == torch.float32
    assert err(to_np(tlog), jlog) <= 1e-4


def test_lora_delta_rounds_to_the_weight_dtype_in_prefill_and_to_compute_in_decode():
    """bfloat16 compute on float32 weights: the train/prefill fold casts the
    LoRA delta to the weight dtype (float32), decode casts it to the compute
    dtype (bfloat16), so the folded weights differ by the delta's bfloat16
    rounding — as in the reference."""
    _, tcfg = cfgs(HYBRID, compute_dtype="bfloat16")
    host = perturbed(numpy_params(build_model(tcfg).param_specs(), 0), 1)
    tp = lm_params_from_numpy(host, "cpu")
    lora = {k: v[0] for k, v in tp["lora"].items()}
    train = thybrid._lora_attn(tp["shared"]["attn"], lora, lambda w: w.dtype)
    dec = thybrid._lora_attn(tp["shared"]["attn"], lora, lambda w: torch.bfloat16)
    delta = lora["qa"] @ lora["qb"]
    assert train["wq"].dtype == dec["wq"].dtype == torch.float32
    assert torch.equal(train["wq"], tp["shared"]["attn"]["wq"] + delta)
    assert torch.equal(dec["wq"], tp["shared"]["attn"]["wq"] + delta.bfloat16())
    assert not torch.equal(train["wq"], dec["wq"])


@pytest.mark.parametrize("tp_degree", [16, 1])
@pytest.mark.parametrize("name,layers", [(HYBRID, 5), (AUDIO, None)])
def test_prefill_and_decode_match_jax(name, layers, tp_degree):
    """Prefill's cache (KV within one bfloat16 ulp, Mamba2 states 1e-4,
    whisper's cross KV at the 100 frames given) and logits (1e-3), then
    three decode steps on each side."""
    kw = {"num_layers": layers} if layers else {}
    jcfg, tcfg = cfgs(name, **kw)
    jp, tp = model_params(tcfg)
    batch = make_batch(tcfg, labels=False)
    jb, tb = both(batch)
    prompt = batch["tokens"].shape[1]
    max_len = prompt + 3
    jm, tm = j_build(jcfg, tp_degree), build_model(tcfg, tp_degree)
    jlog, jcache = jax.jit(jm.prefill, static_argnums=2)(jp, jb, max_len)
    with torch.no_grad():
        tlog, tcache = tm.prefill(tp, tb, max_len)
    check_cache(tcache, jcache, "prefill")
    assert err(to_np(tlog), jlog) <= 1e-3
    if name == AUDIO:
        assert tuple(tcache["cross"]["k"].shape[:3]) == (tcfg.num_layers, 2, FRAMES)
    step = np.array([[5], [7]], np.int32)
    jd = jax.jit(jm.decode)
    for i in range(3):
        jlog, jcache = jd(jp, {"tokens": jnp.asarray(step), "cache_len": jnp.int32(prompt + i)},
                          jcache)
        with torch.no_grad():
            tlog, tcache2 = tm.decode(tp, {"tokens": torch.from_numpy(step),
                                           "cache_len": prompt + i}, tcache)
        assert tcache2 is tcache                            # updated in place
        assert err(to_np(tlog), jlog) <= 1e-3, i
        step = (step + 11) % tcfg.vocab_size
    check_cache(tcache, jcache, "decode")


def test_cache_specs_match_jax():
    for name, kw in ((HYBRID, TAIL), (AUDIO, {})):
        jcfg, tcfg = cfgs(name, **kw)
        want = jflat_specs(j_build(jcfg).cache_specs(2, 30))
        got = dict(flatten_with_paths(build_model(tcfg).cache_specs(2, 30)))
        assert sorted(want) == sorted(got), name
        for path, js in want.items():
            assert (got[path].shape, got[path].axes) == (js.shape, js.axes), (name, path)
    assert got[("cross", "k")].shape[2] == tencdec.ENC_FRAMES == 1500


def _m2_logits_stepwise(cfg, tp, tokens):
    model = build_model(cfg, tp_degree=1)
    s = tokens.shape[1]
    logits, cache = model.prefill(tp, {"tokens": tokens[:, :1]}, s)
    outs = [logits[:, 0]]
    for t in range(1, s):
        logits, cache = model.decode(tp, {"tokens": tokens[:, t:t + 1], "cache_len": t}, cache)
        outs.append(logits[:, 0])
    return torch.stack(outs, dim=1)


def test_mamba2_chunked_matches_stepwise():
    """The port's copy of the reference test (32 tokens, float32, the
    reference test's parameters): the chunked hybrid forward against the
    token-by-token decode at its bar, and the forward against JAX's at
    1e-4."""
    jcfg, tcfg = cfgs(HYBRID)
    jp, tp = both_params(jax_init_params(jcfg))
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    with torch.no_grad():
        full = thybrid.hybrid_forward(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
        stepwise = _m2_logits_stepwise(tcfg, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(to_np(stepwise), to_np(full), rtol=5e-2, atol=5e-2)
    jfull = jax.jit(functools.partial(jhybrid.hybrid_forward, jcfg))(
        jp, {"tokens": jnp.asarray(tokens)})
    assert err(to_np(full), jfull) <= 1e-4


# ---------------------------------------------------------------------------
# the encoder–decoder
# ---------------------------------------------------------------------------

def test_encode_matches_jax():
    jcfg, tcfg = cfgs(AUDIO)
    jp, tp = model_params(tcfg, seed=2)
    frames = np.random.default_rng(3).standard_normal((2, FRAMES, tcfg.d_model)).astype(
        np.float32)
    jout = jax.jit(functools.partial(jencdec.encode, jcfg))(jp, jnp.asarray(frames))
    with torch.no_grad():
        tout = tencdec.encode(tcfg, tp, torch.from_numpy(frames))
    assert tout.shape == frames.shape
    assert err(to_np(tout), jout) <= 1e-4
    table = tencdec._sinusoidal(FRAMES, tcfg.d_model, torch.float32, "cpu")
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(jencdec._sinusoidal(FRAMES, tcfg.d_model,
                                                                 jnp.float32)))


def test_decode_attends_over_the_whole_cross_cache():
    """Decode reads every frame of the cross cache, unmasked: the prefill's
    cache at the 100 frames given matches the full decoder, and the same
    entries in a cache preallocated at ENC_FRAMES (1,500, zero past 100)
    move the logits, in JAX as in the port."""
    jcfg, tcfg = cfgs(AUDIO)
    jp, tp = model_params(tcfg)
    batch = make_batch(tcfg, labels=False)
    jb, tb = both(batch)
    s = batch["tokens"].shape[1]
    tm, jm = build_model(tcfg, 1), j_build(jcfg, 1)
    step = {"tokens": np.array([[3], [9]], np.int32)}
    with torch.no_grad():
        _, cache = tm.prefill(tp, tb, s + 1)
        padded = {"self": {k: v.clone() for k, v in cache["self"].items()},
                  "cross": {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0,
                                                           tencdec.ENC_FRAMES - FRAMES))
                            for k, v in cache["cross"].items()}}
        got, _ = tm.decode(tp, {"tokens": torch.from_numpy(step["tokens"]), "cache_len": s},
                           cache)
        got_padded, _ = tm.decode(tp, {"tokens": torch.from_numpy(step["tokens"]),
                                       "cache_len": s}, padded)
        full = tencdec.decode_stack_train(
            tcfg, tp, torch.cat([tb["tokens"], torch.from_numpy(step["tokens"])], dim=1),
            tencdec.encode(tcfg, tp, tb["audio_embeds"]))
    assert padded["cross"]["k"].shape[2] == 1500
    np.testing.assert_allclose(to_np(got)[:, 0], to_np(full)[:, s], rtol=2e-2, atol=2e-2)
    gap = np.abs(to_np(got_padded) - to_np(got)).max()
    assert gap > 1e-2
    _, jcache = jm.prefill(jp, jb, s + 1)
    jpadded = jax.tree.map(lambda a: a, jcache)
    jpadded["cross"] = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 1500 - FRAMES), (0, 0), (0, 0)))
                        for k, v in jcache["cross"].items()}
    jstep = {"tokens": jnp.asarray(step["tokens"]), "cache_len": jnp.int32(s)}
    jgot, _ = jm.decode(jp, jstep, jcache)
    jgot_padded, _ = jm.decode(jp, jstep, jpadded)
    assert err(to_np(got_padded), jgot_padded) <= 1e-3
    assert abs(gap / np.abs(np.asarray(jgot_padded) - np.asarray(jgot)).max() - 1) <= 1e-2


# ---------------------------------------------------------------------------
# checkpoints of a hybrid tree
# ---------------------------------------------------------------------------

def _hybrid_state_host(seed):
    """A hybrid train state with a tail: params (groups at (G, p, …)) and
    AdamW moments, plus the step."""
    _, tcfg = cfgs(HYBRID, **TAIL)
    specs = build_model(tcfg).param_specs()
    host = numpy_params({"params": specs, "opt": make_optimizer("adamw").init_specs(specs)}, seed)
    host["step"] = np.int32(5)
    return host


def test_hybrid_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    host = _hybrid_state_host(0)
    assert host["params"]["groups"]["in_proj"].shape[:2] == (2, 2) and "tail" in host["params"]
    CheckpointManager(str(tmp_path)).save(5, lm_params_from_numpy(host, "cpu"), blocking=True)
    restored = JCheckpointManager(str(tmp_path)).restore(5, jax.tree.map(jnp.asarray, host))
    flat = jflat(restored)
    for path, want in flatten_with_paths(host):
        np.testing.assert_array_equal(np.asarray(flat[path]), want)


def test_hybrid_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    host = _hybrid_state_host(1)
    JCheckpointManager(str(tmp_path)).save(5, jax.tree.map(jnp.asarray, host), blocking=True)
    target = lm_params_from_numpy(_hybrid_state_host(2), "cpu")
    restored = CheckpointManager(str(tmp_path)).restore(5, target)
    for (path, got), (_, want) in zip(flatten_with_paths(restored), flatten_with_paths(host)):
        assert got.dtype == torch.from_numpy(np.asarray(want)).dtype, path
        np.testing.assert_array_equal(got.numpy(), want)
