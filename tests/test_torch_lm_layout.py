"""The LM's 2-D layout (``repro_torch.sharding``'s logical-axis rules on
DTensor, ``jit_train_step``, the sharded serve steps, ``sharded_iterator``,
the sharded checkpoint and the launcher) on a gloo world of 4 ranks on the
CPU, a (2, 2) mesh over ('data', 'model'), held to the JAX package's
sharded step on ``make_host_mesh(4, 2)`` and to the port on one device.

Two worlds (``tests/torch_lm_layout_worker.py``) are started together
once for the module — the second runs the MoE, scan, hybrid and
encoder–decoder steps — and run while this process computes the
references.  Parameters
are drawn with numpy from a seed and placed through
``lm_params_from_numpy``; compute is float32.  Bars: the sharded step's
losses and grad norms within 1e-4 relative of JAX's and 1e-5 of the port's
one-device step, identical on every rank; every architecture's one-step
loss within 1e-4 of one device; restored checkpoints bit-equal; the
sharded prefill 1e-4 of scale from JAX's, the decode logits within one
bfloat16 ulp of their scale (2^-8, ``chip_smoke.py``'s decode pin bar) and
every bfloat16 cache entry within one bfloat16 ulp of JAX's (the ulp no
finer than that of 1/256 of the leaf's scale: entries that cancel to
near zero carry the float32 rounding of the reordered TP sums)."""

import functools
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

import repro.configs as jc  # noqa: E402
from repro.launch.mesh import make_host_mesh as j_host_mesh  # noqa: E402
from repro.sharding.partitioning import RULES_SINGLE_POD as J_RULES  # noqa: E402
from repro.sharding.partitioning import make_shardings as j_make_shardings  # noqa: E402
from repro.train.serve_step import make_decode_fn as j_decode_fn  # noqa: E402
from repro.train.serve_step import make_prefill_fn as j_prefill_fn  # noqa: E402
from repro.train.train_step import jit_train_step as j_jit_train_step  # noqa: E402

import torch_lm_layout_worker as worker  # noqa: E402
from torch_lm_cases import bf16_ulp, err, jflat  # noqa: E402
import repro_torch.configs as pc  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

RANKS = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The gloo world's results by rank: ``[{case: result}, ...]``."""
    workdir = str(tmp_path_factory.mktemp("lm_layout"))
    families = worker.world(RANKS, os.path.join(workdir, "families"), ("archs_families",))
    w = worker.world(RANKS, workdir, tuple(c for c in worker.CASES if c != "archs_families"))
    _jax_train()
    _one_device_train()
    for name in sorted(pc.ARCHS):
        _one_device_arch(name)
    _jax_serve()
    got = dict(w.results(timeout=900))
    fam = dict(families.results(timeout=900))
    return [{**got[r], "archs": {**got[r]["archs_dense"], **fam[r]["archs_families"]}}
            for r in range(RANKS)]


def _jcfg(name):
    return worker.smoke_cfg(name, pkg=jc)


@functools.lru_cache(maxsize=None)
def _jax_train():
    """JAX's jit_train_step on make_host_mesh(4, 2): losses and grad norms
    of the first parity steps."""
    state, batches = worker.train_case()
    jitted, _, state_sh, batch_sh = j_jit_train_step(
        _jcfg(worker.TRAIN["arch"]), jc.ShapeSpec("t", "train", worker.TRAIN["seq"],
                                                  worker.TRAIN["batch"]),
        j_host_mesh(4, 2), J_RULES, lr=worker.TRAIN["lr"], total_steps=worker.TRAIN["steps"])
    with j_host_mesh(4, 2):
        st = jax.device_put(jax.tree.map(jnp.asarray, state), state_sh)
        out = []
        for b in batches[:worker.TRAIN["parity_steps"]]:
            st, m = jitted(st, jax.device_put(b, batch_sh))
            out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


@functools.lru_cache(maxsize=None)
def _one_device_train():
    state, batches = worker.train_case()
    cfg = worker.smoke_cfg(worker.TRAIN["arch"], pkg=pc)
    step = make_train_step(cfg, worker.train_shape(), lr=worker.TRAIN["lr"],
                           total_steps=worker.TRAIN["steps"])
    st = lm_params_from_numpy(state, "cpu")
    st["step"] = st["step"].cpu()
    out = []
    for b in batches[:worker.TRAIN["parity_steps"]]:
        st, m = step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


@functools.lru_cache(maxsize=None)
def _one_device_arch(name):
    state, batch = worker.arch_case(name)
    cfg = worker.smoke_cfg(name, pkg=pc)
    b, s = worker.ARCH_BATCH
    step = make_train_step(cfg, pc.ShapeSpec("a", "train", s, b))
    st = lm_params_from_numpy(state, "cpu")
    st["step"] = st["step"].cpu()
    _, m = step(st, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(m["loss"]), float(m["grad_norm"])


@functools.lru_cache(maxsize=None)
def _jax_serve():
    """JAX's make_prefill_fn / make_decode_fn on make_host_mesh(4, 2)."""
    host, prompt, nxt = worker.serve_case()
    cfg = _jcfg(worker.SERVE["arch"])
    b, s, n = worker.SERVE["batch"], worker.SERVE["prompt"], worker.SERVE["decode_steps"]
    shape = jc.ShapeSpec("s", "prefill", s + n, b)
    mesh = j_host_mesh(4, 2)
    prefill, _ = j_prefill_fn(cfg, shape, mesh, J_RULES)
    decode, _, cspecs = j_decode_fn(cfg, jc.ShapeSpec("s", "decode", s + n, b), mesh, J_RULES)
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), host)
    with mesh:
        logits, cache = prefill(params, {"tokens": jnp.asarray(prompt)})
        out = {"prefill": np.asarray(logits, np.float32), "decode": []}
        for i in range(n):
            # to the decode's cache placement (the steps' outputs differ in the heads)
            cache = jax.device_put(cache, j_make_shardings(cspecs, mesh, J_RULES))
            logits, cache = decode(params, {"tokens": jnp.asarray(nxt[:, i:i + 1]),
                                            "cache_len": jnp.int32(s + i)}, cache)
            out["decode"].append(np.asarray(logits, np.float32))
    out["cache"] = {"/".join(map(str, k)): v for k, v in jflat(cache).items()}
    return out


def _rel(a, b):
    return abs(a / b - 1)


def test_sharded_train_step_matches_jax_and_one_device(ranks):
    got = ranks[0]["train"]
    n = worker.TRAIN["parity_steps"]
    for i, ((jl, jg), (tl, tg)) in enumerate(zip(_jax_train(), _one_device_train())):
        loss, gnorm = got["losses"][i], got["grad_norms"][i]
        assert _rel(loss, jl) <= 1e-4 and _rel(gnorm, jg) <= 1e-4, (i, loss, jl, gnorm, jg)
        assert _rel(loss, tl) <= 1e-5 and _rel(gnorm, tg) <= 1e-5, (i, loss, tl, gnorm, tg)
    assert len(_jax_train()) == n
    for r in ranks[1:]:
        assert r["train"]["losses"] == got["losses"]
        assert r["train"]["grad_norms"] == got["grad_norms"]


def test_sharded_train_step_runs_and_improves(ranks):
    got = ranks[0]["train"]
    losses = got["losses"]
    assert len(losses) == worker.TRAIN["steps"] and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert got["step"] == worker.TRAIN["steps"]
    # the layout: FSDP over 'data' and TP over 'model' where the rules put them
    assert got["placements"]["blocks/attn/wq"] == "(Shard(dim=1), Shard(dim=2))"
    assert got["placements"]["embed"] == "(Shard(dim=1), Shard(dim=0))"


def test_microbatches_split_each_ranks_rows_without_a_collective(ranks):
    for rank, r in enumerate(ranks):
        got = r["split"]
        assert got["collectives"] == 0
        assert got["shapes"] == [(4, 4), (4, 4)]
        lo = 4 * (rank // 2)                   # the rank's rows on 'data' (mesh row-major)
        assert got["local_rows"] == [[4 * lo, 4 * (lo + 1)], [4 * (lo + 2), 4 * (lo + 3)]]


@pytest.mark.parametrize("arch", sorted(pc.ARCHS))
def test_every_arch_one_step_matches_one_device(ranks, arch):
    tl, tg = _one_device_arch(arch)
    got = ranks[0]["archs"][arch]
    assert _rel(got["loss"], tl) <= 1e-4, (got, tl)
    assert _rel(got["grad_norm"], tg) <= 1e-4, (got, tg)
    for r in ranks[1:]:
        assert (r["archs"][arch]["loss"], r["archs"][arch]["grad_norm"]) == (
            got["loss"], got["grad_norm"])


def test_checkpoint_roundtrip_and_elastic_reshard(ranks):
    for r in ranks:
        assert r["train"]["reshard_equal"] == {"4x1": True, "1x4": True}
        assert r["train"]["reshard_extra"] == {"data": {"step": 3, "seed": 0}}


def test_sharded_prefill_and_decode_match_jax(ranks):
    want = _jax_serve()
    got = ranks[0]["serve"]
    assert err(got["prefill"], want["prefill"]) <= 1e-4
    for g, w in zip(got["decode"], want["decode"]):
        assert err(g, w) <= 2.0 ** -8        # one bfloat16 ulp of the scale
    assert sorted(got["cache"]) == sorted(want["cache"])
    for key, (g, dtype) in got["cache"].items():
        w = np.asarray(want["cache"][key], np.float32)
        assert g.shape == w.shape and dtype == "torch.bfloat16", key
        # one bf16 ulp of each entry, the ulp no finer than that of 1/256 of the
        # leaf's scale: an entry that cancels to near zero carries the float32
        # rounding of the TP partial sums, which meet in another order
        ulp = np.maximum(bf16_ulp(w), bf16_ulp(np.float32(np.abs(w).max() / 256)))
        assert np.all(np.abs(g - w) <= ulp), key
    assert "Shard(dim=1)" in got["cache_placements"]["k"]      # batch over 'data'
    for r in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(r["serve"]["decode"], got["decode"]))


def test_launcher_trains_on_the_2d_layout_and_resumes(ranks):
    first, second = ranks[0]["launcher"]["runs"]
    assert first["latest"] == worker.LAUNCH["first"]
    assert second["latest"] == worker.LAUNCH["second"]
    assert f"[resume] restoring step {worker.LAUNCH['first']}" in second["log"][0]
    assert np.isfinite(first["loss"]) and np.isfinite(second["loss"])
    for r in ranks[1:]:
        assert r["launcher"]["runs"][1]["log"] == []          # only rank 0 prints
        assert r["launcher"]["runs"][1]["loss"] == second["loss"]
