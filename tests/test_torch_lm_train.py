"""Torch port parity for the LM harness's training side (A17a):
``repro_torch.optim``, ``.train``, ``.data``, ``.checkpoint`` and
``.launch.train`` against the JAX package on the CPU, and the JAX numbers
that ``chip_smoke.py``'s ``lm`` phase pins.

Tolerances: ``cosine_schedule`` bit-equal in float32; AdamW and Adafactor
steps 1e-6 of each leaf's scale; ``make_train_step`` (loss, grad norm, lr,
every parameter) 1e-4; gradient accumulation the reference test's bars
(loss 1e-5, gradients rtol 2e-3 / atol 2e-5); data batches and
checkpoints bit-equal; the pins 1e-4 (the card's gate) for the port and
1e-6 for JAX.  Inputs and parameters are explicit float32/int32 numpy
arrays, so the results hold whichever state JAX's x64 flag is in."""

import dataclasses
import functools
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.models.layers import P as JP  # noqa: E402
from repro.models.layers import init_params as j_init_params  # noqa: E402
from repro.models.model_zoo import build_model as j_build  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCHS, ShapeSpec, smoke_variant  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import P, flatten_with_paths, init_params, numpy_params  # noqa: E402
from repro_torch.optim import cosine_schedule, make_optimizer  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.train_step import _split_microbatches  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jflat(tree) -> dict:
    """A JAX tree's leaves by key path."""
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sched", [(3e-4, 100, 10000), (1e-3, 1, 10), (0.05, 7, 53),
                                   (3e-4, 5, 20)])
def test_cosine_schedule_is_bit_equal(sched):
    f, g = j_cosine(*sched), cosine_schedule(*sched)
    steps = range(0, min(sched[2] + 5, 2000))
    want = np.asarray(f(jnp.arange(len(steps), dtype=jnp.float32)), np.float32)
    got = np.array([g(s) for s in steps], np.float32)
    assert isinstance(g(3), float)
    np.testing.assert_array_equal(got, want)


def _mixed_tree(seed):
    """A mixed-rank tree: a stacked (L, d, f) leaf, a matrix, a vector."""
    rng = np.random.default_rng(seed)
    shapes = {"stack": (3, 6, 5), "w": (7, 4), "b": (9,)}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_jax(name):
    """Three steps on a mixed-rank tree from the same params and gradients:
    every param and state leaf within 1e-6 of scale."""
    params = _mixed_tree(0)
    jspecs = {k: JP(v.shape, (None,) * v.ndim) for k, v in params.items()}
    tspecs = {k: P(v.shape, (None,) * v.ndim) for k, v in params.items()}
    jopt, topt = j_make_optimizer(name), make_optimizer(name)
    jstate = j_init_params(jopt.init_specs(jspecs), jax.random.PRNGKey(0))
    tstate = init_params(topt.init_specs(tspecs), torch.Generator(), "cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jupdate = jax.jit(lambda p, g, st, lr, step: jopt.update(p, g, st, lr, step, wd=0.01))
    tp = lm_params_from_numpy(params, "cpu")
    for step in (1, 2, 3):
        grads = _mixed_tree(step)
        lr = 0.01 * step
        jp, jstate = jupdate(jp, {k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                             jnp.float32(lr), jnp.float32(step))
        topt.update(tp, lm_params_from_numpy(grads, "cpu"), tstate, lr, float(step), wd=0.01)
    for k in params:
        assert _err(_np(tp[k]), jp[k]) <= 1e-6, k
        for s in jstate[k]:
            assert tstate[k][s].shape == jstate[k][s].shape
            assert _err(_np(tstate[k][s]), jstate[k][s]) <= 1e-6, (k, s)
    if name == "adafactor":
        assert tuple(tstate["stack"]["vr"].shape) == (3, 6)
        assert tuple(tstate["stack"]["vc"].shape) == (3, 5)
        assert set(tstate["b"]) == {"v"}


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "nemotron-4-340b", "llama4-maverick-400b-a17b"])
def test_make_train_step_matches_jax(arch):
    """The reference's step and the port's, four times from the same state
    on the same batch (``chip_smoke.lm_pin_case``): loss, grad norm and lr
    of each step and every parameter after them within 1e-4 of scale.
    nemotron-4 and llama4-maverick (its MoE aux term in the loss) run
    Adafactor with two microbatches accumulated in bfloat16."""
    from repro_torch.optim import make_optimizer as t_make_optimizer

    cfg, host, hbatch = chip_smoke.lm_pin_case(arch)
    assert cfg.grad_accum("pin") == (2 if cfg.grad_dtype == "bfloat16" else 1)
    model = build_model(cfg)
    state = {"params": lm_params_from_numpy(host, "cpu"),
             "opt": init_params(t_make_optimizer(cfg.optimizer).init_specs(model.param_specs()),
                                torch.Generator(), "cpu"),
             "step": torch.tensor(0, dtype=torch.int32)}
    b, s = chip_smoke.LM_PIN_SHAPE
    step = make_train_step(cfg, ShapeSpec("pin", "train", s, b), **chip_smoke.LM_PIN_TRAIN)
    batch = {k: torch.from_numpy(v) for k, v in hbatch.items()}
    _, jmetrics, jparams = _jax_pin_run(arch)
    for jm in jmetrics:
        state, tm = step(state, batch)
        assert abs(float(tm["loss"]) / jm["loss"] - 1) <= 1e-4
        assert abs(float(tm["grad_norm"]) / jm["grad_norm"] - 1) <= 1e-4
        assert np.float32(tm["lr"]) == np.float32(jm["lr"])
    assert int(state["step"]) == len(jmetrics)
    jflat = _jflat(jparams)
    for path, leaf in flatten_with_paths(state["params"]):
        assert _err(_np(leaf), jflat[path]) <= 1e-4, path


def test_rwkv6_train_step_matches_jax_from_each_state():
    """rwkv6's AdamW step against the reference's, one step at a time from
    the reference's own state after each of its steps (params, moments,
    step count): loss, grad norm and lr within 1e-4, and each parameter's
    update within 1e-2 of the learning rate.

    The smoke RWKV6 is ill-conditioned (a grad norm of 2,029 at the first
    step, the bonus u's gradient 1,052), so chained steps would measure
    that conditioning: a 3e-6 difference in the loss after one step is
    2.2e-4 of the grad norm after the next, in either package.  And
    AdamW's first update, lr·g/(|g| + ε), takes the sign of an element
    whose gradient sits at the rounding floor: at most two such elements
    of the 132,672 (one of ``embed``, one of ``wb``) turn the other way."""
    arch = "rwkv6-1.6b"
    cfg, host, hbatch = chip_smoke.lm_pin_case(arch)
    jcfg = dataclasses.replace(smoke_variant(J_ARCHS[arch]), **chip_smoke.lm_pin_overrides(arch))
    b, s = chip_smoke.LM_PIN_SHAPE
    shape = ShapeSpec("pin", "train", s, b)
    jopt = j_make_optimizer(jcfg.optimizer)
    jstate = {"params": jax.tree.map(jnp.asarray, host),
              "opt": j_init_params(jopt.init_specs(j_build(jcfg).param_specs()),
                                   jax.random.PRNGKey(0)),
              "step": jnp.int32(0)}
    jstep = jax.jit(j_make_train_step(jcfg, shape, **chip_smoke.LM_PIN_TRAIN))
    step = make_train_step(cfg, shape, **chip_smoke.LM_PIN_TRAIN)
    batch = {k: torch.from_numpy(v) for k, v in hbatch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in hbatch.items()}
    for i in range(chip_smoke.LM_PIN_STEPS + 1):
        host_state = jax.tree.map(np.asarray, jstate)
        state = lm_params_from_numpy(host_state, "cpu")
        state["step"] = torch.tensor(int(host_state["step"]), dtype=torch.int32)
        jstate, jm = jstep(jstate, jbatch)
        state, tm = step(state, batch)
        assert abs(float(tm["loss"]) / float(jm["loss"]) - 1) <= 1e-4, i
        assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) <= 1e-4, i
        assert np.float32(tm["lr"]) == np.float32(jm["lr"]), i
        lr = tm["lr"]
        before, want = _jflat(host_state["params"]), _jflat(jstate["params"])
        flips = 0
        for path, leaf in flatten_with_paths(state["params"]):
            d_port = _np(leaf).astype(np.float64) - before[path]
            d_jax = np.asarray(want[path], np.float64) - before[path]
            flip = np.sign(d_port) != np.sign(d_jax)
            flips += int(flip.sum())
            assert np.all(np.abs(d_port - d_jax)[~flip] <= 1e-2 * lr), (i, path)
        assert flips <= (2 if i == 0 else 0), (i, flips)


def test_grad_accum_equivalence():
    """4 microbatches give the gradients of one batch (the port's copy of the
    reference test, at its bars), and ``make_train_step`` with 4 microbatches
    takes the step of the same batch whole."""
    cfg = dataclasses.replace(smoke_variant(ARCHS["qwen3-4b"]), compute_dtype="float32",
                              microbatches={"t1": 1, "t4": 4})
    model = build_model(cfg, tp_degree=1)
    params = init_params(model.param_specs(), torch.Generator().manual_seed(0), "cpu")
    leaves = [p.requires_grad_(True) for _, p in flatten_with_paths(params)]
    batch = {k: torch.from_numpy(v) for k, v in next(iter(SyntheticLMData(
        cfg.vocab_size, 32, 8))).items()}
    loss1 = model.loss(params, batch)
    g1 = torch.autograd.grad(loss1, leaves)
    mbs = _split_microbatches(batch, 4)
    g4 = [torch.zeros_like(p) for p in leaves]
    l4 = 0.0
    for i in range(4):
        li = model.loss(params, {k: v[i] for k, v in mbs.items()})
        for a, g in zip(g4, torch.autograd.grad(li, leaves)):
            a += g / 4
        l4 += float(li.detach()) / 4
    np.testing.assert_allclose(l4, float(loss1.detach()), rtol=1e-5)
    for a, b in zip(g1, g4):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-3, atol=2e-5)

    def one_step(shape_name):
        p = init_params(model.param_specs(), torch.Generator().manual_seed(0), "cpu")
        state = {"params": p, "opt": init_params(make_optimizer("adamw").init_specs(
            model.param_specs()), torch.Generator(), "cpu"), "step": torch.tensor(0)}
        _, m = make_train_step(cfg, ShapeSpec(shape_name, "train", 32, 8))(state, batch)
        return state, m

    s1, m1 = one_step("t1")
    s4, m4 = one_step("t4")
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m4["grad_norm"]), float(m1["grad_norm"]), rtol=2e-3)
    for (_, a), (_, b) in zip(flatten_with_paths(s1["params"]), flatten_with_paths(s4["params"])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-3, atol=2e-5)


def test_split_microbatches_refuses_a_ragged_batch():
    with pytest.raises(ValueError, match="not divisible"):
        _split_microbatches({"tokens": torch.zeros((6, 4))}, 4)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_data_bit_equal_to_the_reference_and_resumes():
    jd, td = JData(1000, 32, 4, seed=5), SyntheticLMData(1000, 32, 4, seed=5)
    for _ in range(4):
        a, b = next(jd), next(td)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    assert td.state() == jd.state() == {"step": 4, "seed": 5}
    d2 = SyntheticLMData(1000, 32, 4, seed=5)
    d2.restore({"step": 3, "seed": 5})
    np.testing.assert_array_equal(next(d2)["tokens"], JData(1000, 32, 4, seed=5)._make_batch(3)[
        "tokens"])


def test_device_iterator_prefetches_the_same_batches():
    """The prefetching iterator yields the batches in order as int32
    tensors; like the reference's, the state counts the batches made (up to
    ``prefetch`` + 1 ahead of those consumed); closing it stops the thread."""
    import threading
    import time

    n_threads = threading.active_count()
    data = SyntheticLMData(500, 16, 2, seed=1)
    it = data.device_iterator("cpu")
    got = [next(it) for _ in range(3)]
    ref = SyntheticLMData(500, 16, 2, seed=1)
    for batch in got:
        want = next(ref)
        assert batch["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(batch["tokens"].numpy(), want["tokens"])
    deadline = time.monotonic() + 10
    while data.state()["step"] < 3 + data.prefetch and time.monotonic() < deadline:
        time.sleep(0.01)
    assert 3 + data.prefetch <= data.state()["step"] <= 3 + data.prefetch + 1
    it.close()
    assert threading.active_count() == n_threads


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _train_state_host(seed):
    cfg = smoke_variant(ARCHS["nemotron-4-340b"])   # Adafactor: vr/vc leaves
    specs = {"params": build_model(cfg).param_specs(),
             "opt": make_optimizer(cfg.optimizer).init_specs(build_model(cfg).param_specs())}
    host = numpy_params(specs, seed)
    host["step"] = np.int32(7)
    return host


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    host = _train_state_host(0)
    state = lm_params_from_numpy(host, "cpu")
    CheckpointManager(str(tmp_path)).save(7, state, extra={"data": {"step": 3, "seed": 0}},
                                          blocking=True)
    jm = JCheckpointManager(str(tmp_path))
    assert jm.latest_step() == 7
    restored = jm.restore(7, jax.tree.map(jnp.asarray, host))
    flat = _jflat(restored)
    for path, want in flatten_with_paths(host):
        got = np.asarray(flat[path])
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)
    assert jm.restore_manifest(7)["extra"]["data"] == {"step": 3, "seed": 0}


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    host = _train_state_host(1)
    JCheckpointManager(str(tmp_path)).save(9, jax.tree.map(jnp.asarray, host), blocking=True)
    mgr = CheckpointManager(str(tmp_path))
    target = lm_params_from_numpy(_train_state_host(2), "cpu")
    restored = mgr.restore(9, target)
    for (path, got), (_, like), (_, want) in zip(flatten_with_paths(restored),
                                                 flatten_with_paths(target),
                                                 flatten_with_paths(host)):
        assert got.dtype == like.dtype, path
        np.testing.assert_array_equal(got.numpy(), want)
    # a spec tree as the target: the leaves land on the CPU with their saved dtypes
    specs = {"params": build_model(smoke_variant(ARCHS["nemotron-4-340b"])).param_specs()}
    part = mgr.restore(9, specs)
    np.testing.assert_array_equal(part["params"]["embed"].numpy(), host["params"]["embed"])


def test_checkpoint_async_save_ignores_uncommitted_and_keeps_the_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(1, {"w": torch.ones(4)})          # async
    mgr.wait()
    os.makedirs(tmp_path / "step_00000002")
    (tmp_path / "step_00000002" / "arrays.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 1
    for s in (3, 4, 5):
        mgr.save(s, {"w": torch.full((2,), float(s))}, blocking=True)
    assert mgr.all_steps() == [4, 5]
    np.testing.assert_array_equal(mgr.restore(5, {"w": torch.zeros(2)})["w"].numpy(), [5.0, 5.0])
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(5, {"w": torch.zeros(3)})


def test_checkpoint_refuses_bfloat16_leaves(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        CheckpointManager(str(tmp_path)).save(1, {"w": torch.ones(2, dtype=torch.bfloat16)},
                                              blocking=True)


# ---------------------------------------------------------------------------
# the launcher (the port's copies of tests/test_train_loop.py's first two)
# ---------------------------------------------------------------------------

def test_train_loss_decreases():
    loss = train_main([
        "--arch", "qwen3-4b", "--smoke", "--device", "cpu",
        "--steps", "30", "--seq-len", "64", "--batch", "8",
        "--log-every", "29",
    ])
    assert np.isfinite(loss)
    assert loss < 5.7  # ln(256) ≈ 5.55 at init + margin; motifs learn fast


def test_train_resume_after_kill(tmp_path, capsys):
    ckpt = str(tmp_path / "ck")
    args = [
        "--arch", "qwen3-4b", "--smoke", "--device", "cpu",
        "--seq-len", "64", "--batch", "8",
        "--ckpt-dir", ckpt, "--ckpt-every", "10", "--log-every", "100",
    ]
    train_main(args + ["--steps", "20"])
    assert CheckpointManager(ckpt).latest_step() == 20
    capsys.readouterr()
    loss = train_main(args + ["--steps", "35"])
    assert "[resume] restoring step 20" in capsys.readouterr().out
    assert CheckpointManager(ckpt).latest_step() == 35
    assert np.isfinite(loss)
    # the data state counts the batches the prefetch thread made
    data_step = CheckpointManager(ckpt).restore_manifest(35)["extra"]["data"]["step"]
    assert 35 <= data_step <= 35 + 2 * 3


def test_launcher_refuses_a_2d_layout_and_defaults_to_cuda():
    """A 2-D layout needs data × model ranks: one process refuses it (the
    sharded runs are in tests/test_torch_lm_layout.py)."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        train_main(["--smoke", "--device", "cpu", "--model-axis", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_main(["--smoke", "--steps", "1"])


# ---------------------------------------------------------------------------
# the pins of chip_smoke.py's lm phase
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_pin_run(arch: str):
    """(the pin quantities, each train step's metrics, the params after the
    steps) computed by the JAX package on ``lm_pin_case``."""
    tcfg, host, hbatch = chip_smoke.lm_pin_case(arch)
    cfg = dataclasses.replace(smoke_variant(J_ARCHS[arch]), **chip_smoke.lm_pin_overrides(arch))
    model = j_build(cfg)
    params = jax.tree.map(jnp.asarray, host)
    batch = {k: jnp.asarray(v) for k, v in hbatch.items()}
    b, s = chip_smoke.LM_PIN_SHAPE
    n_img = cfg.num_frontend_tokens if cfg.frontend == "patch_embed" else 0
    prompt = {k: (v[:, : s - 1] if k == "tokens" else v)
              for k, v in batch.items() if k != "labels"}

    @jax.jit
    def serve(params):
        logits_p, cache = model.prefill(params, prompt, s + n_img)
        logits_d, _ = model.decode(params, {"tokens": batch["tokens"][:, s - 1:],
                                            "cache_len": jnp.int32(s - 1 + n_img)}, cache)
        return logits_p, logits_d

    logits_p, logits_d = serve(params)
    out = {"prefill": chip_smoke.lm_pin_summary(np.asarray(logits_p)),
           "decode": chip_smoke.lm_pin_summary(np.asarray(logits_d))}
    opt = j_make_optimizer(cfg.optimizer)
    state = {"params": params,
             "opt": j_init_params(opt.init_specs(model.param_specs()), jax.random.PRNGKey(0)),
             "step": jnp.int32(0)}
    step = jax.jit(j_make_train_step(cfg, ShapeSpec("pin", "train", s, b),
                                     **chip_smoke.LM_PIN_TRAIN))
    metrics = []
    for _ in range(chip_smoke.LM_PIN_STEPS + 1):   # a step's loss is taken before its update
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    out["loss"], out["final_loss"] = metrics[0]["loss"], metrics[-1]["loss"]
    out["step_losses"] = [m["loss"] for m in metrics[:-1]]
    out["step_grad_norms"] = [m["grad_norm"] for m in metrics[:-1]]
    return out, metrics, jax.tree.map(np.asarray, state["params"])


@pytest.mark.parametrize("arch", chip_smoke.LM_ARCHS)
def test_chip_smoke_lm_pins_match_jax(arch):
    """``chip_smoke.py`` holds the card to JAX numbers pinned for all ten
    architectures (the card machine has no JAX): the JAX package meets them
    to 1e-6, and the port on the CPU at the card's gate (1e-4)."""
    pins = chip_smoke.JAX_LM_PINS[arch]
    jerr = chip_smoke.lm_pin_errors(_jax_pin_run(arch)[0], pins)
    assert max(jerr.values()) <= 1e-6, jerr
    terr = chip_smoke.lm_pin_errors(chip_smoke.lm_pin_run(arch, "cpu"), pins)
    assert max(terr.values()) <= chip_smoke.LM_PIN_TOL, terr


def test_lm_modules_load_neither_jax_nor_repro():
    """The LM modules of the port (the MoE, RWKV6, Mamba2, hybrid and
    encoder–decoder families, the 2-D layout and the dry-run tooling among
    them), and a launcher run on the CPU, load neither JAX nor the JAX
    package."""
    import subprocess

    code = (
        "import sys\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.optim, repro_torch.train\n"
        "import repro_torch.data, repro_torch.checkpoint, repro_torch.convert\n"
        "import repro_torch.models.moe, repro_torch.models.rwkv6, repro_torch.models.mamba2\n"
        "import repro_torch.models.hybrid, repro_torch.models.encdec\n"
        "import repro_torch.analysis.op_cost, repro_torch.analysis.roofline\n"
        "import repro_torch.analysis.report, repro_torch.launch.mesh\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.perf, repro_torch.sharding\n"
        "from repro_torch.launch.train import main\n"
        "main(['--smoke', '--steps', '2', '--seq-len', '32', '--batch', '2', '--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('loaded:', ','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "loaded:"
