"""The rank side of ``tests/test_torch_lm_layout.py`` and the cell runner of
``tests/test_torch_lm_dryrun.py``: the LM's 2-D layout (``repro_torch``'s
DTensor sharding) run on ranks of a gloo world on the CPU, or in a fake
world, with the results returned as numpy arrays and Python numbers.

The inputs are made with numpy from fixed seeds (:func:`train_case`,
:func:`arch_case`, :func:`serve_case`), so the test makes the same ones for
the JAX package and for the port on one device.  This module imports torch
only in the functions a rank runs (never JAX), so a spawned rank starts
fast.  Not a test module."""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import multiprocessing
import os
import queue as queue_mod
import time
import traceback

import numpy as np

GROUP_TIMEOUT_S = 120
SEED = 0
TRAIN = {"arch": "qwen3-4b", "seq": 32, "batch": 8, "lr": 1e-3, "steps": 20, "parity_steps": 3}
ARCH_BATCH = (4, 16)                  # one step of every architecture: batch, tokens
FRAMES = 24                           # whisper's encoder frames in the layout tests
SERVE = {"arch": "qwen3-4b", "batch": 4, "prompt": 16, "decode_steps": 4, "tp_degree": 16}
LAUNCH = {"first": 6, "second": 10, "every": 3}


def smoke_cfg(name: str, **kw):
    """The smoke variant of ``name`` in float32 compute (and ``kw``), from
    whichever package's ``configs`` is given as ``pkg``."""
    pkg = kw.pop("pkg")
    return dataclasses.replace(pkg.smoke_variant(pkg.ARCHS[name]),
                               **{"compute_dtype": "float32", **kw})


def train_case():
    """(numpy state at SEED, the TRAIN batches) for both packages."""
    import repro_torch.configs as pc
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.layers import numpy_params
    from repro_torch.train.train_step import make_train_state_specs

    cfg = smoke_cfg(TRAIN["arch"], pkg=pc)
    state = numpy_params(make_train_state_specs(cfg), SEED)
    data = SyntheticLMData(cfg.vocab_size, TRAIN["seq"], TRAIN["batch"])
    return state, [next(data) for _ in range(TRAIN["steps"])]


def arch_case(name: str):
    """(numpy state, numpy batch) of one architecture's step."""
    import repro_torch.configs as pc
    from repro_torch.models.layers import numpy_params
    from repro_torch.train.train_step import make_train_state_specs

    cfg = smoke_cfg(name, pkg=pc)
    rng = np.random.default_rng(SEED + 1)
    b, s = ARCH_BATCH
    n_img = cfg.num_frontend_tokens if cfg.frontend == "patch_embed" else 0
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s - n_img + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if n_img:
        batch["vision_embeds"] = rng.standard_normal((b, n_img, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio_frames":
        batch["audio_embeds"] = rng.standard_normal((b, FRAMES, cfg.d_model)).astype(np.float32)
    return numpy_params(make_train_state_specs(cfg), SEED), batch


def serve_case():
    """(numpy served-param draw in float32, prompt tokens, decode tokens)."""
    import repro_torch.configs as pc
    from repro_torch.models import build_model
    from repro_torch.models.layers import numpy_params

    cfg = smoke_cfg(SERVE["arch"], pkg=pc)
    params = numpy_params(build_model(cfg).param_specs(), SEED + 2)
    rng = np.random.default_rng(SEED + 3)
    b, s, n = SERVE["batch"], SERVE["prompt"], SERVE["decode_steps"]
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s + n)).astype(np.int32)
    return params, tokens[:, :s], tokens[:, s:]


def train_shape():
    from repro_torch.configs import ShapeSpec

    return ShapeSpec("t", "train", TRAIN["seq"], TRAIN["batch"])


def _np(t) -> np.ndarray:
    import torch

    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# what a rank of the (2, 2) world runs
# ---------------------------------------------------------------------------

def _mesh(data, model):
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(data, model, device_type="cpu")


def case_train(workdir: str) -> dict:
    """TRAIN["steps"] steps of ``jit_train_step`` on a (2, 2) mesh from the
    numpy state, the batches fed by ``sharded_iterator``; then the state is
    saved under (2, 2) and restored under (4, 1) and (1, 4)."""
    import repro_torch.configs as pc
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.layers import flatten_with_paths, numpy_params
    from repro_torch.sharding import RULES_SINGLE_POD, make_shardings
    from repro_torch.train import jit_train_step
    from repro_torch.train.train_step import make_train_state_specs

    cfg = smoke_cfg(TRAIN["arch"], pkg=pc)
    mesh = _mesh(2, 2)
    step, specs, state_sh, batch_sh = jit_train_step(
        cfg, train_shape(), mesh, RULES_SINGLE_POD, lr=TRAIN["lr"], total_steps=TRAIN["steps"])
    state = lm_params_from_numpy(numpy_params(specs, SEED), specs=specs, mesh=mesh,
                                 rules=RULES_SINGLE_POD)
    it = SyntheticLMData(cfg.vocab_size, TRAIN["seq"], TRAIN["batch"]).sharded_iterator(batch_sh)
    losses, norms = [], []
    try:
        for _ in range(TRAIN["steps"]):
            state, m = step(state, next(it))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        it.close()
    out = {"losses": losses, "grad_norms": norms, "step": int(state["step"]),
           "placements": {"/".join(map(str, p)): str(t.placements)
                          for p, t in flatten_with_paths(state["params"])}}

    # elastic reshard: save under (2, 2), restore under (4, 1) and (1, 4)
    mgr = CheckpointManager(os.path.join(workdir, "reshard"), max_to_keep=2)
    saved = {"/".join(map(str, p)): _np(t) for p, t in flatten_with_paths(state)}
    mgr.save(7, state, extra={"data": {"step": 3, "seed": 0}}, blocking=True)
    import torch.distributed as dist

    dist.barrier()
    equal = {}
    for shape in ((4, 1), (1, 4)):
        m2 = _mesh(*shape)
        restored = mgr.restore(7, make_train_state_specs(cfg),
                               shardings=make_shardings(specs, m2, RULES_SINGLE_POD))
        equal[f"{shape[0]}x{shape[1]}"] = all(
            np.array_equal(saved["/".join(map(str, p))], _np(t))
            and (t.dim() == 0 or t.device_mesh == m2)
            for p, t in flatten_with_paths(restored))
    out["reshard_equal"] = equal
    out["reshard_extra"] = mgr.restore_manifest(7)["extra"]
    return out


def case_split(workdir: str) -> dict:
    """A DTensor batch split into 2 microbatches: each holds the i-th half
    of every rank's rows, and the split issues no collective."""
    import torch

    from repro_torch.analysis.op_cost import count_ops
    from repro_torch.sharding import RULES_SINGLE_POD, distribute_tree, make_shardings
    from repro_torch.train.train_step import _split_microbatches

    mesh = _mesh(2, 2)
    tokens = torch.arange(8 * 4, dtype=torch.int32).reshape(8, 4)
    sh = make_shardings({"tokens": ("batch", None)}, mesh, RULES_SINGLE_POD)
    batch = distribute_tree({"tokens": tokens}, sh)
    with count_ops() as c:
        mbs = _split_microbatches(batch, 2)
    return {"collectives": sum(c.cost.collective_counts.values()),
            "local_rows": [mb.to_local()[:, 0].tolist() for mb in mbs["tokens"]],
            "shapes": [tuple(mb.shape) for mb in mbs["tokens"]]}


# the families whose one step the second world runs (the scans, MoE, hybrid,
# encoder-decoder: the costliest to place), the dense ones in the first
FAMILY_ARCHS = ("llama4-maverick-400b-a17b", "qwen3-moe-30b-a3b", "rwkv6-1.6b", "whisper-tiny",
                "zamba2-7b")


def _arch_steps(names) -> dict:
    """One ``jit_train_step`` step of each architecture on the (2, 2) mesh."""
    import torch

    import repro_torch.configs as pc
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.sharding import RULES_SINGLE_POD, distribute_tree
    from repro_torch.train import jit_train_step

    mesh = _mesh(2, 2)
    out = {}
    for name in names:
        t0 = time.perf_counter()
        cfg = smoke_cfg(name, pkg=pc)
        b, s = ARCH_BATCH
        shape = pc.ShapeSpec("a", "train", s, b)
        step, specs, state_sh, batch_sh = jit_train_step(cfg, shape, mesh, RULES_SINGLE_POD)
        host, batch = arch_case(name)
        state = lm_params_from_numpy(host, specs=specs, mesh=mesh, rules=RULES_SINGLE_POD)
        batch = distribute_tree({k: torch.from_numpy(v) for k, v in batch.items()},
                                {k: batch_sh[k] for k in batch})
        _, m = step(state, batch)
        out[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "seconds": time.perf_counter() - t0}
    return out


def case_archs_dense(workdir: str) -> dict:
    import repro_torch.configs as pc

    return _arch_steps([n for n in sorted(pc.ARCHS) if n not in FAMILY_ARCHS])


def case_archs_families(workdir: str) -> dict:
    return _arch_steps(FAMILY_ARCHS)


def case_serve(workdir: str) -> dict:
    """Sharded prefill of SERVE's prompt and its decode steps on (2, 2)."""
    import torch

    import repro_torch.configs as pc
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models.layers import flatten_with_paths
    from repro_torch.sharding import RULES_SINGLE_POD
    from repro_torch.train.serve_step import make_decode_fn, make_prefill_fn

    cfg = smoke_cfg(SERVE["arch"], pkg=pc)
    mesh = _mesh(2, 2)
    b, s, n = SERVE["batch"], SERVE["prompt"], SERVE["decode_steps"]
    shape = pc.ShapeSpec("s", "prefill", s + n, b)
    prefill, pspecs = make_prefill_fn(cfg, shape, SERVE["tp_degree"], mesh=mesh,
                                      rules=RULES_SINGLE_POD)
    decode, _, _ = make_decode_fn(cfg, shape, SERVE["tp_degree"], mesh=mesh,
                                  rules=RULES_SINGLE_POD)
    host, prompt, nxt = serve_case()
    params = _bf16(lm_params_from_numpy(host, specs=pspecs, mesh=mesh, rules=RULES_SINGLE_POD))
    logits, cache = prefill(params, {"tokens": torch.from_numpy(prompt)})
    out = {"prefill": _np(logits), "decode": []}
    for i in range(n):
        logits, cache = decode(params, {"tokens": torch.from_numpy(nxt[:, i:i + 1]),
                                        "cache_len": s + i}, cache)
        out["decode"].append(_np(logits))
    out["cache"] = {"/".join(map(str, p)): (_np(t), str(t.dtype)) for p, t in
                    flatten_with_paths(cache)}
    out["cache_placements"] = {"/".join(map(str, p)): str(t.placements)
                               for p, t in flatten_with_paths(cache)}
    return out


def _bf16(tree):
    import torch

    from repro_torch.models.layers import tree_map

    return tree_map(lambda t: t.to(torch.bfloat16), tree)


def case_launcher(workdir: str) -> dict:
    """``repro_torch.launch.train --smoke --data-axis 2 --model-axis 2
    --device cpu`` on the world: LAUNCH["first"] steps with checkpoints,
    then a relaunch to LAUNCH["second"] that resumes."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import main as train_main
    import torch.distributed as dist

    ckpt = os.path.join(workdir, "launch_ckpt")
    args = ["--smoke", "--device", "cpu", "--data-axis", "2", "--model-axis", "2",
            "--seq-len", "32", "--batch", "8", "--ckpt-dir", ckpt,
            "--ckpt-every", str(LAUNCH["every"]), "--log-every", "100"]
    runs = []
    for steps in (LAUNCH["first"], LAUNCH["second"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            loss = train_main(args + ["--steps", str(steps)])
        dist.barrier()
        runs.append({"loss": loss, "log": buf.getvalue().splitlines(),
                     "latest": CheckpointManager(ckpt).latest_step()})
        dist.barrier()
    return {"runs": runs}


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def _rank_main(rank: int, size: int, init_file: str, workdir: str, names, out) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=size,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        results = {}
        for name in names:
            t0 = time.perf_counter()
            results[name] = CASES[name](workdir)
            results[f"{name}_s"] = time.perf_counter() - t0
        dist.barrier()
        out.put((rank, results, None))
    except Exception:  # the rank's boundary: report, then fail the world
        out.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# dry-run cells in a fake world of 8 ranks, a (4, 2) mesh
# ---------------------------------------------------------------------------

SMOKE_SHAPES = {"train": ("train_s", 64, 8), "prefill": ("prefill_s", 128, 8),
                "decode": ("decode_s", 128, 8)}


def dryrun_cells(cells) -> dict:
    """Each (arch, kind) of ``cells`` run by ``lower_cell`` at
    ``tests/test_dryrun.py``'s shapes, remat off: its roofline row."""
    import torch

    from repro_torch.analysis.roofline import analyze
    from repro_torch.configs import ARCHS, ShapeSpec, smoke_variant
    from repro_torch.launch.dryrun import fake_world, lower_cell, model_flops_for
    from repro_torch.sharding import RULES_SINGLE_POD

    torch.set_num_threads(1)
    out = {}
    with fake_world(8):
        mesh = _mesh(4, 2)
        for arch, kind in cells:
            name, seq, batch = SMOKE_SHAPES[kind]
            cfg = dataclasses.replace(smoke_variant(ARCHS[arch]), remat=False)
            shape = ShapeSpec(name, kind, seq, batch)
            try:
                cost, held = lower_cell(cfg, shape, mesh, RULES_SINGLE_POD)
                rep = analyze(cost, arch=arch, shape=name, mesh_name="4x2", chips=8,
                              model_flops=model_flops_for(cfg, shape), peak_memory_bytes=held)
                out[(arch, kind)] = {**rep.row(), "held": held, "error": None}
            except Exception:
                out[(arch, kind)] = {"error": traceback.format_exc()[-3000:]}
    return out


def _dryrun_main(cells, out) -> None:
    try:
        out.put((dryrun_cells([tuple(c) for c in cells]), None))
    except Exception:
        out.put((None, traceback.format_exc()))


class Procs:
    """Spawned processes started at once: ``target(*args, queue)`` each;
    :meth:`results` waits for one answer from each (or raises with a
    traceback) and joins them."""

    def __init__(self, target, arg_lists):
        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        self.procs = [ctx.Process(target=target, args=(*args, self.queue), daemon=True)
                      for args in arg_lists]
        for p in self.procs:
            p.start()
        self._results = None

    def results(self, timeout: float = 600.0) -> list:
        if self._results is None:
            got = []
            try:
                for _ in self.procs:
                    item = self.queue.get(timeout=timeout)
                    if item[-1] is not None:
                        raise RuntimeError(f"a worker failed:\n{item[-1]}")
                    got.append(item[:-1])
            except queue_mod.Empty:
                raise RuntimeError(f"{len(got)} of {len(self.procs)} workers answered within "
                                   f"{timeout} s") from None
            finally:
                self.close()
            self._results = got
        return self._results

    def close(self) -> None:
        for p in self.procs:
            p.join(timeout=30)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


def world(size: int, workdir: str, names) -> Procs:
    """A gloo world of ``size`` ranks running ``names``; its results come
    back as ``[(rank, results), ...]``."""
    os.makedirs(workdir, exist_ok=True)
    init_file = os.path.join(workdir, f"rendezvous_{size}")
    return Procs(_rank_main, [(r, size, init_file, workdir, list(names)) for r in range(size)])
