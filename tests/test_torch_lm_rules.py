"""The LM layout's specs and tooling held to the JAX package, with no
process group: every logical-axis spec of every architecture (published
widths and smoke variant) under both rule sets, the inputs and abstract
parameters of the dry-run, the dry-run's skip, FLOP and rule helpers, the
perf variants, the report's tables and the roofline with the H100's
constants (``repro_torch.sharding``, ``.launch.dryrun``, ``.launch.perf``,
``.analysis``)."""

import types

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.analysis import report as j_report  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import smoke_variant as j_smoke  # noqa: E402
from repro.launch import dryrun as j_dryrun  # noqa: E402
from repro.launch import perf as j_perf  # noqa: E402
from repro.models.layers import is_spec as j_is_spec  # noqa: E402
from repro.models.model_zoo import build_model as j_build  # noqa: E402
from repro.sharding import partitioning as jpart  # noqa: E402
from repro.train.serve_step import serve_param_specs as j_serve_specs  # noqa: E402
from repro.train.train_step import make_train_state_specs as j_state_specs  # noqa: E402

from repro_torch.analysis import report  # noqa: E402
from repro_torch.analysis.roofline import HW, RooflineReport  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, smoke_variant  # noqa: E402
from repro_torch.launch import dryrun, perf  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import abstract_params, flatten_with_paths  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402
from repro_torch.train.serve_step import serve_param_specs  # noqa: E402
from repro_torch.train.train_step import make_train_state_specs  # noqa: E402

ARCH_NAMES = sorted(ARCHS)
RULES = ("RULES_SINGLE_POD", "RULES_MULTI_POD")
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _jflat(tree) -> dict:
    paths = jax.tree_util.tree_flatten_with_path(tree, is_leaf=j_is_spec)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path): leaf
            for path, leaf in paths}


def _tflat(tree) -> dict:
    return dict(flatten_with_paths(tree))


def _spec_trees(arch, smoke):
    """(port, JAX) pairs of the four spec trees of an architecture."""
    tcfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    if smoke:
        tcfg, jcfg = smoke_variant(tcfg), j_smoke(jcfg)
    tm, jm = build_model(tcfg), j_build(jcfg)
    return {"params": (tm.param_specs(), jm.param_specs()),
            "serve": (serve_param_specs(tcfg), j_serve_specs(jcfg)),
            "state": (make_train_state_specs(tcfg), j_state_specs(jcfg)),
            "cache": (tm.cache_specs(8, 128), jm.cache_specs(8, 128))}


@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_spec_maps_as_in_jax(arch, smoke):
    """Every leaf of param_specs, serve_param_specs, the train state's
    specs and cache_specs(8, 128): the same shape, logical axes and
    ``logical_to_spec`` under both rule sets as the JAX package."""
    n = 0
    for what, (tt, jt) in _spec_trees(arch, smoke).items():
        tl, jl = _tflat(tt), _jflat(jt)
        assert sorted(tl) == sorted(jl), what
        for path, ts in tl.items():
            js = jl[path]
            assert tuple(ts.shape) == tuple(js.shape) and tuple(ts.axes) == tuple(js.axes), path
            for name in RULES:
                got = part.logical_to_spec(ts.axes, getattr(part, name))
                assert got == tuple(jpart.logical_to_spec(js.axes, getattr(jpart, name))), \
                    (what, path, name)
            n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_inputs_and_abstract_params_match_jax(arch):
    """``batch_axes``, ``input_specs`` (shapes and dtypes against JAX's
    ShapeDtypeStructs) for every shape, and ``abstract_params``: ``meta``
    tensors of the reference's shapes and dtypes."""
    tm, jm = build_model(ARCHS[arch]), j_build(J_ARCHS[arch])
    for name, shape in SHAPES.items():
        assert tm.batch_axes(shape) == jm.batch_axes(J_SHAPES[name]), name
        got, want = tm.input_specs(shape), jm.input_specs(J_SHAPES[name])
        assert sorted(got) == sorted(want), name
        for k, t in got.items():
            assert t.device.type == "meta", (name, k)
            assert tuple(t.shape) == tuple(want[k].shape), (name, k)
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype), (name, k)
    got, want = _tflat(tm.abstract_params()), _jflat(jm.abstract_params())
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[path].shape)
        assert str(t.dtype).split(".")[-1] == str(want[path].dtype), path
    assert _tflat(abstract_params(tm.param_specs())).keys() == got.keys()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_dryrun_helpers_match_jax(arch):
    """``model_flops_for``, ``should_skip`` and ``_effective_rules`` for every
    shape on both production meshes."""
    for name, shape in SHAPES.items():
        jshape = J_SHAPES[name]
        assert dryrun.model_flops_for(ARCHS[arch], shape) == \
            j_dryrun.model_flops_for(J_ARCHS[arch], jshape)
        assert dryrun.should_skip(ARCHS[arch], shape) == \
            j_dryrun.should_skip(J_ARCHS[arch], jshape)
        for mesh, sizes in MESHES.items():
            stand_in = types.SimpleNamespace(shape=sizes)
            rules = part.RULES_MULTI_POD if "pod" in sizes else part.RULES_SINGLE_POD
            jrules = jpart.RULES_MULTI_POD if "pod" in sizes else jpart.RULES_SINGLE_POD
            got = dryrun._effective_rules(rules, shape, stand_in).mapping
            assert got == j_dryrun._effective_rules(jrules, jshape, stand_in).mapping, \
                (name, mesh)


def test_perf_variants_match_jax():
    assert perf.VARIANTS == j_perf.VARIANTS


def test_use_rules_nests_and_annotate_is_identity_without_rules():
    x = torch.ones(2, 3)
    assert part.annotate(x, "batch", None) is x
    assert part._state.rules is None and not part._state.active
    inner = part.ShardingRules({"batch": "model"})
    with part.use_rules(part.RULES_SINGLE_POD):
        assert part._state.rules is part.RULES_SINGLE_POD
        assert part.annotate(x, "batch", None) is x        # a plain tensor passes untouched
        with part.use_rules(inner):
            assert part._state.rules is inner
            assert part.logical_to_spec(("batch", None)) == ("model", None)
        assert part._state.rules is part.RULES_SINGLE_POD
        with part.use_rules(None):
            assert not part._state.active
        assert part._state.active
    assert part._state.rules is None and not part._state.active
    with pytest.raises(ValueError):
        part.logical_to_spec(("batch",))


def test_spec_for_uses_a_mesh_axis_once_and_placements_follow_the_mesh():
    rules = part.RULES_MULTI_POD
    assert rules.spec_for(("batch", "embed", "heads")) == (("pod", "data"), None, "model")
    assert rules.spec_for(("embed", "vocab")) == tuple(
        jpart.RULES_MULTI_POD.spec_for(("embed", "vocab")))
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    from torch.distributed.tensor import Replicate, Shard

    assert part.spec_to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert part.spec_to_placements((None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="not an axis"):
        part.spec_to_placements(("expert",), mesh)
    with pytest.raises(ValueError, match="order"):
        part.spec_to_placements((("data", "pod"),), mesh)


def _rows():
    rng = np.random.default_rng(0)
    rows = []
    for i, (arch, shape) in enumerate([("a", "train_4k"), ("b", "prefill_32k"),
                                       ("c", "decode_32k"), ("d", "long_500k")]):
        for mesh in ("16x16", "2x16x16"):
            t = rng.uniform(1e-6, 2.0, 3)
            row = {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                   "t_compute_s": t[0], "t_memory_s": t[1], "t_collective_s": t[2],
                   "bottleneck": ["compute", "memory", "collective"][int(np.argmax(t))],
                   "useful_flops_ratio": rng.uniform(), "roofline_fraction": rng.uniform(),
                   "memory_analysis": {"temp_GiB": rng.uniform(0, 9), "arg_GiB": 1.5},
                   "collectives": {"by_kind": {"all-gather": 3 * 2**30, "all-reduce": 0,
                                               "reduce-scatter": 2**29}},
                   "variant": "baseline"}
            if i == 3:
                row = {"arch": arch, "shape": shape, "mesh": mesh, "status": "skip",
                       "reason": "long_500k requires sub-quadratic attention (full-attn arch)"}
            rows.append(row)
    rows.append({"arch": "e", "shape": "train_4k", "mesh": "16x16", "status": "fail",
                 "error": "RuntimeError: boom", "variant": "seqpar"})
    return rows


def test_report_tables_equal_the_references():
    rows = _rows()
    for mesh in ("16x16", "2x16x16"):
        assert report.roofline_table(rows, mesh) == j_report.roofline_table(rows, mesh)
        assert report.collective_summary(rows, mesh) == j_report.collective_summary(rows, mesh)
    perf_rows = [r for r in rows if r["status"] != "skip"]
    assert report.perf_table(perf_rows) == j_report.perf_table(perf_rows)


def test_roofline_report_fields_with_h100_constants():
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
    r = RooflineReport(
        arch="a", shape="s", mesh="m", chips=256,
        flops=989e12, hbm_bytes=3.35e12, collective_bytes=450e9,
        collective_detail={}, model_flops=989e12 * 256,
    )
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 1.0) < 1e-9
    assert abs(r.t_collective - 1.0) < 1e-9
    assert r.useful_flops_ratio == 1.0
    assert r.roofline_fraction == 1.0
    assert r.row()["bottleneck"] in ("compute", "memory", "collective")


def test_gloo_cuda_collectives_registers_only_inside_its_block():
    """The CUDA kernels of ``_c10d_functional``'s all-gather, reduce-scatter
    and all-to-all are the port's inside ``gloo_cuda_collectives`` (once,
    however deeply nested) and torch's again after it, an error
    included."""
    import torch.distributed._functional_collectives  # noqa: F401  (defines the ops)

    ops = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single")

    def ours():
        return [op for op in ops if "partitioning.py" in
                torch._C._dispatch_dump(f"_c10d_functional::{op}")]

    assert ours() == []
    with part.gloo_cuda_collectives():
        assert ours() == list(ops)
        with part.gloo_cuda_collectives():
            assert ours() == list(ops)
        assert ours() == list(ops)
    assert ours() == []
    with pytest.raises(RuntimeError, match="inside"):
        with part.gloo_cuda_collectives():
            raise RuntimeError("inside")
    assert ours() == []
