"""The port's sharding decisions against JAX's, spec by spec.

Neither side needs devices: JAX resolves specs on
``jax.sharding.AbstractMesh`` (16 x 16 and 2 x 16 x 16) or on a mesh
stand-in whose ``shape`` maps axis names to sizes, the port on the same
stand-in. Every comparison is exact: the port's ``P`` entries equal
JAX's ``PartitionSpec`` entries.

* ``logical_to_spec`` under the default, dp-all and megatron rules on
  16 x 16, 2 x 16 x 16 and 1 x 4, over logical axes and dims drawn by
  hypothesis;
* ``_spec_for_param`` and ``param_shardings(..., zero_axis="data")`` for
  every parameter leaf of all ten archs at full width;
* ``params_shardings_for`` in all four modes, policy string included;
* ``cache_shardings`` for every leaf of each decode cell's cache;
* ``train_batch_shardings`` in both batch modes, ``token_sharding``,
  ``batch_spec``;
* ``Optimizer.state_shardings`` (ZeRO-1);
* ``spec_to_placements`` on a ``DeviceMesh`` and the source rule that
  only the dry run, the roofline and the mesh helper reach the fake
  process group.
"""

from __future__ import annotations

from pathlib import Path

import jax
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.distributed import optimizer as jopt
from repro.distributed import sharding as jsh
from repro.launch import cell_shardings as jcs
from repro.models.registry import abstract_params as jabstract_params
from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs, \
    shape_applicable
from repro_torch.distributed import optimizer as topt
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import cell_shardings as tcs
from repro_torch.models.registry import abstract_params

ROOT = Path(__file__).resolve().parents[1]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x4": {"data": 1, "model": 4}}
ABSTRACT = {"16x16": ((16, 16), ("data", "model")),
            "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LOGICAL = ["batch", "data", "model", "expert", "residual", "zero", None]
DIMS = [1, 2, 3, 4, 8, 9, 12, 16, 24, 32, 48, 64, 96, 256, 4096, 5120,
        49152, 2 * 16 * 7]


def _jmesh(name):
    shape, axes = ABSTRACT[name]
    return AbstractMesh(shape, axes)


def _spec(s):
    return tuple(s)


def _jflat(tree):
    """{path: leaf} of a JAX tree, paths as ``param_shardings`` joins
    them."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): leaf for kp, leaf in flat}


def _tflat(tree):
    return dict(tsh.tree_paths(tree))


@settings(max_examples=200, deadline=None)
@given(mode=st.sampled_from(["default", "dp-all", "megatron"]),
       mesh=st.sampled_from(sorted(MESHES)),
       axes=st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=5),
       dims=st.lists(st.sampled_from(DIMS), min_size=5, max_size=5))
def test_logical_to_spec_equals_jax(mode, mesh, axes, dims):
    m = _FakeMesh(MESHES[mesh])
    dims = dims[:len(axes)]
    with jsh.logical_mode(mode), tsh.logical_mode(mode):
        want = jsh.logical_to_spec(axes, dims, m)
        got = tsh.logical_to_spec(axes, dims, m)
    assert _spec(got) == _spec(want)


@pytest.mark.parametrize("mesh", sorted(ABSTRACT))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_on_every_leaf(arch, mesh):
    jm, tm = _jmesh(mesh), _FakeMesh(MESHES[mesh])
    jp = _jflat(jabstract_params(jget_config(arch)))
    tp = _tflat(abstract_params(get_config(arch)))
    assert sorted(jp) == sorted(tp)
    for path, leaf in tp.items():
        assert tuple(leaf.shape) == tuple(jp[path].shape), path
        assert _spec(tsh._spec_for_param(path, tuple(leaf.shape), tm)) == \
            _spec(jsh._spec_for_param(path, jp[path].shape, jm)), path
    _, want = jsh.param_shardings(jabstract_params(jget_config(arch)), jm,
                                  zero_axis="data")
    _, got = tsh.param_shardings(abstract_params(get_config(arch)), tm,
                                 zero_axis="data")
    assert sorted(got) == sorted(want)
    for path in got:
        assert _spec(got[path].spec) == _spec(want[path].spec), path


@pytest.mark.parametrize("mode", ["train", "serve", "replicated", "serve-2d"])
@pytest.mark.parametrize("mesh", sorted(ABSTRACT))
def test_params_shardings_for_equals_jax(mesh, mode):
    jm, tm = _jmesh(mesh), _FakeMesh(MESHES[mesh])
    for arch in ARCHS:
        jtree, jpolicy = jcs.params_shardings_for(
            jget_config(arch), jm, jabstract_params(jget_config(arch)),
            mode=mode)
        ttree, tpolicy = tcs.params_shardings_for(
            get_config(arch), tm, abstract_params(get_config(arch)),
            mode=mode)
        assert tpolicy == jpolicy, arch
        want, got = _jflat(jtree), _tflat(ttree)
        assert sorted(got) == sorted(want), arch
        for path in got:
            assert _spec(got[path].spec) == _spec(want[path].spec), \
                (arch, path)


@pytest.mark.parametrize("mesh", sorted(ABSTRACT))
def test_cache_shardings_equal_jax(mesh):
    jm, tm = _jmesh(mesh), _FakeMesh(MESHES[mesh])
    n = 0
    for arch in ARCHS:
        for name in ("decode_32k", "long_500k"):
            cfg = get_config(arch)
            if not shape_applicable(cfg, SHAPES[name])[0]:
                continue
            jcache = jinput_specs(jget_config(arch), JSHAPES[name])["cache"]
            tcache = input_specs(cfg, SHAPES[name])["cache"]
            want = _jflat(jcs.cache_shardings(jget_config(arch), jm, jcache))
            got = _tflat(tcs.cache_shardings(cfg, tm, tcache))
            assert sorted(got) == sorted(want), (arch, name)
            for path in got:
                assert _spec(got[path].spec) == _spec(want[path].spec), \
                    (arch, name, path)
                n += 1
    assert n > 40


@pytest.mark.parametrize("mode", ["default", "dp-all"])
@pytest.mark.parametrize("mesh", sorted(ABSTRACT))
def test_batch_shardings_equal_jax(mesh, mode):
    jm, tm = _jmesh(mesh), _FakeMesh(MESHES[mesh])
    for arch in ARCHS:
        for name in ("train_4k", "prefill_32k"):
            jspecs = jinput_specs(jget_config(arch), JSHAPES[name])
            tspecs = input_specs(get_config(arch), SHAPES[name])
            want = jcs.train_batch_shardings(jm, jspecs, mode=mode)
            got = tcs.train_batch_shardings(tm, tspecs, mode=mode)
            assert sorted(got) == sorted(want)
            for k in got:
                assert _spec(got[k].spec) == _spec(want[k].spec), (arch, k)
    for b in (1, 2, 32, 128, 256, 512, 3):
        assert _spec(tcs.token_sharding(tm, b).spec) == \
            _spec(jcs.token_sharding(jm, b).spec)
    assert _spec(tsh.batch_spec(tm)) == _spec(jsh.batch_spec(jm))


@pytest.mark.parametrize("mesh", sorted(ABSTRACT))
def test_optimizer_state_shardings_equal_jax(mesh):
    jm, tm = _jmesh(mesh), _FakeMesh(MESHES[mesh])
    for arch in ("smollm-135m", "grok-1-314b", "mamba2-2.7b",
                 "whisper-large-v3", "zamba2-1.2b"):
        want = jopt.Optimizer().state_shardings(
            jabstract_params(jget_config(arch)), jm)
        got = topt.Optimizer().state_shardings(
            abstract_params(get_config(arch)), tm)
        assert _spec(got["step"].spec) == _spec(want["step"].spec) == ()
        for key in ("m", "v"):
            w, g = _jflat(want[key]), _tflat(got[key])
            assert sorted(g) == sorted(w)
            for path in g:
                assert _spec(g[path].spec) == _spec(w[path].spec), \
                    (arch, key, path)


def test_spec_to_placements_on_a_device_mesh():
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 4, 1)

        def size(self, i):
            return self.shape[i]

    m = _Mesh()
    assert tsh.axis_sizes(m) == {"pod": 2, "data": 4, "model": 1}
    assert tsh.spec_to_placements(tsh.P(("pod", "data"), None, "model"),
                                  m) == (Shard(0), Shard(0), Replicate())
    assert tsh.spec_to_placements(tsh.P(None, "data"), m) == \
        (Replicate(), Shard(1), Replicate())


def test_constrain_is_identity_without_a_mesh():
    import torch
    x = torch.arange(6.0).reshape(2, 3)
    assert tsh.constrain(x, "batch", "model") is x
    with tsh.mesh_context(_FakeMesh(MESHES["16x16"])):
        assert tsh.constrain(x, "batch", "model") is x   # a plain tensor


def test_only_the_dry_run_and_mesh_reach_the_fake_group():
    allowed = {"launch/dryrun.py", "launch/roofline.py", "launch/mesh.py"}
    src = ROOT / "src" / "repro_torch"
    hits = {str(p.relative_to(src)) for p in src.rglob("*.py")
            if "fake_pg" in p.read_text()}
    assert hits <= allowed and "launch/mesh.py" in hits, hits
    assert "fake_pg" not in (ROOT / "chip_smoke.py").read_text()
