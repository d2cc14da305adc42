"""Port parity: the sharding rules, meshes, the axis env's rule and the
elastic mesh (``distributed.sharding``, ``distributed.ctx``,
``launch.mesh``, ``fault_tolerance.elastic_mesh``).

The rules read only ``mesh.shape``, so both packages run on the same
``SimpleNamespace`` meshes (16 x 16 and 2 x 16 x 16, as the reference's
``tests/test_sharding.py``) in one process, on trees of the reference
converted with ``from_reference``.  The reference stacks an LM's layers
over a period axis and the port keeps one dict per layer, so the
reference's spec of a stacked leaf is compared without its leading None.
Every comparison is exact.

* ``linear_specs`` for every role of ``ROLE_RULES`` (divisible and not,
  with a bias, quantized);
* ``param_specs`` with ``fsdp`` on and off on reduced granite-8b and
  deepseek-moe trees under none, q8_0, q3_k and q4_0, stacked experts
  under ``moe_mode`` "ep" and "dp", and the AdamW moment trees with Q8_0
  moments (bare Q8_0 moments shard dim 0);
* ``cache_specs`` (long context at batch 1 too), ``batch_specs`` and
  ``heuristic_spec`` on shapes;
* ``ctx.pinned_spec`` against the spec the reference's ``constrain``
  pins (its ``with_sharding_constraint`` captured), for every cut point
  and ``expert_buf`` under both modes;
* ``local_shard`` over every rank of a mesh reassembles each leaf kind;
* the meshes' shapes and names, and ``elastic_mesh``'s shape and rank
  grid on 1, 256, 511 and 512 ranks (and its failure below
  ``model_parallel`` ranks, where the reference's fails too).
"""
import dataclasses
import itertools
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core.qlinear import Linear as JLinear  # noqa: E402
from repro.core.qlinear import init_linear as jinit_linear  # noqa: E402
from repro.core.qlinear import quantize_params as jquantize  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.distributed import ctx as jctx  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.core.qlinear import Linear  # noqa: E402
from repro_torch.core.quant import Q3KTensor, Q4_0Tensor, Q8_0Tensor  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.distributed import ctx as tctx  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.distributed.fault_tolerance import elastic_mesh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.mesh import AxisGroup  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch import weights  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)

MESH = types.SimpleNamespace(shape={"data": 16, "model": 16})
MESH3 = types.SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH, "2x16x16": MESH3}
MESH_EP = types.SimpleNamespace(shape={"data": 2, "model": 4})
KEY = jax.random.PRNGKey(0)
QNAMES = {"Q8_0Tensor": Q8_0Tensor, "Q4_0Tensor": Q4_0Tensor, "Q3KTensor": Q3KTensor}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16,
          "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32}


def _meta(tree):
    """A reference tree of ``ShapeDtypeStruct`` leaves (``jax.eval_shape``:
    the rules read shapes only) as the port's tree of empty ``meta``
    tensors, through ``from_reference``'s walk."""
    real = weights.to_tensor
    weights.to_tensor = lambda a, device=None: torch.empty(
        a.shape, dtype=DTYPES[str(a.dtype)], device="meta")
    try:
        return weights.from_reference(tree, device="meta")
    finally:
        weights.to_tensor = real


PERIOD_SHARDED = []     # stacked specs whose period entry is not None


def _spec(x, strip: int = 0):
    """The reference's spec tree in the port's types (``strip`` leading
    entries of each spec taken off: the period axis; one that shards it
    is recorded in PERIOD_SHARDED)."""
    if x is None:
        return None
    if isinstance(x, jax.sharding.PartitionSpec):
        parts = tuple(x)
        if any(p is not None for p in parts[:strip]):
            PERIOD_SHARDED.append(parts)
        return tsh.P(*parts[strip:])
    if isinstance(x, dict):
        return {k: _spec(v, strip) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return [_spec(v, strip) for v in x]
    if hasattr(x, "_fields"):
        return type(x)(*(_spec(v, strip) for v in x))
    if isinstance(x, JLinear):
        return Linear(w=_spec(x.w, strip), b=_spec(x.b, strip), role=x.role)
    cls = QNAMES[type(x).__name__]
    kw = {f.name: _spec(getattr(x, f.name), strip) for f in dataclasses.fields(x)
          if f.name not in ("logical", "scale_bits")}
    if cls is Q3KTensor:
        return Q3KTensor(**kw, scale_bits=x.scale_bits)
    return cls(**kw, logical=x.logical)


def _ref_tree_specs(jspecs, n_periods: int):
    """The reference's spec tree of an LM in the port's layout: the
    period-stacked ``layers`` (a list of ``period`` dicts) as
    ``n_periods * period`` per-layer dicts."""
    out = {k: _spec(v) for k, v in jspecs.items() if k != "layers"}
    per = [_spec(p, strip=1) for p in jspecs["layers"]]
    out["layers"] = [per[j] for _ in range(n_periods) for j in range(len(per))]
    return out


def _as_list(x):
    return x if isinstance(x, list) else list(x)


def _eq(got, want):
    """Exact equality of two spec trees (lists and tuples alike)."""
    if isinstance(got, tsh.P) or isinstance(want, tsh.P):
        assert isinstance(got, tsh.P) and isinstance(want, tsh.P), (got, want)
        assert tuple(got) == tuple(want), (got, want)
        return
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _eq(got[k], want[k])
        return
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(_as_list(got), _as_list(want)):
            _eq(a, b)
        return
    if dataclasses.is_dataclass(got):
        assert type(got) is type(want), (got, want)
        for f in dataclasses.fields(got):
            _eq(getattr(got, f.name), getattr(want, f.name))
        return
    assert got == want, (got, want)


# ------------------------------------------------------------- linears

SHAPES = [(4096, 8192), (8192, 4096), (100, 24), (24, 256), (2048, 4096), (512, 128)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("role", sorted(jsh.ROLE_RULES))
def test_linear_specs_every_role(role, mesh):
    assert tsh.ROLE_RULES == jsh.ROLE_RULES
    m = MESHES[mesh]
    for i, (k, n) in enumerate(SHAPES):
        lin = jax.eval_shape(lambda key: jinit_linear(key, k, n, role=role, bias=bool(i % 2)),
                             KEY)
        _eq(tsh.linear_specs(_meta(lin), m), _spec(jsh.linear_specs(lin, m)))
        if k % 32 == 0:
            q = jax.eval_shape(lambda w: jquantize(w, jpolicy.Q8_0_POLICY), lin)
            _eq(tsh.linear_specs(_meta(q), m), _spec(jsh.linear_specs(q, m)))


def test_spec_type_matches_partition_spec():
    P, JP = tsh.P, jax.sharding.PartitionSpec
    for parts in [(), (None, None), ("data",), (("data",), None), (("pod", "data"), "model")]:
        assert tuple(P(*parts)) == tuple(JP(*parts))
    assert P() != P(None, None) and P(None) != P()
    assert P(("data",), None) == P("data", None)


# ---------------------------------------------------------- param trees

@pytest.fixture(scope="module")
def trees():
    """(arch, preset) -> (reference parameter shapes, period count):
    reduced configs at d_model 256 (Q3_K needs K % 256 == 0)."""
    out = {}
    for arch in ("granite-8b", "deepseek-moe-16b"):
        cfg = jreduced(jget_config(arch), d_model=256)
        base = jax.eval_shape(lambda key: jT.init_lm(key, cfg), KEY)
        n_periods = cfg.num_layers // len(cfg.block_pattern)
        for preset in ("none", "q8_0", "q3_k", "q4_0"):
            if preset == "q4_0" and cfg.moe is not None:
                continue            # the reference cannot run MoE under q4_0
            jp = base if preset == "none" else jax.eval_shape(
                lambda p: jquantize(p, jpolicy.get_policy(preset)), base)
            out[arch, preset] = (jp, n_periods)
    return out


TREE_CASES = [(a, p) for a in ("granite-8b", "deepseek-moe-16b")
              for p in ("none", "q8_0", "q3_k", "q4_0")
              if not (p == "q4_0" and a == "deepseek-moe-16b")]


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,preset", TREE_CASES)
def test_param_specs(trees, arch, preset, mesh, fsdp):
    jp, n_periods = trees[arch, preset]
    m = MESHES[mesh]
    PERIOD_SHARDED.clear()
    want = _ref_tree_specs(jsh.param_specs(jp, m, fsdp=fsdp), n_periods)
    assert not PERIOD_SHARDED
    tp = _meta(jp)
    got = tsh.param_specs(tp, m, fsdp=fsdp)
    _eq(got, want)
    assert len(tsh.spec_leaves(got)) == len(tree_leaves(
        tp, is_leaf=lambda x: isinstance(x, (Q8_0Tensor, Q4_0Tensor, Q3KTensor))))
    flat = [e for sp in tree_leaves(got, is_leaf=tsh.is_spec) for e in sp]
    assert any("data" in tsh._axes(e) for e in flat) == fsdp


@pytest.mark.parametrize("moe_mode", ["ep", "dp"])
@pytest.mark.parametrize("preset", ["none", "q8_0"])
def test_stacked_experts_under_moe_mode(trees, moe_mode, preset):
    """On 16 x 16 (4 experts: ``model`` does not divide them) and on
    data 2 x model 4, where EP shards the expert axis."""
    jp, n_periods = trees["deepseek-moe-16b", preset]
    tp = _meta(jp)
    for m in (MESH, MESH_EP):
        with jctx.axis_env(m, moe_mode=moe_mode):
            want = _ref_tree_specs(jsh.param_specs(jp, m), n_periods)
        with tctx.axis_env(m, moe_mode=moe_mode):
            got = tsh.param_specs(tp, m)
        _eq(got, want)
    up = got["layers"][0]["moe"]["w_up"].w
    up = up.qs if preset == "q8_0" else up
    assert tuple(up) == (("model", None, "data") if moe_mode == "ep" else (None, None, "data"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["granite-8b", "deepseek-moe-16b"])
def test_quantized_moment_specs(trees, arch, mesh):
    """AdamW's Q8_0 moments: a Linear's moment takes the weight's rules,
    a bare one (norms) shards dim 0 over every axis that divides it."""
    jp, n_periods = trees[arch, "none"]
    m = MESHES[mesh]
    jo = jax.eval_shape(lambda p: jadam.init_adam(p, JTrainConfig(quantized_moments=True)), jp)
    to = tadam.init_adam(_meta(jp), TrainConfig(quantized_moments=True))
    for name in ("m", "v"):
        PERIOD_SHARDED.clear()
        want = _ref_tree_specs(jsh.param_specs(getattr(jo, name), m), n_periods)
        got = tsh.param_specs(getattr(to, name), m)
        _eq(got, want)
        # The one divergence: the reference shards a layer's norm moment
        # over its period axis where the period count (2) divides an axis
        # (pod on 2 x 16 x 16); the port's per-layer leaf stays replicated.
        assert set(PERIOD_SHARDED) == (set() if mesh == "16x16" else {("pod", None)})
    final = next(iter(got["final_norm"].values()))
    assert isinstance(final, Q8_0Tensor) and tuple(final.qs)[0] is not None
    bare = [x for x in tree_leaves(got["layers"][0], is_leaf=lambda x: isinstance(
        x, (Linear, Q8_0Tensor))) if isinstance(x, Q8_0Tensor)]
    assert bare and all(tuple(b.qs) == (None,) and tuple(b.d) == (None,) for b in bare)


# ------------------------------------------------- caches, batches, greedy

CACHE_SHAPES = [(9, 1, 8, 4096, 128), (4, 128, 8, 4096, 128), (2, 32, 4, 64, 16),
                (3, 256, 16, 32), (5, 2, 12), (7,), (4, 1, 8, 500000, 128)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_and_batch_specs(mesh):
    m = MESHES[mesh]
    # The last shape is a long context at batch 1.  The rules read shapes.
    jc = {f"c{i}": jax.ShapeDtypeStruct(s, jnp.bfloat16) for i, s in enumerate(CACHE_SHAPES)}
    tc = {k: torch.empty(v.shape, device="meta") for k, v in jc.items()}
    _eq(tsh.cache_specs(tc, m), _spec(jsh.cache_specs(jc, m)))
    for b in (1, 2, 3, 16, 32, 48, 256, 512):
        jb = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in (
            ("tokens", (b, 7)), ("labels", (b, 7)), ("prefix_embeds", (b, 8, 4)), ("pos", ()))}
        tb = {k: np.zeros(v.shape) for k, v in jb.items()}
        _eq(tsh.batch_specs(tb, m), _spec(jsh.batch_specs(jb, m)))


def test_heuristic_spec():
    shapes = [(1, 8, 4096, 128), (64, 2048), (3, 5, 7), (32, 16, 16), (256, 512, 2), (16,)]
    for m in MESHES.values():
        for s in shapes:
            for skip in ((), (0,), (0, 1)):
                _eq(tsh.heuristic_spec(s, m, skip_dims=skip),
                    _spec(jsh.heuristic_spec(s, m, skip_dims=skip)))


# ----------------------------------------------------------- axis env

CUT_POINTS = ["act", "heads", "heads_q", "ffn", "vocab", "experts", "expert_buf",
              "kv_cache", "paged_kv", "decode_logits"]
PORT_RULE = {"act": {0: "dp"}, "heads": {0: "dp", 1: "tp"}, "ffn": {0: "dp", 2: "tp"},
             "vocab": {0: "dp", 2: "tp"}, "experts": {0: "tp"}, "kv_cache": {0: "dp", 2: "tp"},
             "paged_kv": {1: "tp"}, "decode_logits": {0: "dp", 3: "tp"}}


TP_DIMS = {"heads": 1, "heads_q": 1, "ffn": 2, "vocab": 2, "expert_buf": 1}


@pytest.mark.parametrize("moe_mode", ["ep", "dp"])
def test_pinned_spec_is_the_references_constraint(monkeypatch, moe_mode):
    """The reference's cut points with ``with_sharding_constraint``
    captured give the spec ``ctx.pinned_spec`` computes; the port's cut
    points give this rank's range of their dim where that spec puts the
    tp axis on it under tensor-parallel compute (rank 1 of the axis here),
    the whole dim elsewhere and without it (``heads_q``: the query-position
    split is not ported, so only a head split counts)."""
    monkeypatch.setattr(jctx, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: spec)
    shapes = [(32, 16, 128, 64), (48, 20, 64, 64), (16, 4, 8, 32), (3, 16, 16, 4096),
              (256, 4096, 49152), (64, 128, 2048)]
    for m, shape in itertools.product(MESHES.values(), shapes):
        x = jax.ShapeDtypeStruct(shape, jnp.bfloat16)      # the rule reads the shape
        with jctx.axis_env(m, moe_mode=moe_mode):
            want = {c: getattr(jctx, c)(x) for c in CUT_POINTS}
        with tctx.axis_env(m, moe_mode=moe_mode):
            got = {c: tctx.pinned_spec(shape, PORT_RULE[c]) for c in PORT_RULE}
            got["expert_buf"] = tctx.pinned_spec(
                shape, {0: "dp"} if moe_mode == "dp" else {0: "dp", 1: "tp"})
            assert all(getattr(tctx, c)(shape) == slice(0, shape[d]) for c, d in TP_DIMS.items())
        n = m.shape["model"]
        inner = tctx.tp_group
        tctx.tp_group = lambda: AxisGroup(None, n, 1, tuple(range(n)))
        try:
            with tctx.axis_env(m, moe_mode=moe_mode, tp_compute=True):
                for c, d in TP_DIMS.items():
                    on = _spec(want[c])[d:d + 1] == ("model",)
                    size = shape[d] // n
                    assert getattr(tctx, c)(shape) == (slice(size, 2 * size) if on
                                                       else slice(0, shape[d])), (c, shape)
        finally:
            tctx.tp_group = inner
        for c, spec in got.items():
            _eq(spec, _spec(want[c]))
    assert tctx.pinned_spec((4, 4), {0: "dp"}) is None       # no env


# ------------------------------------------------------- local slices

def _leaves_of_every_kind():
    gen = torch.Generator().manual_seed(0)
    from repro_torch.core import quant
    w = torch.randn((64, 512), generator=gen)
    return {"bf16": (w.to(torch.bfloat16), tsh.P("model", "data")),
            "q8": (quant.quantize_q8_0(w), None), "q4": (quant.quantize_q4_0(w), None),
            "q3k": (quant.quantize_q3_k(w), None),
            "bare": (quant.quantize_q8_0(torch.randn(256, generator=gen)), None)}


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 1), (2, 1, 4)])
def test_local_shards_reassemble(shape):
    """Every rank's slice under the rules' own specs, put back by grid
    position, is each leaf (bf16, Q8_0, Q4_0, Q3_K, a bare Q8_0 moment)."""
    m = tmesh.Mesh(np.arange(np.prod(shape)).reshape(shape), ("pod", "data", "model"))
    for name, (leaf, spec) in _leaves_of_every_kind().items():
        if name == "bare":
            spec = tsh.param_specs({"g": leaf}, m)["g"]
        elif spec is None:
            spec = tsh.linear_specs(Linear(leaf, role="mlp_up"), m).w
        for arr, sp in zip(*tsh._fields(leaf, spec)):
            pieces = {}
            for rank in range(m.size):
                coords = m.coords(rank)
                key = tuple(tsh._dim_slot(e, m, coords)[0] for e in sp)
                pieces[key] = tsh.local_shard(arr, sp, m, coords)
            counts = [tsh._dim_slot(e, m, m.coords(0))[1] for e in sp]
            grid = np.empty(counts, dtype=object)
            for key, piece in pieces.items():
                grid[key] = piece

            def join(g, dim=0):
                if dim == len(counts) - 1:
                    return torch.cat(list(g), dim)
                return torch.cat([join(sub, dim + 1) for sub in g], dim)
            whole = join(grid) if counts else arr
            assert torch.equal(whole, arr), (name, sp)
        one = elastic_mesh(model_parallel=1)             # 1 x 1 x 1: nothing is cut
        cut = tsh.local_shard(leaf, spec, one, one.coords(0))
        assert cut is leaf or all(getattr(cut, f) is getattr(leaf, f) for f in tsh._arrays(leaf))


# ---------------------------------------------------------------- meshes

def test_meshes():
    smoke, ref = tmesh.make_smoke_mesh(), jmesh.make_smoke_mesh()
    assert smoke.axis_names == tuple(ref.axis_names) and smoke.shape == dict(ref.shape)
    prod, multi = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True)
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert multi.coords(511) == {"pod": 1, "data": 15, "model": 15}
    assert multi.coords(17) == {"pod": 0, "data": 1, "model": 1}


@pytest.mark.parametrize("n,model_parallel,pod_size", [
    (1, 1, 1), (1, 1, 256), (2, 1, 256), (4, 2, 256), (256, 16, 256), (511, 16, 256),
    (512, 16, 256), (300, 16, 256), (8, 2, 4)])
def test_elastic_mesh_matches_reference(n, model_parallel, pod_size):
    ranks = np.arange(n)
    ref = jft.elastic_mesh(ranks, model_parallel=model_parallel, pod_size=pod_size)
    got = elastic_mesh(ranks, model_parallel=model_parallel, pod_size=pod_size)
    assert got.shape == dict(ref.shape) and got.axis_names == tuple(ref.axis_names)
    np.testing.assert_array_equal(got.devices, np.asarray(ref.devices))


@pytest.mark.parametrize("n", [2, 4, 15])
def test_elastic_mesh_fails_where_the_reference_fails(n):
    """Fewer ranks than ``model_parallel``: ``data`` is floored at 1 and
    the grid wants 16 ranks; both reshape and raise."""
    with pytest.raises(ValueError):
        jft.elastic_mesh(np.arange(n), model_parallel=16, pod_size=256)
    with pytest.raises(ValueError):
        elastic_mesh(np.arange(n), model_parallel=16, pod_size=256)
    assert elastic_mesh(model_parallel=1).shape == {"pod": 1, "data": 1, "model": 1}
