"""Port parity: per-layer parameter gathers in the sharded train step
(ZeRO-3, ``distributed.fsdp``).

Spawned gloo worlds (a ``FileStore`` under ``tmp_path``; the ranks are
this file run as a script, without JAX), as ``test_torch_dist.py`` does:
2 ranks as data 2, 2 as model 2 and 4 as data 2 x model 2, reduced
granite-8b at f32 from the reference's ``init_lm`` parameters, batch 4 x
16.

* (a) At data 2 without microbatches each rank's gradient slices are bit
  for bit the ``local_shard`` of the whole gradient averaged as the step
  averaged it before the per-layer gathers: ``value_and_grad`` of the
  step's loss on the gathered tree and this rank's rows, all-reduced in
  f32 over ``data`` and divided by 2 (f32 a + b is commutative), for
  granite-8b and deepseek-moe-16b (under "dp", its experts gathered).
* (b) Under remat "none", "block" and "full", at data 2 and at data 2 x
  model 2, for a tied head at data 2, and with bf16 weights under "none"
  at data 2 x model 2 (where no f32 copy of a gathered weight may be
  saved for the backward: ``_Live.copies``): the bytes of gathered arrays
  alive on a rank (counted by finalizers on the storages of every array
  that ``sharding._gather_arrays`` returns) never exceed the largest one
  gather (a period, the embedding or the head), beside the rank's
  slices; the whole tree's (the step before this one gathered it all at
  once) is well above.  Per step exactly 2 L + 3 packed all-gathers
  (forward: the embedding, L periods, the head; backward: the head and L
  periods again) and L + 2 reduce-scatters (L periods, the head, the
  embedding; a tied head adds into the embedding's), as the step's own
  ``stats`` count them too.
* (c) The data-2 world against the reference's train step
  (``repro.train.train_step.make_train_step``, jitted) on the same
  parameters and batches: 3 steps, plain under remat "none" and "block"
  and microbatch 2 under "none", within the limits of
  ``test_torch_dist.test_single_process_moe_run_matches_reference`` (the
  loss within 1e-6, ``_check_run``).
* (d) The control: with each reduce-scatter a cut of the rank's own
  gradient (no sum over ``data``) the same run misses those limits.
* The families whose FSDP axes include ``model`` (reduced xlstm-1.3b and
  whisper-large-v3, the port's ``init_lm`` at f32): 2 steps under remat
  "none" and "block" in the data-2 and model-2 worlds against the
  single-process step, at model 2 bit for bit.
"""
import dataclasses
import datetime
import os
import subprocess
import sys
import traceback
import weakref
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

if __name__ != "__main__":          # the gloo ranks this file spawns run without JAX
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp  # noqa: E402

    from repro.configs import base as jbase  # noqa: E402
    from repro.configs import get_config as jget_config  # noqa: E402
    from repro.configs import reduced as jreduced  # noqa: E402
    from repro.models import transformer as jT  # noqa: E402
    from repro.optim import adamw as jadam  # noqa: E402
    from repro.train import train_step as jts  # noqa: E402
    from repro_torch.weights import from_reference  # noqa: E402
    from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)
    from test_torch_dist import _check_run, _rel  # noqa: E402

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import TrainConfig, get_config, reduced, smoke_inputs  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.distributed import ctx as tctx  # noqa: E402
from repro_torch.distributed import fsdp, sharding, tp  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_smoke_mesh  # noqa: E402
from repro_torch.models.transformer import init_lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.train_step import make_loss_fn, make_train_step, value_and_grad  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
AXES = ("pod", "data", "model")
SPAWNS = {"data2": (1, 2, 1), "model2": (1, 1, 2), "data2model2": (1, 2, 2)}
ARCHS = ("granite-8b", "deepseek-moe-16b")
# The families whose FSDP axes include ``model`` (no tensor-parallel
# compute): their runs in the data-2 and model-2 worlds.
FAMILY_ARCHS = ("xlstm-1.3b", "whisper-large-v3")
FAMILY_SPAWNS = ("data2", "model2")
BATCH, SEQ, STEPS = 4, 16, 3
REMATS = ("none", "block", "full")
HW_SPAWNS = ("data2", "data2model2")
FAMILY_REMATS = ("none", "block")
# Held for 2 steps: at data 2, whisper's first encoder layer's wk takes
# AdamW's update the other way at step 2 in 20 of 789,504 elements (f32
# gradients of about 1e-7, where the keys' shift invariance cancels the
# sum; each within 2 lr), and step 3 carries them into the loss (3.9e-6)
# and grad_norm (2.0e-5).
FAMILY_STEPS = 2
REF_CASES = {"plain-none": ("none", {}), "plain-block": ("block", {}),
             "microbatch-none": ("none", {"microbatch": 2})}


# ------------------------------------------------ shared with the ranks

def _batch(cfg, i: int) -> dict:
    rng = np.random.default_rng(200 + i)
    out = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, SEQ)))
           for k in ("tokens", "labels")}
    if cfg.family == "audio":
        out["enc_embeds"] = smoke_inputs(200 + i, cfg, batch=BATCH, seq=SEQ)["enc_embeds"]
    return out


def _copy(tree):
    return tree_map(lambda t: t.clone(), tree)


def _cfg(arch: str, tied: bool = False):
    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, tie_embeddings=True) if tied else cfg


def _tied(params: dict) -> dict:
    return {k: v for k, v in params.items() if k != "lm_head"}


def _family_init(arch: str) -> dict:
    """The port's ``init_lm`` parameters of the reduced config, f32."""
    params = init_lm(torch.Generator().manual_seed(0), reduced(get_config(arch)))
    return tree_map(lambda t: t.float() if t.is_floating_point() else t, params)


def _bits(arch: str, init: dict, mesh) -> list:
    """(a): [(leaf index, the step's gradient slice equals the averaged
    whole gradient's slice)] on this rank."""
    cfg, tc = _cfg(arch), TrainConfig(remat="none")
    params = _copy(init[arch])
    with tctx.axis_env(mesh, moe_mode="dp"):
        step = make_train_step(cfg, tc, device="cpu", mesh=mesh)
        p, _ = step.shard(params, adamw.init_adam(params, tc))
        batch = _batch(cfg, 0)
        _, got = step._grads(p, batch)
        local, axes = step._rows(batch)
        assert axes == ("data",)
        whole = sharding.gather_tree(p, step.specs[0], mesh)
        with tctx.axis_env(mesh, moe_mode="dp", batch_axes=axes):
            _, want = value_and_grad(make_loss_fn(cfg, tc))(whole, local)
    out = []
    for i, (g, w, sp) in enumerate(zip(tree_leaves(got), tree_leaves(want),
                                       sharding.spec_leaves(step.specs[0]))):
        w = w.float()
        dist.all_reduce(w, group=mesh.group("data"))
        w = sharding.local_shard((w / 2).to(g.dtype), sp, mesh, mesh.own_coords())
        out.append((i, g.dtype == w.dtype and torch.equal(g, w)))
    return out


class _Live:
    """Count the bytes of every array ``sharding._gather_arrays`` returns
    while they live (finalizers on their storages), the high-water mark,
    the largest one call, the packed all-gathers (uint8 buffers) and
    reduce-scatters issued, and ``copies``: the bytes of f32 tensors
    saved for the backward, past the step's saved-tensor hooks, in the
    shape of a gathered bf16 array or of its transpose (an f32 copy of a
    gathered weight, which would stay alive until the backward)."""

    def __enter__(self):
        self.live = self.peak = self.largest = self.copies = 0
        self.gathers = self.scatters = 0
        self.shapes = set()
        self.inner = (sharding._gather_arrays, dist.all_gather, dist.reduce_scatter,
                      fsdp.Gathers._pack)
        inner_ga, inner_ag, inner_rs, inner_pack = self.inner

        def freed(n):
            self.live -= n

        def gather_arrays(*a, **k):
            out = inner_ga(*a, **k)
            total = 0
            for w in out:
                n = w.numel() * w.element_size()
                total += n
                weakref.finalize(w.untyped_storage(), freed, n)
                if w.dtype != torch.float32:
                    self.shapes.add(tuple(w.shape))
            self.live += total
            self.largest = max(self.largest, total)
            self.peak = max(self.peak, self.live)
            return out

        def all_gather(parts, x, *a, **k):
            self.gathers += x.dtype == torch.uint8
            return inner_ag(parts, x, *a, **k)

        def reduce_scatter(*a, **k):
            self.scatters += 1
            return inner_rs(*a, **k)

        def pack(g, t):
            out = inner_pack(g, t)
            if out is t and t.dtype == torch.float32 and (
                    tuple(t.shape) in self.shapes or tuple(t.shape)[::-1] in self.shapes):
                self.copies += t.numel() * t.element_size()
            return out
        (sharding._gather_arrays, dist.all_gather, dist.reduce_scatter,
         fsdp.Gathers._pack) = (gather_arrays, all_gather, reduce_scatter, pack)
        return self

    def __exit__(self, *exc):
        (sharding._gather_arrays, dist.all_gather, dist.reduce_scatter,
         fsdp.Gathers._pack) = self.inner


def _high_water(init: dict, mesh, remat: str, tied: bool = False,
                dtype=torch.float32) -> dict:
    """(b): one step of granite-8b under ``remat`` with ``dtype``
    parameters: the live gathered bytes' high-water mark, the largest
    gather, the whole tree's bytes over the FSDP axes, the collectives,
    the f32 copies of gathered arrays saved for the backward and the
    step's own stats."""
    cfg, tc = _cfg("granite-8b", tied), TrainConfig(remat=remat)
    params = tree_map(lambda t: t.to(dtype, copy=True), init["granite-8b"])
    if tied:
        params = _tied(params)
    with tctx.axis_env(mesh):
        step = make_train_step(cfg, tc, device="cpu", mesh=mesh)
        p, o = step.shard(params, adamw.init_adam(params, tc))
        work = sharding.gather_tree(p, sharding.over(step.specs[0], step.fsdp_axes), mesh)
        whole = sum(t.numel() * t.element_size() for t in tree_leaves(work))
        slices = sum(t.numel() * t.element_size() for t in tree_leaves(p))
        del work
        with _Live() as live:
            _, _, _, m = step(p, o, None, _batch(cfg, 0))
    st = step.stats
    return {"peak": live.peak, "largest": live.largest, "whole": whole, "slices": slices,
            "gathers": live.gathers, "scatters": live.scatters, "layers": cfg.num_layers,
            "copies": live.copies,
            "stats": (st.gathers, st.scatters, st.peak), "loss": float(m["loss"])}


def _cut_only(x: torch.Tensor, g, dim: int) -> torch.Tensor:
    """``tp.reduce_scatter`` without its sum (the control): this rank's
    slice of its own ``x``."""
    n = x.shape[dim] // g.size
    return x.narrow(dim, g.rank * n, n).clone()


def _run(init: dict, mesh, remat: str, option: dict, arch: str = "granite-8b",
         steps: int = STEPS) -> list:
    """[(metrics, whole params, whole opt state, None)] after each of
    ``steps`` steps of ``arch`` on ``mesh`` (None: the single-process step
    under a one-rank env)."""
    cfg, tc = _cfg(arch), TrainConfig(remat=remat, **option)
    params = _copy(init[arch])
    opt = adamw.init_adam(params, tc)
    out = []
    with tctx.axis_env(mesh or make_smoke_mesh()):
        step = make_train_step(cfg, tc, device="cpu", mesh=mesh)
        if mesh is not None:
            params, opt = step.shard(params, opt)
        for i in range(steps):
            params, opt, _, m = step(params, opt, None, _batch(cfg, i))
            whole = (params, opt) if mesh is None else step.gather(params, opt)
            out.append(({k: float(v) for k, v in m.items()}, _copy(whole[0]),
                        _copy(whole[1]), None))
    return out


def _rank_main(rank: int, spawn: str, store: str, out: str, init_path: str) -> None:
    shape = SPAWNS[spawn]
    world = int(np.prod(shape))
    torch.set_num_threads(1)
    init = torch.load(init_path, weights_only=False)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    mesh = Mesh(np.arange(world).reshape(shape), AXES)
    res = {}
    if spawn in HW_SPAWNS:
        res.update({("high_water", remat): _high_water(init, mesh, remat) for remat in REMATS})
    if spawn == "data2model2":
        res["high_water", "none-bf16"] = _high_water(init, mesh, "none", dtype=torch.bfloat16)
    if spawn in FAMILY_SPAWNS:
        for arch in FAMILY_ARCHS:
            for remat in FAMILY_REMATS:
                res["family", arch, remat] = _run(init, mesh, remat, {}, arch, FAMILY_STEPS)
    if spawn == "data2":
        res["high_water", "tied"] = _high_water(init, mesh, "none", tied=True)
        for arch in ARCHS:
            res["bits", arch] = _bits(arch, init, mesh)
        for name, (remat, option) in REF_CASES.items():
            res["ref", name] = _run(init, mesh, remat, option)
        inner, tp.reduce_scatter = tp.reduce_scatter, _cut_only
        try:
            res["control"] = _run(init, mesh, "none", {})
        finally:
            tp.reduce_scatter = inner
    torch.save(res, os.path.join(out, f"results{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        _rank_main(int(sys.argv[1]), *sys.argv[2:6])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
    sys.exit(0)


# ------------------------------------------------------------- the worlds

@pytest.fixture(scope="module")
def jinit():
    """{arch: the reference's ``init_lm`` parameters of the reduced config,
    cast to f32}."""
    return {arch: jax.tree.map(lambda a: a.astype(jnp.float32), jT.init_lm(
        jax.random.PRNGKey(0), jreduced(jget_config(arch)))) for arch in ARCHS}


@pytest.fixture(scope="module", autouse=True)
def _spawns(tmp_path_factory, jinit):
    """Start every spawn's ranks when the module starts; {spawn:
    (directory, processes)}."""
    init = {arch: from_reference(p, "cpu") for arch, p in jinit.items()}
    init.update({arch: _family_init(arch) for arch in FAMILY_ARCHS})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]),
               OMP_NUM_THREADS="1")
    init_path = tmp_path_factory.mktemp("init") / "init.pt"
    torch.save(init, init_path)
    procs = {}
    for spawn, shape in SPAWNS.items():
        d = tmp_path_factory.mktemp(spawn)
        procs[spawn] = (d, [subprocess.Popen(
            [sys.executable, __file__, str(r), spawn, str(d / "store"), str(d),
             str(init_path)],
            env=env, cwd=ROOT, stdout=open(d / f"rank{r}.log", "w"),
            stderr=subprocess.STDOUT) for r in range(int(np.prod(shape)))])
    yield procs
    for _, ps in procs.values():
        for p in ps:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def worlds(_spawns):
    """{spawn: [each rank's results]}."""
    res = {}
    for spawn, (d, ps) in _spawns.items():
        rcs = []
        for p in ps:
            try:
                rcs.append(p.wait(timeout=300))
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                rcs.append("timeout")
        logs = "\n".join((d / f"rank{r}.log").read_text()[-3000:] for r in range(len(ps)))
        assert rcs == [0] * len(ps), (spawn, rcs, logs)
        res[spawn] = [torch.load(d / f"results{r}.pt", weights_only=False)
                      for r in range(len(ps))]
    return res


@pytest.fixture(scope="module")
def reference(jinit):
    """{case: the reference's run of granite-8b}: [(metrics, params, opt
    state, None)] after each of STEPS jitted steps."""
    jcfg = jreduced(jget_config("granite-8b"))
    out = {}
    for name, (remat, option) in REF_CASES.items():
        jtc = jbase.TrainConfig(remat=remat, **option)
        jp = jinit["granite-8b"]
        state, want = (jp, jadam.init_adam(jp, jtc), None), []
        step = jax.jit(jts.make_train_step(jcfg, jtc))
        for i in range(STEPS):
            batch = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in _batch(jcfg, i).items()}
            *state, m = step(*state, batch)
            jn, jo, _ = state
            want.append(({k: float(v) for k, v in m.items()}, from_reference(jn, "cpu"),
                         SimpleNamespace(m=from_reference(jo.m, "cpu"),
                                         v=from_reference(jo.v, "cpu")), None))
        out[name] = want
    return out


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_slices_are_the_averaged_gradients_bits(worlds, arch):
    for rank, res in enumerate(worlds["data2"]):
        same = res["bits", arch]
        assert len(same) > 0 and all(ok for _, ok in same), (rank, [i for i, ok in same if not ok])


HIGH_WATER = ([(spawn, remat) for spawn in HW_SPAWNS for remat in REMATS]
              + [("data2", "tied"), ("data2model2", "none-bf16")])


@pytest.mark.parametrize("spawn,case", HIGH_WATER, ids=[f"{s}-{c}" for s, c in HIGH_WATER])
def test_no_rank_holds_more_than_one_period_whole(worlds, spawn, case):
    for rank, res in enumerate(worlds[spawn]):
        hw = res["high_water", case]
        layers = hw["layers"]
        assert 0 < hw["peak"] <= hw["largest"], (rank, hw)
        assert hw["largest"] < hw["whole"] / 2, (rank, hw)
        assert hw["gathers"] == 2 * layers + 3, (rank, hw)
        assert hw["scatters"] == layers + 2, (rank, hw)
        assert hw["stats"] == (hw["gathers"], hw["scatters"], hw["peak"]), (rank, hw)
        assert hw["copies"] == 0, (rank, hw)
        assert np.isfinite(hw["loss"])


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_data_two_world_matches_reference(worlds, reference, case):
    want = reference[case]
    remat, option = REF_CASES[case]
    tc = TrainConfig(remat=remat, **option)
    for res in worlds["data2"]:
        got = res["ref", case]
        assert all(_rel(g[0]["loss"], w[0]["loss"]) <= 1e-6 for g, w in zip(got, want))
        _check_run(got, want, tc)


def test_cut_without_reduce_misses_the_limits(worlds, reference):
    want = reference["plain-none"]
    got = worlds["data2"][0]["control"]
    with pytest.raises(AssertionError):
        _check_run(got, want, TrainConfig(remat="none"))
    _check_run(worlds["data2"][0]["ref", "plain-none"], want, TrainConfig(remat="none"))


@pytest.fixture(scope="module")
def family_single():
    """(arch, remat) -> the single-process port's run of a family arch."""
    cache = {}

    def get(arch, remat):
        if (arch, remat) not in cache:
            cache[arch, remat] = _run({arch: _family_init(arch)}, None, remat, {}, arch,
                                      FAMILY_STEPS)
        return cache[arch, remat]
    return get


FAMILY_CASES = [(spawn, arch, remat) for spawn in FAMILY_SPAWNS for arch in FAMILY_ARCHS
                for remat in FAMILY_REMATS]


@pytest.mark.parametrize("spawn,arch,remat", FAMILY_CASES,
                         ids=[f"{s}-{a}-{r}" for s, a, r in FAMILY_CASES])
def test_family_world_matches_single_process(worlds, family_single, spawn, arch, remat):
    """The SSM and audio families gather over ``model`` too.  At model 2
    the batch is replicated: each rank computes the whole batch on the
    gathered periods and cuts each gradient without a sum, so the run is
    the single-process run bit for bit.  At data 2 each period's
    gradient is reduce-scattered over ``data`` (f32 sums of the ranks'
    rows) and the run is held by ``_check_run``'s ``flips`` rule."""
    want = family_single(arch, remat)
    for res in worlds[spawn]:
        got = res["family", arch, remat]
        if spawn == "model2":
            for (gm, gp, go, _), (wm, wp, wo, _) in zip(got, want, strict=True):
                assert gm == wm
                for a, b in zip(tree_leaves([gp, go]), tree_leaves([wp, wo]), strict=True):
                    assert torch.equal(a, b)
            continue
        _check_run(got, want, TrainConfig(remat=remat), flips=True)
