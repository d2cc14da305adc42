"""Port parity: tensor- and expert-parallel compute on the ``model`` axis.

Spawned gloo worlds (a ``FileStore`` under ``tmp_path``; the ranks are
this file run as a script, without JAX) of 2 and 4 ranks, meshes model 2
and model 4, run each layer at f32 on their ``model`` slices of the
parameters (``sharding.param_specs``, cut over ``model`` alone) under an
axis env with ``tp_compute``, and give back the output and every
gradient, gathered whole; the test process runs the same layer as one
process (no tensor parallelism) and holds the ranks to it:

* a column-parallel linear (``tp.copy``, ``tp.gather``) and a
  row-parallel one (``tp.row_parallel``: f32 partial sums, ``tp.reduce``);
* the MLP (``layers.apply_mlp``);
* attention where the KV heads divide the axis (``reduced(granite-8b,
  num_kv_heads=2)`` at model 2: each rank's heads local) and where they do
  not (reduced granite-8b, Hkv 1, and Hkv 2 at model 4: ``wk`` / ``wv``'s
  slices hold parts of heads, k and v are gathered whole);
* the vocab-parallel embedding, head and loss (``train_step.
  cross_entropy``);
* the MoE layer under "ep" (the local experts, the Q8_0 combine's
  all-gather): without shared experts its forward is the single-process
  forward bit for bit, since only the expert split and an exact
  all-gather stand between them; with them (their down projection is
  reduced over ranks) within the limits.

Outputs are held within ``FWD_F32_REL`` of their largest magnitude,
every gradient (each parameter leaf and the input) within
``GRAD_F32_REL`` of its largest: only the order of f32 sums differs
(measured: outputs <= 5.9e-7, gradients <= 6.0e-7 of their largest).
The single-process layers are held to the reference's (the JAX package,
``jax.value_and_grad``) within the same limits.

A period under remat "block" whose backward (and so its recomputation)
runs on another thread, which does not see the caller's axis env (on
the card autograd runs the backward on a device thread), gives the same
gradient bits as a backward on the caller's thread.

In the model-2 and model-4 ranks a sharded train step of reduced
granite-8b with Hkv 2 records the weights its forward sees (each rank's
``model`` slice, never a whole tensor-parallel weight) and counts the
collectives it issues (a monkeypatch of ``torch.distributed``): no
all-gather of a weight, only of the k / v activations where Hkv does
not divide the axis (the data axis has one rank: the per-layer gathers
of ``distributed.fsdp`` issue nothing).  The control: with ``tp.row_parallel`` stripped of
its reduction, the MLP and attention miss ``FWD_F32_REL`` by far.
"""
import dataclasses
import datetime
import os
import subprocess
import sys
import threading
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

if __name__ != "__main__":          # the gloo ranks this file spawns run without JAX
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp  # noqa: E402

    from repro.configs import get_config as jget_config  # noqa: E402
    from repro.configs import reduced as jreduced  # noqa: E402
    from repro.core import qlinear as jql  # noqa: E402
    from repro.models import attention as jattn  # noqa: E402
    from repro.models import layers as jL  # noqa: E402
    from repro.models import moe as jmoe  # noqa: E402
    from repro.train import train_step as jts  # noqa: E402
    from repro_torch.weights import from_reference  # noqa: E402
    from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import TrainConfig, get_config, reduced  # noqa: E402
from repro_torch.core.qlinear import Linear, apply_linear  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.distributed import ctx as tctx  # noqa: E402
from repro_torch.distributed import sharding, tp  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_smoke_mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import init_lm, lm_forward  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLDS = {"model2": 2, "model4": 4}
AXES = ("pod", "data", "model")
B, S = 2, 16
N_COL, K_ROW = 256, 256       # the linear cases' sliced dims
FWD_F32_REL = 1e-5            # measured <= 5.9e-7
GRAD_F32_REL = 2e-5           # test_torch_train's limit; measured <= 6.0e-7
CASES = ("col_linear", "row_linear", "mlp", "attn_kv2", "attn_kv1", "embed_loss",
         "moe", "moe_routed")
CONTROLS = ("mlp", "attn_kv2")


# ------------------------------------------------ shared with the ranks

def _mesh(n: int) -> Mesh:
    return Mesh(np.arange(n).reshape(1, 1, n), AXES)


def _fn(name: str, p, c: dict, x):
    """Case ``name`` on parameters ``p`` -> (the output to compare, whole;
    the scalar whose gradient is taken)."""
    cfg = c.get("cfg")
    if name == "col_linear":
        split = tctx.is_part(tctx.cols(N_COL), N_COL)
        y = apply_linear(p["w"], tp.copy(x) if split else x)
        y = tp.gather(y, -1) if split else y
    elif name == "row_linear":
        sl = tctx.cols(K_ROW)
        y = (tp.row_parallel(p["w"], tp.copy(x)[..., sl]) if tctx.is_part(sl, K_ROW)
             else apply_linear(p["w"], x))
    elif name == "mlp":
        y = tL.apply_mlp(p, x, "silu", cfg.d_ff)
    elif name.startswith("attn"):
        y = tattn.attention_fwd(p, cfg, x, c["pos"], causal=True, rope=True)
    elif name == "embed_loss":
        v = cfg.vocab_size
        logits = tL.apply_unembed(p["head"], tL.apply_embedding(p["embed"], x, v) * c["r"], v)
        ce = tts.cross_entropy(logits, c["labels"], v)
        split = tctx.is_part(tctx.vocab((B, S, v)), v)
        return (tp.gather(logits, -1) if split else logits), ce
    else:
        y, aux = tmoe.apply_moe(p, cfg, x)
        return y, (y * c["r"]).sum() + aux
    return y, (y * c["r"]).sum()


def _run_case(name: str, c: dict, mesh: Mesh) -> tuple:
    """(output, [every parameter leaf's gradient, whole], the input's
    gradient or None) of case ``name`` on this rank's ``model`` slices
    (one process: a one-rank mesh, the whole parameters)."""
    with tctx.axis_env(mesh, moe_mode="ep", tp_compute=True):
        specs = sharding.over(sharding.param_specs(c["params"], mesh), ("model",))
        local = sharding.shard_tree(c["params"], specs, mesh, mesh.own_coords())
        leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(local)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), local)
        x = c["x"].clone()
        wrt = leaves + ([x.requires_grad_(True)] if x.is_floating_point() else [])
        out, loss = _fn(name, live, c, x)
        grads = torch.autograd.grad(loss, wrt)
        it = iter(grads)
        whole = sharding.gather_tree(tree_map(lambda _: next(it), local), specs, mesh)
    gx = grads[len(leaves)] if len(grads) > len(leaves) else None
    return out.detach(), tree_leaves(whole), gx


def _no_reduce(lin, x):
    """``tp.row_parallel`` without its reduction: this rank's partial
    product alone (the control)."""
    return torch.matmul(x.float(), lin.w.float().t()).to(x.dtype)


def _step_collectives(mesh: Mesh) -> dict:
    """One sharded train step of reduced granite-8b with Hkv 2 at f32:
    the shapes of the weights its forward saw, and the tensors it
    all-gathered and the all-reduces it issued."""
    cfg = reduced(get_config("granite-8b"), num_kv_heads=2)
    params = tree_map(lambda t: t.float(), init_lm(torch.Generator().manual_seed(0), cfg))
    tc = TrainConfig(remat="none")
    gathered, reduced_n, seen = [], [0], []
    inner_g, inner_r, inner_f = dist.all_gather, dist.all_reduce, tts.lm_forward

    def all_gather(parts, x, *a, **k):
        gathered.append(tuple(x.shape))
        return inner_g(parts, x, *a, **k)

    def all_reduce(x, *a, **k):
        reduced_n[0] += 1
        return inner_r(x, *a, **k)

    def forward(p, *a, **k):
        lay = p["layers"][0]
        seen.append({"embed": tuple(p["embed"].w.shape), "lm_head": tuple(p["lm_head"].w.shape),
                     **{n: tuple(lay["attn"][n].w.shape) for n in ("wq", "wk", "wv", "wo")},
                     **{n: tuple(lay["mlp"][n].w.shape) for n in ("up", "gate", "down")}})
        return inner_f(p, *a, **k)
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, S)))
             for k in ("tokens", "labels")}
    with tctx.axis_env(mesh):
        step = tts.make_train_step(cfg, tc, device="cpu", mesh=mesh)
        p, o = step.shard(params, adamw.init_adam(params, tc))
        dist.all_gather, dist.all_reduce, tts.lm_forward = all_gather, all_reduce, forward
        try:
            _, _, _, m = step(p, o, None, batch)
        finally:
            dist.all_gather, dist.all_reduce, tts.lm_forward = inner_g, inner_r, inner_f
    return {"gathered": gathered, "all_reduce": reduced_n[0], "seen": seen,
            "loss": float(m["loss"])}


def _remat_threads(mesh: Mesh) -> tuple:
    """The gradient of reduced granite-8b's loss (Hkv 2) on this rank's
    slices under remat "block", its backward run by this thread and by
    another one, which does not see this thread's axis env (on the card,
    autograd runs the backward and its recomputation on a device thread)."""
    cfg = reduced(get_config("granite-8b"), num_kv_heads=2)
    params = tree_map(lambda t: t.float(), init_lm(torch.Generator().manual_seed(1), cfg))
    rng = np.random.default_rng(9)
    tokens, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))) for _ in "tl")
    out = []
    for threaded in (False, True):
        with tctx.axis_env(mesh, tp_compute=True):
            local = sharding.shard_tree(
                params, sharding.over(sharding.param_specs(params, mesh), ("model",)), mesh,
                mesh.own_coords())
            leaves = [t.requires_grad_(True) for t in tree_leaves(local)]
            it = iter(leaves)
            logits, _ = lm_forward(tree_map(lambda _: next(it), local), cfg, tokens,
                                   remat="block")
            loss = tts.cross_entropy(logits, labels, cfg.vocab_size)
        if threaded:
            got = []
            t = threading.Thread(target=lambda: got.append(torch.autograd.grad(loss, leaves)))
            t.start()
            t.join(timeout=120)
            out.append(got[0])
        else:
            out.append(torch.autograd.grad(loss, leaves))
    return tuple(out)


def _rank_main(rank: int, world: str, store: str, out: str, cases_path: str) -> None:
    n = WORLDS[world]
    torch.set_num_threads(1)
    cases = torch.load(cases_path, weights_only=False)
    dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=120))
    mesh = _mesh(n)
    res = {name: _run_case(name, cases[name], mesh) for name in CASES}
    inner = tp.row_parallel
    tp.row_parallel = _no_reduce
    try:
        for name in CONTROLS:
            res["control", name] = _run_case(name, cases[name], mesh)
    finally:
        tp.row_parallel = inner
    res["step"] = _step_collectives(mesh)
    res["remat_threads"] = _remat_threads(mesh)
    if rank == 0:
        torch.save(res, os.path.join(out, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        _rank_main(int(sys.argv[1]), *sys.argv[2:6])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
    sys.exit(0)


# ------------------------------------------------------- the cases

def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def _cases() -> tuple[dict, dict]:
    """({case: the port's inputs and f32 parameters}, {case: the
    reference's parameters}), drawn from seeds."""
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    gran = jreduced(jget_config("granite-8b"))
    ds = jreduced(jget_config("deepseek-moe-16b"))
    jp = {
        "mlp": _f32(jL.init_mlp(key, gran.d_model, gran.d_ff, "silu")),
        "attn_kv2": _f32(jattn.init_attention(key, jreduced(jget_config("granite-8b"),
                                                            num_kv_heads=2))),
        "attn_kv1": _f32(jattn.init_attention(key, gran)),
        "embed_loss": _f32({"embed": jL.init_embedding(key, gran.vocab_size, gran.d_model),
                            "head": jql.init_linear(jax.random.PRNGKey(1), gran.d_model,
                                                    gran.vocab_size, role="lm_head")}),
        "moe": _f32(jmoe.init_moe(key, ds)),
    }
    jp["moe_routed"] = {k: v for k, v in jp["moe"].items() if k != "shared"}
    tcfg = {"mlp": reduced(get_config("granite-8b")),
            "attn_kv2": reduced(get_config("granite-8b"), num_kv_heads=2),
            "attn_kv1": reduced(get_config("granite-8b")),
            "embed_loss": reduced(get_config("granite-8b")),
            "moe": reduced(get_config("deepseek-moe-16b"))}
    tcfg["moe_routed"] = dataclasses.replace(tcfg["moe"], moe=dataclasses.replace(
        tcfg["moe"].moe, num_shared=0))
    cases = {}
    for name, cfg in tcfg.items():
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        c = {"cfg": cfg, "params": from_reference(jp[name], "cpu"), "x": torch.from_numpy(x),
             "r": torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))}
        if name.startswith("attn"):
            c["pos"] = torch.arange(S)[None].expand(B, S)
        if name == "embed_loss":
            c["x"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
            c["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
        cases[name] = c
    for name, (n, k, role) in {"col_linear": (N_COL, 128, "mlp_up"),
                               "row_linear": (128, K_ROW, "mlp_down")}.items():
        w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
        cases[name] = {"params": {"w": Linear(torch.from_numpy(w), role=role)},
                       "x": torch.from_numpy(rng.standard_normal((B, S, k)).astype(np.float32)),
                       "r": torch.from_numpy(rng.standard_normal((B, S, n)).astype(np.float32))}
    return cases, jp


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module", autouse=True)
def _spawns(tmp_path_factory, cases):
    """Start every world's ranks when the module starts; {world: (directory,
    processes)}."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]),
               OMP_NUM_THREADS="1")
    path = tmp_path_factory.mktemp("cases") / "cases.pt"
    torch.save(cases[0], path)
    procs = {}
    for world, n in WORLDS.items():
        d = tmp_path_factory.mktemp(world)
        procs[world] = (d, [subprocess.Popen(
            [sys.executable, __file__, str(r), world, str(d / "store"), str(d), str(path)],
            env=env, cwd=ROOT, stdout=open(d / f"rank{r}.log", "w"),
            stderr=subprocess.STDOUT) for r in range(n)])
    yield procs
    for _, ps in procs.values():
        for p in ps:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def worlds(_spawns):
    """{world: rank 0's results}."""
    res = {}
    for world, (d, ps) in _spawns.items():
        rcs = []
        for p in ps:
            try:
                rcs.append(p.wait(timeout=300))
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                rcs.append("timeout")
        logs = "\n".join((d / f"rank{r}.log").read_text()[-3000:] for r in range(len(ps)))
        assert rcs == [0] * len(ps), (world, rcs, logs)
        res[world] = torch.load(d / "results.pt", weights_only=False)
    return res


@pytest.fixture(scope="module")
def single(cases):
    """{case: the one-process run}."""
    return {name: _run_case(name, cases[0][name], make_smoke_mesh()) for name in CASES}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _check(got: tuple, want: tuple) -> None:
    (go, gg, gx), (wo, wg, wx) = got, want
    assert go.shape == wo.shape
    assert _rel(go, wo) <= FWD_F32_REL, _rel(go, wo)
    assert len(gg) == len(wg)
    for i, (a, b) in enumerate(zip(gg, wg)):
        assert a.shape == b.shape and _rel(a, b) <= GRAD_F32_REL, (i, _rel(a, b))
    if wx is not None:
        assert _rel(gx, wx) <= GRAD_F32_REL


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("name", CASES)
def test_layer_on_model_slices_matches_one_process(worlds, single, world, name):
    _check(worlds[world][name], single[name])


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_moe_ep_forward_is_bit_for_bit(worlds, single, world):
    """Routed experts only: the expert split and an exact all-gather of
    the Q8_0 bytes are all that differ."""
    assert torch.equal(worlds[world]["moe_routed"][0], single["moe_routed"][0])


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("name", CONTROLS)
def test_reduce_off_misses_the_limit(worlds, single, world, name):
    got, want = worlds[world]["control", name][0], single[name][0]
    assert _rel(got, want) > 100 * FWD_F32_REL, _rel(got, want)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_step_keeps_local_weights_and_gathers_no_weight(worlds, world):
    n = WORLDS[world]
    got = worlds[world]["step"]
    cfg = reduced(get_config("granite-8b"), num_kv_heads=2)
    d, hd, ff, v = cfg.d_model, cfg.hd, cfg.d_ff, cfg.vocab_size
    local = {"embed": (v // n, d), "lm_head": (v // n, d), "wq": (4 * hd // n, d),
             "wk": (2 * hd // n, d), "wv": (2 * hd // n, d), "wo": (d, 4 * hd // n),
             "up": (ff // n, d), "gate": (ff // n, d), "down": (d, ff // n)}
    assert got["seen"] == [local]
    # Hkv 2 divides model 2: no all-gather at all; at model 4 only k and v
    # (B, S, 2 * hd / 4) per layer, never a weight.
    want = [] if n == 2 else [(4, S, 2 * hd // n)] * (2 * cfg.num_layers)
    assert got["gathered"] == want
    # Forward: the embedding, wo and down per layer, the loss's max, sum of
    # exp and target logit; backward: the attention and MLP inputs' copies
    # (and, at model 4, k's and v's) per layer and the head's; the norm.
    layers = cfg.num_layers
    assert got["all_reduce"] == (1 + 2 * layers + 3) + (2 * layers + 1
                                                         + (2 * layers if n == 4 else 0)) + 1


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_recomputation_on_another_thread_keeps_the_env(worlds, world):
    """A checkpointed period recomputed where the axis env is not seen
    (another thread) re-enters the env it first ran under: the same
    gradient bits as a backward on the caller's thread."""
    same, other = worlds[world]["remat_threads"]
    assert len(same) == len(other) and all(torch.equal(a, b) for a, b in zip(same, other))


def test_single_process_layers_match_reference(cases):
    """The one-process layers that the ranks are held to, against the
    reference's (``jax.value_and_grad`` at f32)."""
    tcases, jp = cases
    gran = jreduced(jget_config("granite-8b"))
    for name in ("mlp", "attn_kv2", "attn_kv1", "embed_loss"):
        c = tcases[name]
        r = jnp.asarray(c["r"].numpy())
        x = jnp.asarray(c["x"].numpy())
        if name == "mlp":
            f = lambda p, x_: jL.apply_mlp(p, x_, "silu")   # noqa: E731
        elif name.startswith("attn"):
            jcfg = gran if name == "attn_kv1" else jreduced(jget_config("granite-8b"),
                                                            num_kv_heads=2)
            pos = jnp.asarray(c["pos"].numpy())
            f = lambda p, x_, jcfg=jcfg, pos=pos: jattn.attention_fwd(   # noqa: E731
                p, jcfg, x_, pos, causal=True, rope=True)

        if name == "embed_loss":
            labels = jnp.asarray(c["labels"].numpy())

            def loss(p, x_):
                logits = jL.apply_unembed(p["head"], jL.apply_embedding(p["embed"], x_) * r)
                ce = jts.cross_entropy(logits, labels)
                return ce, logits
            (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp[name], x)
            gx = None
        else:
            def loss(p, x_, f=f):
                y = f(p, x_)
                return jnp.sum(y * r), y
            (_, out), (g, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                           has_aux=True))(jp[name], x)
            gx = torch.from_numpy(np.asarray(gx))
        want = (torch.from_numpy(np.asarray(out)), tree_leaves(from_reference(g, "cpu")), gx)
        _check(_run_case(name, c, make_smoke_mesh()), want)
