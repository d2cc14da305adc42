"""Port parity: the data pipeline, checkpoints and the training launcher.

* ``TokenPipeline.make_batch``, the prefetched stream (with a restart at
  a cursor) and ``latent_batch`` give the reference's bits for several
  seeds and steps.
* ``checkpoint.ckpt``: a round trip of bf16, f32, int32, Q8_0, Q4_0 and
  Q3_K leaves and an ``AdamState`` (Q8_0 and f32 moments) is bit for bit;
  ``latest_step``, ``gc_old`` and ignored ``.tmp`` directories behave as
  the reference's; the npz keys are the reference's.
* ``launch.train.main()`` on the CPU: a run stopped after step 2 and
  resumed reaches the parameters and optimizer state of an uninterrupted
  4-step run, bit for bit.
"""
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import TrainConfig, get_config, reduced  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.core.qlinear import quantize_params  # noqa: E402
from repro_torch.core.quant import QTYPES  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.transformer import init_lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


# ------------------------------------------------------------- pipeline

@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_token_batches_are_the_references(seed):
    kw = dict(vocab_size=512, seq_len=16, batch=3, seed=seed)
    a, b = jpipe.TokenPipeline(**kw), tpipe.TokenPipeline(**kw)
    try:
        for step in (0, 1, 5, 1000):
            want, got = a.make_batch(step), b.make_batch(step)
            assert sorted(got) == ["labels", "tokens"]
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
        for _ in range(3):
            want, got = next(a), next(b)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
        assert b.state() == a.state() == {"seed": seed, "step": 3}
    finally:
        a.close()
        b.close()
    for step in (0, 3):
        np.testing.assert_array_equal(
            tpipe.latent_batch(step, batch=2, h=4, w=4, seed=seed),
            jpipe.latent_batch(step, batch=2, h=4, w=4, seed=seed))


def test_pipeline_restart_replays_the_stream():
    kw = dict(vocab_size=100, seq_len=8, batch=2, seed=3)
    first = tpipe.TokenPipeline(**kw)
    stream = [next(first) for _ in range(5)]
    first.close()
    resumed = tpipe.TokenPipeline(start_step=2, **kw)
    try:
        for want in stream[2:]:
            got = next(resumed)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        resumed.close()
    assert not resumed._thread.is_alive()


# ----------------------------------------------------------- checkpoint

def _trees():
    cfg = reduced(get_config("granite-8b"), num_layers=1)
    gen = torch.Generator().manual_seed(0)
    dense = init_lm(gen, cfg)
    trees = {"dense": dense,
             "q3k": quantize_params(init_lm(gen, cfg), get_policy("q3_k")),
             "q4": quantize_params(init_lm(gen, cfg), get_policy("q4_0")),
             "misc": {"i": torch.arange(5, dtype=torch.int32), "f16": torch.ones(3).half()}}
    for qz in (False, True):
        st = adamw.init_adam(dense, TrainConfig(quantized_moments=qz))
        trees[f"opt{int(qz)}"] = adamw.AdamState(
            st.step + 3, st.m, st.v)
    return trees


def _is_q(x):
    return isinstance(x, QTYPES)


def _assert_same(a, b):
    la, lb = tree_leaves(a, is_leaf=_is_q), tree_leaves(b, is_leaf=_is_q)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if _is_q(x):
            assert x.shape == y.shape
            for f in ("qs", "d", "ql", "qh", "scales"):
                if hasattr(x, f):
                    assert torch.equal(getattr(x, f), getattr(y, f))
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip_every_leaf_kind(tmp_path):
    trees = _trees()
    kinds = {type(x).__name__ for t in trees.values() for x in tree_leaves(t, is_leaf=_is_q)}
    assert {"Tensor", "Q8_0Tensor", "Q4_0Tensor", "Q3KTensor"} <= kinds
    final = ckpt.save(str(tmp_path), 3, trees, meta={"seed": 1, "step": 9})
    assert os.path.basename(final) == "step_00000003"
    with open(os.path.join(final, "manifest.json")) as f:
        assert json.load(f) == {"step": 9, "seed": 1}
    keys = np.load(os.path.join(final, "dense.npz")).files
    assert "0.a~bf16" in keys and all("." in k for k in keys)
    assert any(k.endswith(".q3k.ql") for k in np.load(os.path.join(final, "q3k.npz")).files)
    templates = _trees()
    for t in tree_leaves(templates, is_leaf=_is_q):        # nothing leaks
        for x in (tree_leaves(t) if _is_q(t) else [t]):
            if x.is_floating_point():
                x.fill_(7)
    out, man = ckpt.restore(str(tmp_path), 3, templates)
    assert man["seed"] == 1
    for name in trees:
        _assert_same(out[name], trees[name])
    assert isinstance(out["opt1"], adamw.AdamState) and int(out["opt1"].step) == 3


def test_latest_gc_and_tmp(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    ckpt.gc_old(d)
    p = {"w": torch.ones(4)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, {"p": p})
    assert ckpt.latest_step(d) == 5
    ckpt.gc_old(d, keep=2)
    assert sorted(x for x in os.listdir(d)) == ["step_00000004", "step_00000005"]
    os.makedirs(os.path.join(d, "step_00000009.tmp"))     # a crashed write
    assert ckpt.latest_step(d) == 5
    ckpt.save(d, 6, {"p": p})
    assert not any(x.endswith(".tmp") and "00000006" in x for x in os.listdir(d))


# ------------------------------------------------------------ launcher

def _run(argv, capsys):
    tlaunch.main(argv)
    return capsys.readouterr().out


def test_launch_train_resume_equals_uninterrupted(tmp_path, capsys):
    common = ["--arch", "granite-8b", "--device", "cpu", "--batch", "2",
              "--seq", "8", "--ckpt-every", "2"]
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    out = _run(common + ["--steps", "4", "--ckpt-dir", whole], capsys)
    assert "step 0 loss" in out and "resumed" not in out
    _run(common + ["--steps", "2", "--ckpt-dir", cut], capsys)      # "killed" after 2
    assert ckpt.latest_step(cut) == 2
    out = _run(common + ["--steps", "4", "--ckpt-dir", cut], capsys)
    assert "resumed at step 2" in out
    assert ckpt.latest_step(whole) == ckpt.latest_step(cut) == 4
    for name in ("params", "opt"):
        a = np.load(os.path.join(whole, "step_00000004", f"{name}.npz"))
        b = np.load(os.path.join(cut, "step_00000004", f"{name}.npz"))
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    with open(os.path.join(cut, "step_00000004", "manifest.json")) as f:
        assert json.load(f) == {"step": 4, "seed": 0}     # the pipeline's cursor
    out = _run(common + ["--steps", "4", "--ckpt-dir", cut], capsys)
    assert "resumed at step 4" in out and "step" not in out.split("resumed at step 4")[1]
