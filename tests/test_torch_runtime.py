"""The port's training runtime against the JAX package's, on the CPU:
``runtime/fault_tolerance.py`` (checkpoint and restart under a simulated
preemption, straggler re-issue) and ``optim/grad_compression.py`` (int8
compression with error feedback), mirroring ``tests/test_runtime.py`` on
the port and holding each function to its JAX counterpart.

Tolerances, stated before measuring: compression bit for bit against the
reference's (the same f32 operations, rounding half to even); a resumed
run equal to an uninterrupted one bit for bit (the same arithmetic on the
same restored state); ``decompress + feedback`` within 1e-6 of the
corrected gradient, the quantization error within half a scale.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import grad_compression as jgc
from repro.runtime import fault_tolerance as jft

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import registry
from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
from repro_torch.launch.steps import lm_train_step
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim import adamw
from repro_torch.optim import grad_compression as gc
from repro_torch.runtime.fault_tolerance import (RunnerConfig,
                                                 StragglerDispatcher,
                                                 TrainRunner)


def _toy_state():
    return {"w": torch.zeros((4, 4)), "step_sum": torch.zeros(())}


def _toy_step(state, step):
    return {"w": state["w"] + 1.0, "step_sum": state["step_sum"] + step}


def _jax_toy_state():
    return {"w": jnp.zeros((4, 4)), "step_sum": jnp.zeros(())}


def _jax_toy_step(state, step):
    return {"w": state["w"] + 1.0, "step_sum": state["step_sum"] + step}


# ------------------------------------------------------ checkpoint, restart
def test_checkpoint_roundtrip_and_keep_n(tmp_path):
    state = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    ckpt.save(str(tmp_path / "r"), 7, state)
    got, step = ckpt.restore(str(tmp_path / "r"), state)
    assert step == 7
    assert torch.equal(got["a"], state["a"])
    assert torch.equal(got["b"]["c"], torch.ones(4))
    for s in range(6):
        ckpt.save(str(tmp_path / "k"), s, _toy_state(), keep=2)
    steps = sorted(d for d in os.listdir(tmp_path / "k")
                   if d.startswith("step_"))
    assert len(steps) == 2 and steps[-1] == "step_00000005"


def test_preemption_restart_equivalence(tmp_path):
    """Killed at step 7 and restarted: the final state equals an
    uninterrupted run's, and the reference runner's on the same steps."""
    cfg = RunnerConfig(str(tmp_path / "a"), ckpt_every=3, max_steps=12)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        TrainRunner(cfg, _toy_state, _toy_step).run(crash_at_step=7)
    assert ckpt.latest_step(cfg.ckpt_dir) == 5
    resumed = TrainRunner(cfg, _toy_state, _toy_step).run()
    clean = TrainRunner(RunnerConfig(str(tmp_path / "b"), ckpt_every=3,
                                     max_steps=12),
                        _toy_state, _toy_step).run()
    want = jft.TrainRunner(jft.RunnerConfig(str(tmp_path / "c"),
                                            ckpt_every=3, max_steps=12),
                           _jax_toy_state, _jax_toy_step).run()
    for key in ("w", "step_sum"):
        assert torch.equal(resumed[key], clean[key])
        np.testing.assert_array_equal(resumed[key].numpy(),
                                      np.asarray(want[key]))
    assert ckpt.latest_step(cfg.ckpt_dir) == 11


def _lm_runner(arch, ckpt_dir, max_steps, device="cpu"):
    """A ``TrainRunner`` over ``lm_train_step`` on ``arch``'s smoke config:
    the state is the parameters and the AdamW state, a step's batch a
    function of the step alone."""
    cfg = registry.get(arch).smoke_config
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=max_steps)
    stream = TokenStreamConfig(cfg.vocab, 16, 2, seed=0)
    model = TransformerLM(cfg, device=device, seed=0)
    named = dict(model.named_parameters())
    fresh = {n: p.detach().clone() for n, p in named.items()}

    def init_state():
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(fresh[n])
        return {"params": named, "opt": adamw.init_state(named, opt)}

    def step_fn(state, step):
        with torch.no_grad():
            for n, p in named.items():
                if state["params"][n] is not p:
                    p.copy_(state["params"][n])
        lm_train_step(model, opt, state["opt"], *batch_at_step(stream, step))
        return {"params": named, "opt": state["opt"]}

    return TrainRunner(RunnerConfig(ckpt_dir, ckpt_every=3,
                                    max_steps=max_steps),
                       init_state, step_fn)


def test_lm_preemption_restart_is_bit_equal(tmp_path):
    """llama4's smoke config (MoE) crashed at step 4 of 8 and resumed from
    its step-2 checkpoint: every parameter and moment equal, bit for bit,
    to an uninterrupted run's."""
    arch = "llama4-scout-17b-a16e"
    with pytest.raises(RuntimeError, match="step 4"):
        _lm_runner(arch, str(tmp_path / "a"), 8).run(crash_at_step=4)
    resumed = _lm_runner(arch, str(tmp_path / "a"), 8).run()
    clean = _lm_runner(arch, str(tmp_path / "b"), 8).run()
    for n, p in clean["params"].items():
        assert torch.equal(resumed["params"][n], p), n
        assert torch.equal(resumed["opt"]["m"][n], clean["opt"]["m"][n]), n
    assert int(resumed["opt"]["step"]) == int(clean["opt"]["step"]) == 8


def test_runner_refuses_shardings(tmp_path):
    """Shardings are ported (``tests/test_torch_sharding.py`` resumes on a
    mesh); a tree whose leaves are not ``Sharding`` or None, or whose
    paths are not the state's, is refused before a step runs."""
    for bad in ({"w": "data", "step_sum": None}, {"other": None}):
        runner = TrainRunner(RunnerConfig(str(tmp_path / "c")), _toy_state,
                             _toy_step, shardings=bad)
        with pytest.raises(TypeError):
            runner.run()
    assert not (tmp_path / "c").exists()


# ------------------------------------------------------------- stragglers
def _drive(disp):
    """The reference test's schedule: 4 workers take a chunk at t 0,
    worker 3 straggles, then idle worker 0 drains the rest at t 2.
    Returns every call's answer."""
    log = []
    taken = {w: disp.assign(w, now=0.0) for w in range(4)}
    log.append(taken)
    for w in range(3):
        log.append(disp.complete(taken[w]))
    while True:
        c = disp.assign(0, now=2.0)
        log.append(c)
        if c is None:
            break
        log.append(disp.complete(c))
    log.append(disp.complete(taken[0]))          # a duplicate
    log.append((disp.reissues, sorted(disp.completed), disp.all_done))
    return log


def test_straggler_dispatch_reissues_and_dedups():
    disp = StragglerDispatcher(n_chunks=8, n_workers=4, deadline_s=1.0)
    log = _drive(disp)
    assert disp.reissues >= 1                  # the straggler's chunk
    assert len(disp.completed) == 8 and disp.all_done
    assert log[-2] is False                    # the duplicate is deduped
    assert log == _drive(jft.StragglerDispatcher(8, 4, 1.0))


# ------------------------------------------------------------ compression
def _grads(seed):
    """Seeded gradients: normal, with exact ties at half a step of the
    scale (rounded to even), zeros, and a tensor of all zeros."""
    rng = np.random.default_rng(seed)
    g = {"a": rng.standard_normal((33, 17)).astype(np.float32),
         "b": (rng.standard_normal(1000) * 1e-3).astype(np.float32),
         "zero": np.zeros(5, np.float32),
         "ties": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 0.0],
                          np.float32)}
    fb = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
          for k, v in g.items()}
    fb["ties"] = np.zeros(8, np.float32)
    return g, fb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_is_bit_equal_to_jax(seed):
    g, fb = _grads(seed)
    for k in g:
        q, s, nfb = gc.compress(torch.from_numpy(g[k]),
                                torch.from_numpy(fb[k]))
        jq, js, jfb = jgc.compress(jnp.asarray(g[k]), jnp.asarray(fb[k]))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq), err_msg=k)
        assert s.numpy().tobytes() == np.asarray(js).tobytes(), k
        assert nfb.numpy().tobytes() == np.asarray(jfb).tobytes(), k
        np.testing.assert_array_equal(gc.decompress(q, s).numpy(),
                                      np.asarray(jgc.decompress(jq, js)))
    # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0, -2.5 -> -2
    q, _, _ = gc.compress(torch.from_numpy(g["ties"]), torch.zeros(8))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 4, 0]


def test_compress_tree_matches_jax_on_named_dicts():
    g, fb = _grads(3)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    tfb = {k: torch.from_numpy(v) for k, v in fb.items()}
    q, s, nfb = gc.compress_tree(tg, tfb)
    jq, js, jfb = jgc.compress_tree(jax.tree.map(jnp.asarray, g),
                                    jax.tree.map(jnp.asarray, fb))
    assert set(q) == set(s) == set(nfb) == set(g)
    for k in g:
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
        np.testing.assert_array_equal(nfb[k].numpy(), np.asarray(jfb[k]))
        np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]))
    back = gc.decompress_tree(q, s)
    want = jgc.decompress_tree(jq, js)
    for k in g:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(want[k]))
    zeros = gc.init_feedback({"x": torch.ones(2, 3, dtype=torch.bfloat16),
                              "l": [torch.ones(4)]})
    assert zeros["x"].dtype == torch.float32 and zeros["x"].shape == (2, 3)
    assert torch.equal(zeros["l"][0], torch.zeros(4))


def test_grad_compression_error_feedback_converges():
    """EF keeps the quantized optimizer convergent on a quadratic (the
    reference test's), and the port's iterates equal the reference's."""
    w_true = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    w, fb = torch.zeros(64), torch.zeros(64)
    jw, jfb = jnp.zeros(64), jnp.zeros(64)
    for _ in range(300):
        q, s, fb = gc.compress(w - torch.from_numpy(w_true), fb)
        w = w - 0.1 * gc.decompress(q, s)
        jq, js, jfb = jgc.compress(jw - jnp.asarray(w_true), jfb)
        jw = jw - 0.1 * jgc.decompress(jq, js)
    assert float((w - torch.from_numpy(w_true)).abs().max()) < 1e-2
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_grad_compression_bias_bounded():
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    q, s, fb = gc.compress(g, torch.zeros(1000))
    rec = gc.decompress(q, s)
    assert float((rec + fb - g).abs().max()) < 1e-6   # exact with feedback
    assert float((rec - g).abs().max()) <= float(s) * 0.5 + 1e-6
