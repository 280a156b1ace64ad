"""The port's MoE layer (``models/moe.py``) against the JAX package's
``models/moe.py``, on the CPU.

Inputs are drawn with numpy from a seed; weights are the JAX package's
``init_moe``, carried over as numpy.  The reference's routes and keep
mask are recomputed here with JAX's own ops in the reference's order
(``lax.top_k``, ``jnp.argsort``, ``searchsorted``), since ``moe_apply``
returns only its output and aux loss.

The reference is compiled with ``xla_allow_excess_precision`` off
(``jit`` below): with it on, as by default, XLA fuses the bf16 router
product's cast to f32 into the product and skips its rounding to bf16,
so the jitted reference routes on other logits than its code writes (and
than it routes op by op).  The port rounds as the code writes.

Tolerances, stated before measuring:
- f32: outputs, aux and every gradient within 1e-5 of the largest
  |element| of the reference's tensor (at least 1e-5 absolute): the same
  products summed in other orders;
- bf16: within 2e-2 of the same scale (``tests/test_torch_lm.py``'s
  ``BF16_TOL``);
- routes (``gate_idx``) and the keep mask exactly, in both dtypes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe

from repro_torch.models import moe

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
D_MODEL, D_FF = 32, 48
# the reference's jit with every intermediate rounded to its own type
jit = functools.partial(jax.jit,
                        compiler_options={"xla_allow_excess_precision":
                                          False})
# (tokens T, experts E, top k)
SHAPES = [(64, 4, 1), (64, 4, 2), (96, 8, 2)]


def _close(got, want, dtype, what=""):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    limit = TOL[dtype] * max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= limit, (what, err, limit)


def _specs(E, K, shared, capacity_factor=1.25):
    kw = dict(d_model=D_MODEL, d_ff=D_FF, n_experts=E, top_k=K,
              capacity_factor=capacity_factor, shared_expert=shared)
    return jmoe.MoeSpec(**kw), moe.MoeSpec(**kw)


def _params(jspec, seed, zero_router=False):
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed),
                                               jspec))
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    return p


def _torch_tree(tree, requires_grad=False):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, requires_grad) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_(requires_grad)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _ref_routing(params, x, spec):
    """The reference's routes and keep mask (token order), its lines in
    its order."""
    T = x.shape[0] * x.shape[1]
    E, K = spec.n_experts, spec.top_k
    xt = x.reshape(T, -1)
    logits = (xt @ params["router"].astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, K)
    A = T * K
    C = int(np.ceil(A / E * spec.capacity_factor))
    se_all = gate_idx.reshape(-1)
    order = jnp.argsort(se_all)
    se = se_all[order]
    start = jnp.searchsorted(se, jnp.arange(E, dtype=jnp.int32))
    rank = jnp.arange(A, dtype=jnp.int32) - start[jnp.clip(se, 0, E - 1)]
    keep = jnp.zeros((A,), bool).at[order].set(rank < C)
    return np.asarray(gate_idx), np.asarray(keep).reshape(T, K), C


def _inputs(T, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T // 2, D_MODEL)).astype(np.float32)
    ct = rng.standard_normal((2, T // 2, D_MODEL)).astype(np.float32)
    return x, ct


def _loss_jax(apply, params, x, ct):
    out, aux = apply(params, x)
    return jnp.sum(out.astype(jnp.float32) * ct) + 0.5 * aux


def _check_against_jax(jspec, spec, params, x_np, ct_np, dtype, apply_jax,
                       apply_port):
    """Outputs, aux and the gradients of x and every parameter."""
    jdt, tdt = DTYPES[dtype]
    jx = jnp.asarray(x_np, jdt)
    jparams = jax.tree.map(jnp.asarray, params)
    (want_out, want_aux) = jit(apply_jax)(jparams, jx)
    want_g = jit(jax.grad(functools.partial(_loss_jax, apply_jax),
                          argnums=(0, 1)))(jparams, jx, jnp.asarray(ct_np))

    tparams = _torch_tree(params, requires_grad=True)
    x = torch.from_numpy(x_np).to(tdt).requires_grad_()
    out, aux = apply_port(tparams, x)
    assert out.dtype == tdt and aux.dtype == torch.float32
    _close(out, want_out, dtype, "out")
    _close(aux, want_aux, dtype, "aux")
    loss = (out.float() * torch.from_numpy(ct_np)).sum() + 0.5 * aux
    loss.backward()
    _close(x.grad, want_g[1], dtype, "dx")
    want_named = _flat(jax.tree.map(np.asarray, want_g[0]))
    got_named = _flat(tparams)
    assert set(got_named) == set(want_named)
    for name, p in got_named.items():
        assert p.grad is not None, name
        _close(p.grad, want_named[name], dtype, f"d{name}")


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("T,E,K", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_jax(dtype, T, E, K, shared, capacity_factor):
    jspec, spec = _specs(E, K, shared, capacity_factor)
    params = _params(jspec, seed=T + E + K)
    x_np, ct_np = _inputs(T, dtype, seed=E * K)
    jdt, tdt = DTYPES[dtype]
    want_idx, want_keep, C = _ref_routing(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x_np, jdt), jspec)
    r = moe.route(torch.from_numpy(params["router"].copy()),
                  torch.from_numpy(x_np).to(tdt).reshape(T, D_MODEL), spec)
    assert r.capacity == C
    np.testing.assert_array_equal(r.gate_idx.numpy(), want_idx)
    np.testing.assert_array_equal(r.kept_by_token().numpy(), want_keep)
    if capacity_factor < 1:
        assert not want_keep.all()          # tokens drop
    _check_against_jax(
        jspec, spec, params, x_np, ct_np, dtype,
        lambda p, x: jmoe.moe_apply(p, x, jspec),
        lambda p, x: moe.moe_apply(p, x, spec))


@pytest.mark.parametrize("T,E,K", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_router_ties_take_the_lowest_experts(dtype, T, E, K):
    """Every probability ties at 1/E: top-k takes experts 0..K-1, as
    ``lax.top_k`` does, each combine weight is 1/K, experts 0..K-1 take
    the first C tokens each and the rest drop."""
    jspec, spec = _specs(E, K, shared=True)
    params = _params(jspec, seed=7, zero_router=True)
    x_np, ct_np = _inputs(T, dtype, seed=11)
    jdt, tdt = DTYPES[dtype]
    want_idx, want_keep, C = _ref_routing(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x_np, jdt), jspec)
    np.testing.assert_array_equal(want_idx, np.tile(np.arange(K), (T, 1)))
    r = moe.route(torch.from_numpy(params["router"].copy()),
                  torch.from_numpy(x_np).to(tdt).reshape(T, D_MODEL), spec)
    np.testing.assert_array_equal(r.gate_idx.numpy(), want_idx)
    np.testing.assert_array_equal(r.kept_by_token().numpy(), want_keep)
    assert bool((r.gate_vals == 1.0 / K).all())
    np.testing.assert_array_equal(want_keep[:, 0], np.arange(T) < C)
    _check_against_jax(
        jspec, spec, params, x_np, ct_np, dtype,
        lambda p, x: jmoe.moe_apply(p, x, jspec),
        lambda p, x: moe.moe_apply(p, x, spec))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dp_shards", [1, 2, 4])
def test_moe_apply_local_matches_jax(dp_shards, shared):
    """Per-shard dispatch, the capacity counted per shard (f32, 0.5 of
    capacity so that shards drop on their own)."""
    jspec, spec = _specs(8, 2, shared, capacity_factor=0.5)
    params = _params(jspec, seed=dp_shards)
    x_np, ct_np = _inputs(96, "float32", seed=3)
    _check_against_jax(
        jspec, spec, params, x_np, ct_np, "float32",
        lambda p, x: jmoe.moe_apply_local(p, x, jspec, dp_shards),
        lambda p, x: moe.moe_apply_local(p, x, spec, dp_shards))


def test_moe_apply_local_at_one_shard_is_moe_apply():
    jspec, spec = _specs(4, 2, True)
    params = _torch_tree(_params(jspec, seed=5))
    x = torch.from_numpy(_inputs(64, "float32", seed=5)[0])
    a, aux_a = moe.moe_apply(params, x, spec)
    b, aux_b = moe.moe_apply_local(params, x, spec, 1)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert float(aux_a) == float(aux_b)
    with pytest.raises(ValueError, match="shards"):
        moe.moe_apply_local(params, x, spec, 5)


def test_init_moe_shapes_and_scales_match_jax():
    jspec, spec = _specs(8, 2, True)
    want = _flat(_params(jspec, seed=0))
    got = _flat(moe.init_moe(torch.Generator().manual_seed(0), spec))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        assert abs(float(g.std()) / float(w.std()) - 1) < 0.15, name
