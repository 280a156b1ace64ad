"""The plain reference against the program (``repro_torch``) at smoke sizes
on the CPU, in f32: the training loss and every gradient, AdamW's step and
the decode through the ring cache.  The test imports the program; the
reference does not."""
import dataclasses

import pytest
import torch

from perfbench import program, traffic, weights
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import model as ref_model

SMALL = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 96,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 16}
DENSE = {"model_type": "qwen3", "rope_theta": 1e6, "rms_norm_eps": 1e-6,
         "hidden_act": "silu", "qk_norm": True, "tie_word_embeddings": True,
         "max_position_embeddings": 4096, "sliding_window": None, **SMALL}
MOE = {**DENSE, "model_type": "mixtral", "qk_norm": False,
       "tie_word_embeddings": False, "num_local_experts": 4,
       "num_experts_per_tok": 2, "router_aux_loss_coef": 0.01,
       "capacity_factor": 1.25}
WINDOWED = {**DENSE, "sliding_window": 5}
MIX = {"compute_dtype": "float32", "remat": "none", "microbatches": 2}
CPU = torch.device("cpu")


def port_model(config, mix, seed):
    from repro_torch.models.transformer import TransformerLM
    cfg = program.transformer_config(config, mix)
    flat = weights.make(config, seed, torch.float32, CPU)
    return TransformerLM(cfg, weights.nest(flat), device="cpu")


@pytest.mark.parametrize("config", [DENSE, MOE, WINDOWED],
                         ids=["dense", "moe", "window"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_loss_and_gradients(config, impl):
    from repro_torch.launch import steps  # noqa: F401
    mix = {**MIX, "attention_impl": impl}
    seed = 2**31 + 11
    model = port_model(config, mix, seed)
    gen = weights.generator(CPU, seed, "t")
    seq = traffic.token_ids({"dist": "zipf", "s": 1.1}, (4, 17),
                            config["vocab_size"], gen, CPU)
    tokens, labels = seq[:, :-1], seq[:, 1:]
    total = 0.0
    for part in (slice(0, 2), slice(2, 4)):
        loss, _ = model.loss_fn(tokens[part], labels[part])
        (loss / 2).backward()
        total += float(loss.detach()) / 2
    p = {n: t.float().requires_grad_(True) for n, t in
         weights.make(config, seed, torch.float32, CPU).items()}
    want = ref_model.loss_and_grads(p, tokens, labels,
                                    ref_model.Dims.of(config), 2)
    assert total == pytest.approx(want, rel=1e-5)
    for n, t in model.named_parameters():
        scale = float(p[n].grad.abs().max()) + 1e-12
        err = float((t.grad - p[n].grad).abs().max()) / scale
        assert err < 2e-4, (n, err)


def test_adamw_step_equals_the_programs():
    from repro_torch.optim import adamw
    opt = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 3,
           "total_steps": 20, "min_lr_frac": 0.1}
    gen = torch.Generator().manual_seed(4)
    p0 = {f"w{i}": torch.randn(7, 5, generator=gen) for i in range(3)}
    ours = {n: t.clone() for n, t in p0.items()}
    theirs = {n: t.clone() for n, t in p0.items()}
    cfg = adamw.AdamWConfig(**opt)
    st = adamw.init_state(theirs, cfg)
    rst = ref_adamw.init(ours)
    for _ in range(5):
        grads = {n: torch.randn(7, 5, generator=gen) * 3 for n in p0}
        adamw.apply_updates(cfg, theirs, grads, st)
        for n in ours:
            ours[n].grad = grads[n].clone()
        ref_adamw.step(opt, ours, rst)
    for n in p0:
        torch.testing.assert_close(ours[n], theirs[n], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("config", [DENSE, WINDOWED], ids=["dense",
                                                            "window"])
def test_decode_through_the_ring(config):
    from repro_torch.launch import steps
    mix = {"batch": 3, "cache_len": 8, "tokens": {"dist": "zipf", "s": 1.1},
           "compute_dtype": "float32"}
    seed = 77
    model = port_model(config, mix, seed)
    first, cache = traffic.decode_start(mix, config, seed, torch.float32,
                                        CPU)
    served = [first]
    logits_port = []
    for _ in range(11):          # wraps the 8-slot ring
        logits, cache = steps.lm_decode_step(model, cache, served[-1])
        logits_port.append(logits)
        served.append(logits.argmax(-1))
    tokens = torch.stack(served)
    p = weights.make(config, seed, torch.float32, CPU)
    _, start = traffic.decode_start(mix, config, seed, torch.float32, CPU)
    dec = ref_model.RingDecoder(p, start["k"], start["v"], 8,
                                ref_model.Dims.of(config), 8)
    for t in range(8):
        want = dec.step(tokens[t])
        torch.testing.assert_close(logits_port[t], want, rtol=1e-4,
                                   atol=1e-4)
    gaps, _, _ = ref_model.decode_reference(p, start["k"], start["v"], 8,
                                            tokens[:9],
                                            ref_model.Dims.of(config))
    assert float(gaps.max()) < 1e-4


def test_fp8_rounds_below_bf16():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    e8 = float((ref_model.fp8(x) - x).abs().max() / x.abs().max())
    e16 = float((x.bfloat16().float() - x).abs().max() / x.abs().max())
    assert e8 > 4 * e16


def test_dims_match_program_config():
    for config in (DENSE, MOE):
        d = ref_model.Dims.of(config)
        c = program.transformer_config(config, MIX)
        assert (d.vocab, d.n_layers, d.d, d.heads, d.kv_heads, d.head_dim,
                d.d_ff, d.qk_norm, d.tied, d.experts, d.top_k) == (
            c.vocab, c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
            c.head_dim, c.d_ff, c.qk_norm, c.tie_embeddings, c.moe_experts,
            c.moe_top_k)
        assert dataclasses.replace(c).moe_spec.capacity_factor == \
            pytest.approx(d.capacity_factor) or not d.experts
