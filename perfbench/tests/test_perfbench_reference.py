"""The plain reference against the program's plain (einsum) route at a
tiny size, float32, on the same weights: logits, loss and gradients."""

import dataclasses

import torch

from perfbench import core
from perfbench.reference import model as ref
from perfbench.tests import tiny


def _program_cfg(config, seq):
    cfg = core.port_config(config, seq_len=seq)
    return dataclasses.replace(cfg, dtype=torch.float32, attention="einsum")


def test_logits_equal_the_programs_einsum_route():
    from tpu_autoscaler_torch.workloads import model as pm

    config = tiny.cell("sc2-3b.chat").config
    seq = 100                                  # past the window of 48
    weights = core.make_weights(config, 3, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, config["vocab_size"], (1, seq), generator=gen)
    want = pm.forward(weights, tokens, _program_cfg(config, seq))[0]
    got = ref.logits_at(weights, tokens[0], config, torch.arange(seq))
    assert want.abs().max() > 0.5
    assert (got - want).abs().max() < 2e-4


def test_loss_and_gradients_equal_the_programs():
    from tpu_autoscaler_torch.workloads import model as pm

    config = tiny.cell("sc2-7b.train.s4096").config
    seq, batch = 64, 3
    weights = core.make_weights(config, 4, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, config["vocab_size"], (batch, seq + 1),
                           generator=gen)
    paths, leaves = zip(*ref.leaves(weights).items())
    leaves = [p.detach().clone().requires_grad_() for p in leaves]
    loss = pm.loss_fn(core.nest(dict(zip(paths, leaves))), tokens,
                      _program_cfg(config, seq))
    grads = torch.autograd.grad(loss, leaves)
    want_loss, want_grads = ref.loss_and_grads(weights, tokens, config)
    assert abs(float(loss.detach()) - want_loss) < 1e-5
    for path, g in zip(paths, grads):
        scale = float(want_grads[path].abs().max())
        assert float((g - want_grads[path]).abs().max()) <= 1e-4 * scale, path


def test_adamw_follows_the_programs_optimizer():
    from tpu_autoscaler_torch.workloads import model as pm

    mix = tiny.cell("sc2-7b.train.s4096").mix["optimizer"]
    gen = torch.Generator().manual_seed(2)
    params = {"a": torch.randn(5, 7, generator=gen),
              "b": {"c": torch.randn(11, generator=gen)}}
    mine = {"a": params["a"].clone(), "b": {"c": params["b"]["c"].clone()}}
    train = pm.TrainConfig(learning_rate=mix["learning_rate"], b1=mix["b1"],
                           b2=mix["b2"], weight_decay=mix["weight_decay"])
    opt = pm.make_optimizer(train)
    state = opt.init(params)
    adam = ref.AdamW(mine, learning_rate=mix["learning_rate"], b1=mix["b1"],
                     b2=mix["b2"], eps=mix["eps"],
                     weight_decay=mix["weight_decay"])
    for _ in range(3):
        grads = {"a": torch.randn(5, 7, generator=gen),
                 "b": {"c": torch.randn(11, generator=gen)}}
        updates, state = opt.update(grads, state, params)
        params = pm.apply_updates(params, updates)
        adam.step(mine, ref.leaves(grads))
    for path, p in ref.leaves(params).items():
        assert torch.allclose(p, ref.leaves(mine)[path], atol=1e-7), path


def test_the_control_rounds_to_fp8():
    from perfbench.reference.control import fp8_linear

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(8, 64, generator=gen)
    w = torch.randn(64, 32, generator=gen)
    exact = x @ w
    low = fp8_linear(x, w)
    err = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < err < 0.2
