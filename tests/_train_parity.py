"""Shared check of the port's ``LM.loss`` and its gradients against the
reference's ``jax.value_and_grad(LM.loss)``, on the CPU (imported by
``tests/test_torch_train_loss*.py``; not a test module).

Each family's SMOKE model gets the reference's weights through
``convert.lm_params_from_reference`` (``tests/_lm_parity.py``); tokens,
labels and the frontends' embeddings come from a numpy seed. SMOKE configs
run in f32, so the loss is held within ``LOSS_RTOL`` and every parameter's
gradient within ``GRAD_RTOL`` x that leaf's max|grad| (XLA and PyTorch sum
in other orders; the port runs each block under
``torch.utils.checkpoint``, as the reference runs ``jax.checkpoint``).
"""
from __future__ import annotations

import numpy as np
import torch

import jax

import _lm_parity as P
from repro_torch import convert

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def train_batch(cfg, b: int = 2, s: int = 24, seed: int = 1) -> dict:
    """A numpy batch: the model inputs and labels over the real vocab."""
    out = P.batch(cfg, b, s, seed)
    rng = np.random.default_rng(seed + 1)
    out["labels"] = rng.integers(0, cfg.vocab_size,
                                 size=out["tokens"].shape).astype(np.int32)
    return out


def port_loss_and_grads(lm, batch: dict):
    lm.requires_grad_(True)
    try:
        for p in lm.parameters():
            p.grad = None
        loss, metrics = lm.loss({k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in lm.named_parameters()}
    finally:
        lm.requires_grad_(False)
        for p in lm.parameters():
            p.grad = None
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def check_loss_and_grads(arch: str) -> dict:
    """Loss, ce, aux and every leaf's gradient of ``arch``'s SMOKE model
    against the reference's. Returns the reference's metrics."""
    jlm, params, lm = P.models(arch)
    cfg = lm.cfg
    batch = train_batch(cfg)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.loss(p, P.as_jax(batch)), has_aux=True)(params)
    loss, m, grads = port_loss_and_grads(lm, batch)
    for got, want in ((loss, jloss), (m["ce"], jm["ce"]),
                      (m["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL,
                                   atol=1e-7)
    want = convert.lm_params_from_reference(P.numpy_tree(jgrads), cfg)
    assert set(want) == set(grads)
    for name, g in grads.items():
        w = want[name].double()
        bar = GRAD_RTOL * max(float(w.abs().max()), 1e-30)
        err = float((g.double() - w).abs().max())
        assert err <= bar, f"{arch} {name}: grad error {err} > {bar}"
    return {k: float(v) for k, v in jm.items()}
