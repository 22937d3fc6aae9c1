"""``LM.loss`` and every parameter's gradient against the reference's
``jax.value_and_grad(LM.loss)`` for the dense, MoE and vision-stub SMOKE
models, on the CPU (``tests/_train_parity.py`` states the bars); the
recurrent and encoder-decoder families are in
``tests/test_torch_train_loss_rec.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import _lm_parity as P  # noqa: E402
import _train_parity as T  # noqa: E402
from repro_torch.models import LM  # noqa: E402


def test_dense_loss_and_grads():
    T.check_loss_and_grads("internlm2-1.8b")


def test_padded_vocab_loss_and_grads():
    """minicpm's 509-token vocab padded to 512: the padded logits are set
    to -1e30 before the log-softmax."""
    jlm, _, lm = P.models("minicpm-2b")
    assert lm.cfg.padded_vocab != lm.cfg.vocab_size
    T.check_loss_and_grads("minicpm-2b")


def test_moe_loss_and_grads_with_aux():
    metrics = T.check_loss_and_grads("olmoe-1b-7b")
    assert metrics["aux"] > 0          # the load-balancing term counts


def test_vision_stub_loss_and_grads():
    T.check_loss_and_grads("qwen2-vl-7b")


def test_remat_gives_the_same_gradients():
    """The per-block checkpoint recomputes the forward: the loss and every
    gradient are bit for bit those of the run without remat."""
    _, _, lm = P.models("internlm2-1.8b")
    plain = LM(dataclasses.replace(lm.cfg, remat=False), device="cpu")
    plain.load_state_dict(lm.state_dict())
    batch = T.train_batch(lm.cfg, seed=5)
    a = T.port_loss_and_grads(lm, batch)
    b = T.port_loss_and_grads(plain, batch)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[2][n], b[2][n]) for n in a[2])


def test_serving_model_is_frozen():
    lm = LM(P.configs("internlm2-1.8b")[0], device="cpu")
    assert not any(p.requires_grad for p in lm.parameters())


def test_abft_loss_and_grads_match_reference():
    """ABFT on every projection (the reference's ``custom_vjp``): the loss
    and gradients still match the reference's with ABFT on, and the
    backward runs on another thread, as autograd runs the card's
    backward, whose checkpoint recompute must see the forward's switch."""
    import threading

    import jax
    from repro.ft import abft_dense as j_abft
    from repro_torch import convert
    from repro_torch.ft import abft_dense as t_abft
    jlm, params, lm = P.models("internlm2-1.8b")
    batch = T.train_batch(lm.cfg, seed=7)
    j_abft.configure(True)
    t_abft.configure(True)
    try:
        (jloss, _), jgrads = jax.value_and_grad(
            lambda p: jlm.loss(p, P.as_jax(batch)), has_aux=True)(params)
        lm.requires_grad_(True)
        loss, _ = lm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        errors = []

        def backward():
            try:
                loss.backward()
            except Exception as e:     # noqa: BLE001 - surfaced below
                errors.append(e)
        worker = threading.Thread(target=backward)
        worker.start()
        worker.join()
        assert not errors, errors
        grads = {n: p.grad for n, p in lm.named_parameters()}
    finally:
        j_abft.configure(False)
        t_abft.configure(False)
        lm.requires_grad_(False)
        for p in lm.parameters():
            p.grad = None
    assert float(loss.detach()) == pytest.approx(float(jloss),
                                                 rel=T.LOSS_RTOL)
    want = convert.lm_params_from_reference(P.numpy_tree(jgrads), lm.cfg)
    for name, g in grads.items():
        w = want[name].double()
        bar = T.GRAD_RTOL * max(float(w.abs().max()), 1e-30)
        assert float((g.double() - w).abs().max()) <= bar, name
